// K6: occlusion of N rays in (tmin, tmax) over the port's binary BVH (see
// bvh_common.cuh).
//
// Replaces wurblpt_tpu/accel/traverse.py bvh_any_hit / _wide_any_hit with
// its leaf branches, as K5. The same persistent walk as K5 with the ray's
// tmax as the bound throughout; a ray is done at the first valid primitive.
// A lane with tmax <= tmin (a dead path, or a lane without a shadow ray this
// bounce) is not occluded and reads no node. One instantiation per leaf
// kind, as K5.
#include "bvh_common.cuh"

namespace {

using namespace wpt_bvh;

template <bool SPHERES, bool ANIMATED>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
bvh_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
               const float4* __restrict__ nodes, const float4* __restrict__ rows, int n_tris,
               const float* __restrict__ frames, int* counter, int2* spill,
               bool* __restrict__ occ_out) {
    walk_lanes<true, SPHERES, ANIMATED>(o, d, tmin, tmax, n, nodes, rows, n_tris, frames,
                                        counter, spill, nullptr, nullptr, nullptr, nullptr,
                                        occ_out);
}

using Kernel = decltype(&bvh_any_kernel<false, false>);

Kernel kernel_of(int variant) {
    switch (variant) {
        case 1: return bvh_any_kernel<true, false>;
        case 2: return bvh_any_kernel<false, true>;
        case 3: return bvh_any_kernel<true, true>;
        default: return bvh_any_kernel<false, false>;
    }
}

int resident_threads(int variant) {
    static int threads[4] = {0, 0, 0, 0};
    if (threads[variant] == 0) {
        int dev = 0, sms = 0, blocks = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_of(variant), BLOCK, 0);
        threads[variant] = sms * blocks * BLOCK;
    }
    return threads[variant];
}

}  // namespace

// Threads of a full persistent launch of one variant: the wrapper sizes the
// spill rows with it.
extern "C" int wpt_bvh_any_threads(int variant) { return resident_threads(variant & 3); }

extern "C" int wpt_bvh_any_hit(int variant, const float* o, const float* d, const float* tmin,
                               const float* tmax, int n, const float* nodes, const float* rows,
                               int n_tris, const float* frames, int* counter, int* spill,
                               bool* occ_out, void* stream) {
    if (variant < 0 || variant > 3) return static_cast<int>(cudaErrorInvalidValue);
    if (n > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const int grid = min(resident_threads(variant) / BLOCK, (n + BLOCK - 1) / BLOCK);
        cudaMemsetAsync(counter, 0, sizeof(int), s);
        kernel_of(variant)<<<grid, BLOCK, 0, s>>>(
            o, d, tmin, tmax, n, reinterpret_cast<const float4*>(nodes),
            reinterpret_cast<const float4*>(rows), n_tris, frames, counter,
            reinterpret_cast<int2*>(spill), occ_out);
    }
    return static_cast<int>(cudaGetLastError());
}
