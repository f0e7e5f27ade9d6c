// K5: closest hit of N rays over the port's binary BVH (see bvh_common.cuh).
//
// Replaces wurblpt_tpu/accel/traverse.py bvh_closest_hit / _wide_closest_hit
// with its leaf branches: triangle and sphere rows, world or object-space
// rays. A persistent launch of warps that walk only live lanes; the nearest
// hit so far bounds the slab tests and the stack pops, so far subtrees are
// pruned. Ties keep the first primitive found in the walk's order, exactly
// as the plain version does; a lane with tmax <= tmin is a miss and reads no
// node. One instantiation per leaf kind (variant bit 0: sphere rows, bit 1:
// object-space rays), chosen by the wrapper from the tree and the frame.
#include "bvh_common.cuh"

namespace {

using namespace wpt_bvh;

template <bool SPHERES, bool ANIMATED>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
bvh_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
                   const float4* __restrict__ nodes, const float4* __restrict__ rows, int n_tris,
                   const float* __restrict__ frames, int* counter, int2* spill,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
    walk_lanes<false, SPHERES, ANIMATED>(o, d, tmin, tmax, n, nodes, rows, n_tris, frames,
                                         counter, spill, t_out, prim_out, u_out, v_out, nullptr);
}

using Kernel = decltype(&bvh_closest_kernel<false, false>);

Kernel kernel_of(int variant) {
    switch (variant) {
        case 1: return bvh_closest_kernel<true, false>;
        case 2: return bvh_closest_kernel<false, true>;
        case 3: return bvh_closest_kernel<true, true>;
        default: return bvh_closest_kernel<false, false>;
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
extern "C" int wpt_bvh_closest_threads(int variant) { return resident_threads(variant & 3); }

extern "C" int wpt_bvh_closest_hit(int variant, const float* o, const float* d,
                                   const float* tmin, const float* tmax, int n,
                                   const float* nodes, const float* rows, int n_tris,
                                   const float* frames, int* counter, int* spill, float* t_out,
                                   int* prim_out, float* u_out, float* v_out, void* stream) {
    if (variant < 0 || variant > 3) return static_cast<int>(cudaErrorInvalidValue);
    if (n > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const int grid = min(resident_threads(variant) / BLOCK, (n + BLOCK - 1) / BLOCK);
        cudaMemsetAsync(counter, 0, sizeof(int), s);
        kernel_of(variant)<<<grid, BLOCK, 0, s>>>(
            o, d, tmin, tmax, n, reinterpret_cast<const float4*>(nodes),
            reinterpret_cast<const float4*>(rows), n_tris, frames, counter,
            reinterpret_cast<int2*>(spill), t_out, prim_out, u_out, v_out);
    }
    return static_cast<int>(cudaGetLastError());
}
