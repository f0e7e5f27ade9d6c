// K6: occlusion of N rays in (tmin, tmax) over the port's binary BVH (see
// bvh_common.cuh).
//
// Replaces wurblpt_tpu/accel/traverse.py bvh_any_hit / _wide_any_hit. The
// same persistent walk as K5 with the ray's tmax as the bound throughout; a
// ray is done at the first valid triangle. A lane with tmax <= tmin (a dead
// path, or a lane without a shadow ray this bounce) is not occluded and
// reads no node.
#include "bvh_common.cuh"

namespace {

using namespace wpt_bvh;

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
bvh_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
               const float4* __restrict__ nodes, const float4* __restrict__ tris, int* counter,
               int2* spill, bool* __restrict__ occ_out) {
    walk_lanes<true>(o, d, tmin, tmax, n, nodes, tris, counter, spill, nullptr, nullptr, nullptr,
                     nullptr, occ_out);
}

int resident_threads() {
    static int threads = 0;
    if (threads == 0) {
        int dev = 0, sms = 0, blocks = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bvh_any_kernel, BLOCK, 0);
        threads = sms * blocks * BLOCK;
    }
    return threads;
}

}  // namespace

// Threads of a full persistent launch: the wrapper sizes the spill rows with it.
extern "C" int wpt_bvh_any_threads() { return resident_threads(); }

extern "C" int wpt_bvh_any_hit(const float* o, const float* d, const float* tmin,
                               const float* tmax, int n, const float* nodes, const float* tri_v,
                               int* counter, int* spill, bool* occ_out, void* stream) {
    if (n > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const int grid = min(resident_threads() / BLOCK, (n + BLOCK - 1) / BLOCK);
        cudaMemsetAsync(counter, 0, sizeof(int), s);
        bvh_any_kernel<<<grid, BLOCK, 0, s>>>(
            o, d, tmin, tmax, n, reinterpret_cast<const float4*>(nodes),
            reinterpret_cast<const float4*>(tri_v), counter, reinterpret_cast<int2*>(spill),
            occ_out);
    }
    return static_cast<int>(cudaGetLastError());
}
