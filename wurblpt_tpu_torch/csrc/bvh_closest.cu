// K5: closest hit of N rays over the port's binary BVH (see bvh_common.cuh).
//
// Replaces wurblpt_tpu/accel/traverse.py bvh_closest_hit / _wide_closest_hit.
// A persistent launch of warps that walk only live lanes; the nearest hit so
// far bounds the slab tests and the stack pops, so far subtrees are pruned.
// Ties keep the first triangle found in the walk's order, exactly as the
// plain version does; a lane with tmax <= tmin is a miss and reads no node.
#include "bvh_common.cuh"

namespace {

using namespace wpt_bvh;

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
bvh_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
                   const float4* __restrict__ nodes, const float4* __restrict__ tris, int* counter,
                   int2* spill, float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
    walk_lanes<false>(o, d, tmin, tmax, n, nodes, tris, counter, spill, t_out, prim_out, u_out,
                      v_out, nullptr);
}

int resident_threads() {
    static int threads = 0;
    if (threads == 0) {
        int dev = 0, sms = 0, blocks = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bvh_closest_kernel, BLOCK, 0);
        threads = sms * blocks * BLOCK;
    }
    return threads;
}

}  // namespace

// Threads of a full persistent launch: the wrapper sizes the spill rows with it.
extern "C" int wpt_bvh_closest_threads() { return resident_threads(); }

extern "C" int wpt_bvh_closest_hit(const float* o, const float* d, const float* tmin,
                                   const float* tmax, int n, const float* nodes, const float* tri_v,
                                   int* counter, int* spill, float* t_out, int* prim_out,
                                   float* u_out, float* v_out, void* stream) {
    if (n > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const int grid = min(resident_threads() / BLOCK, (n + BLOCK - 1) / BLOCK);
        cudaMemsetAsync(counter, 0, sizeof(int), s);
        bvh_closest_kernel<<<grid, BLOCK, 0, s>>>(
            o, d, tmin, tmax, n, reinterpret_cast<const float4*>(nodes),
            reinterpret_cast<const float4*>(tri_v), counter, reinterpret_cast<int2*>(spill), t_out,
            prim_out, u_out, v_out);
    }
    return static_cast<int>(cudaGetLastError());
}
