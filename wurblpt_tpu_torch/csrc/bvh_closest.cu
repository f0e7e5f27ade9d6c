// K5: closest hit of N rays over the port's binary BVH (see bvh_common.cuh).
//
// Replaces wurblpt_tpu/accel/traverse.py bvh_closest_hit / _wide_closest_hit.
// One thread per ray; the nearest hit so far bounds the slab tests and the
// stack pops, so far subtrees are pruned. Ties keep the first triangle found
// in the walk's order, exactly as the plain version does; a lane with
// tmax <= tmin is a miss and reads no node.
#include "bvh_common.cuh"

namespace {

using namespace wpt_bvh;

__global__ void __launch_bounds__(BLOCK)
bvh_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
                   const float4* __restrict__ nodes, const float* __restrict__ tri_v,
                   const int* __restrict__ tri_id, float* __restrict__ t_out,
                   int* __restrict__ prim_out, float* __restrict__ u_out,
                   float* __restrict__ v_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float best_t = BIG, best_u = 0.f, best_v = 0.f;
    int best_prim = -1;
    const float t0 = tmin[i], t1 = tmax[i];
    if (t1 > t0) {
        const Ray r = load_ray(o, d, i);
        traverse<false>(r, nodes, tri_v, tri_id, t0, t1, best_t, best_prim, best_u, best_v);
    }
    t_out[i] = best_t;
    prim_out[i] = best_prim;
    u_out[i] = best_u;
    v_out[i] = best_v;
}

}  // namespace

extern "C" int wpt_bvh_closest_hit(const float* o, const float* d, const float* tmin,
                                   const float* tmax, int n, const float* nodes,
                                   const float* tri_v, const int* tri_id, float* t_out,
                                   int* prim_out, float* u_out, float* v_out, void* stream) {
    if (n > 0) {
        const int grid = (n + BLOCK - 1) / BLOCK;
        bvh_closest_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            o, d, tmin, tmax, n, reinterpret_cast<const float4*>(nodes), tri_v, tri_id, t_out,
            prim_out, u_out, v_out);
    }
    return static_cast<int>(cudaGetLastError());
}
