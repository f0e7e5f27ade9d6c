// K6: occlusion of N rays in (tmin, tmax) over the port's binary BVH (see
// bvh_common.cuh).
//
// Replaces wurblpt_tpu/accel/traverse.py bvh_any_hit / _wide_any_hit. The
// same walk as K5 with the ray's tmax as the bound throughout; a thread
// retires at the first valid triangle. A lane with tmax <= tmin (a dead
// path, or a lane without a shadow ray this bounce) is not occluded and
// reads no node.
#include "bvh_common.cuh"

namespace {

using namespace wpt_bvh;

__global__ void __launch_bounds__(BLOCK)
bvh_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
               const float4* __restrict__ nodes, const float* __restrict__ tri_v,
               bool* __restrict__ occ_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float t0 = tmin[i], t1 = tmax[i];
    bool occ = false;
    if (t1 > t0) {
        const Ray r = load_ray(o, d, i);
        float best_t = BIG, best_u = 0.f, best_v = 0.f;
        int best_prim = -1;
        occ = traverse<true>(r, nodes, tri_v, nullptr, t0, t1, best_t, best_prim, best_u, best_v);
    }
    occ_out[i] = occ;
}

}  // namespace

extern "C" int wpt_bvh_any_hit(const float* o, const float* d, const float* tmin,
                               const float* tmax, int n, const float* nodes, const float* tri_v,
                               bool* occ_out, void* stream) {
    if (n > 0) {
        const int grid = (n + BLOCK - 1) / BLOCK;
        bvh_any_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            o, d, tmin, tmax, n, reinterpret_cast<const float4*>(nodes), tri_v, occ_out);
    }
    return static_cast<int>(cudaGetLastError());
}
