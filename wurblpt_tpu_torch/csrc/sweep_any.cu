// KS2: the brute-force sweep's any hit (occlusion) of N shadow rays in
// (tmin, tmax), static or animated.
//
// Replaces wurblpt_tpu/render/intersect.py _any_tris (:397) and
// _any_spheres (:434): the validity-only fold of the tiled sweep. Each
// thread owns one ray, walks the shared-memory-staged primitives with KS1's
// tests (sweep_common.cuh), in each primitive's object space where the scene
// is animated, and stops at its first valid primitive.
//
// Bound on the card: as KS1, FP32 pair tests from shared memory; the early
// exit saves work only for lanes whose blocker comes early in the table, and
// a warp runs until its slowest lane is done. NEE lanes that need no shadow
// ray arrive with tmax = 0 and skip the table.
#include "sweep_common.cuh"

namespace {

using namespace wpt_sweep;

__global__ void __launch_bounds__(BLOCK)
sweep_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
                 const float4* __restrict__ tri, const int* __restrict__ tri_anim, int n_tris,
                 const float4* __restrict__ sph, const int* __restrict__ sph_anim, int n_spheres,
                 const float* __restrict__ frames, bool* __restrict__ occluded) {
    __shared__ float4 s_row[CHUNK * 3];
    __shared__ int s_aid[CHUNK];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    Lane lane{};
    bool live = false;
    if (i < n) {
        lane = load_lane(o, d, tmin, tmax, frames, i);
        live = lane.tmax > lane.tmin;
    }
    bool hit = false;
    for (int base = 0; base < n_tris; base += CHUNK) {
        const int cnt = min(CHUNK, n_tris - base);
        __syncthreads();
        for (int j = threadIdx.x; j < cnt * 3; j += blockDim.x) s_row[j] = tri[base * 3 + j];
        for (int j = threadIdx.x; j < cnt; j += blockDim.x) s_aid[j] = tri_anim[base + j];
        __syncthreads();
        if (live && !hit) {
            for (int k = 0; k < cnt; ++k) {
                V3 ro, rd;
                lane.rays_of(s_aid[k], ro, rd);
                const float4 a = s_row[3 * k], b = s_row[3 * k + 1], c = s_row[3 * k + 2];
                float t, u, v;
                if (tri_test(ro, rd, {a.x, a.y, a.z}, {b.x, b.y, b.z}, {c.x, c.y, c.z},
                             lane.tmin, lane.tmax, t, u, v)) {
                    hit = true;
                    break;
                }
            }
        }
    }
    for (int base = 0; base < n_spheres; base += CHUNK) {
        const int cnt = min(CHUNK, n_spheres - base);
        __syncthreads();
        for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
            s_row[j] = sph[base + j];
            s_aid[j] = sph_anim[base + j];
        }
        __syncthreads();
        if (live && !hit) {
            for (int k = 0; k < cnt; ++k) {
                V3 ro, rd;
                lane.rays_of(s_aid[k], ro, rd);
                float ts;
                if (sphere_test(ro, rd, s_row[k], lane.tmin, lane.tmax, ts)) {
                    hit = true;
                    break;
                }
            }
        }
    }
    if (i < n) occluded[i] = hit;
}

}  // namespace

extern "C" int wpt_sweep_any(const float* o, const float* d, const float* tmin, const float* tmax,
                             int n, const float* tri, const int* tri_anim, int n_tris,
                             const float* sph, const int* sph_anim, int n_spheres,
                             const float* frames, bool* occluded, void* stream) {
    if (n > 0) {
        const int grid = (n + BLOCK - 1) / BLOCK;
        sweep_any_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            o, d, tmin, tmax, n, reinterpret_cast<const float4*>(tri), tri_anim, n_tris,
            reinterpret_cast<const float4*>(sph), sph_anim, n_spheres, frames, occluded);
    }
    return static_cast<int>(cudaGetLastError());
}
