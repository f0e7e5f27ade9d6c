// KS1: the brute-force sweep's closest hit of N rays against every triangle
// and sphere, static or animated.
//
// Replaces wurblpt_tpu/render/intersect.py _closest_tris (:216) and
// _closest_spheres (:271) with ray_tri_tile (:155) and ray_sphere_tile
// (:189): the JAX package's cast for every scene without a BVH that its
// matrix form does not take (an animated scene, or a static one past 8192
// columns). On the TPU a tile of up to 1024 triangles was one [N, tile]
// broadcast, its argmin folded into the running best; here each thread owns
// one ray and walks the primitives, which the block stages through shared
// memory CHUNK at a time. With animation frames each primitive tests the
// ray in its animation's object space (scene/animation.py), which the
// thread recomputes only when the animation id changes along the walk.
//
// Bound on the card: FP32 CUDA-core arithmetic, N x P pair tests of ~50
// flops (Moller-Trumbore with a division; the sphere quadratic with a
// square root and two divisions), the table read from shared memory as
// broadcasts. At the animated Cornell box (P = 36, N = 131072) that is
// ~0.25 GFLOP a cast: launch latency and the ray loads dominate.
//
// Ties go to the first minimum in primitive order (the strict `<`),
// triangles before spheres: JAX's argmin within a tile and strict `<`
// across tiles give the same. A lane with tmax <= tmin is a miss and does
// not walk the table.
#include "sweep_common.cuh"

namespace {

using namespace wpt_sweep;

__global__ void __launch_bounds__(BLOCK)
sweep_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
                     const float4* __restrict__ tri, const int* __restrict__ tri_anim, int n_tris,
                     const float4* __restrict__ sph, const int* __restrict__ sph_anim,
                     int n_spheres, const float* __restrict__ frames,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ u_out, float* __restrict__ v_out) {
    __shared__ float4 s_row[CHUNK * 3];
    __shared__ int s_aid[CHUNK];
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    Lane lane{};
    bool live = false;
    if (i < n) {
        lane = load_lane(o, d, tmin, tmax, frames, i);
        live = lane.tmax > lane.tmin;
    }
    float best_t = BIG, best_u = 0.f, best_v = 0.f;
    int best = -1;

    for (int base = 0; base < n_tris; base += CHUNK) {
        const int cnt = min(CHUNK, n_tris - base);
        __syncthreads();
        for (int j = threadIdx.x; j < cnt * 3; j += blockDim.x) s_row[j] = tri[base * 3 + j];
        for (int j = threadIdx.x; j < cnt; j += blockDim.x) s_aid[j] = tri_anim[base + j];
        __syncthreads();
        if (live) {
            for (int k = 0; k < cnt; ++k) {
                V3 ro, rd;
                lane.rays_of(s_aid[k], ro, rd);
                const float4 a = s_row[3 * k], b = s_row[3 * k + 1], c = s_row[3 * k + 2];
                float t, u, v;
                if (tri_test(ro, rd, {a.x, a.y, a.z}, {b.x, b.y, b.z}, {c.x, c.y, c.z},
                             lane.tmin, lane.tmax, t, u, v) &&
                    t < best_t) {
                    best_t = t;
                    best = base + k;
                    best_u = u;
                    best_v = v;
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
        if (live) {
            for (int k = 0; k < cnt; ++k) {
                V3 ro, rd;
                lane.rays_of(s_aid[k], ro, rd);
                float ts;
                if (sphere_test(ro, rd, s_row[k], lane.tmin, lane.tmax, ts) && ts < best_t) {
                    best_t = ts;
                    best = n_tris + base + k;
                    best_u = 0.f;
                    best_v = 0.f;
                }
            }
        }
    }
    if (i < n) {
        t_out[i] = best_t;
        prim_out[i] = best;
        u_out[i] = best_u;
        v_out[i] = best_v;
    }
}

}  // namespace

extern "C" int wpt_sweep_closest(const float* o, const float* d, const float* tmin,
                                 const float* tmax, int n, const float* tri, const int* tri_anim,
                                 int n_tris, const float* sph, const int* sph_anim, int n_spheres,
                                 const float* frames, float* t_out, int* prim_out,
                                 float* u_out, float* v_out, void* stream) {
    if (n > 0) {
        const int grid = (n + BLOCK - 1) / BLOCK;
        sweep_closest_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            o, d, tmin, tmax, n, reinterpret_cast<const float4*>(tri), tri_anim, n_tris,
            reinterpret_cast<const float4*>(sph), sph_anim, n_spheres, frames, t_out, prim_out,
            u_out, v_out);
    }
    return static_cast<int>(cudaGetLastError());
}
