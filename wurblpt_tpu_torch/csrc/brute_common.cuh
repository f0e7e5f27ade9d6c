// Shared pieces of the brute-force cast kernels (closest_hit.cu, any_hit.cu);
// their tile queue is live_queue.cuh.
//
// Every expression below is evaluated in the same order as the plain PyTorch
// versions in wurblpt_tpu_torch/render/intersect_brute.py, and the library is
// built with -fmad=false and without --use_fast_math, so each operation
// rounds exactly as the corresponding PyTorch op does: kernel and plain
// version agree bit for bit on the same inputs. The sphere test's fused
// multiply-adds are explicit (__fmaf_rn; the plain version's `fma` rounds
// once too): they reproduce how XLA's CPU backend rounds the JAX package's
// feature product, whose last bits decide self-intersections.
//
// Primitive tables (built once per scene by build_brute_scene):
//   triangle row, 16 floats = 4 x float4, coefficients of the four linear
//   functionals of a ray (o, d) re-centred on the scene centre c:
//     [n.xyz, p0n] [a2.xyz, e2.x] [e2.yz, a1.xy] [a1.z, e1.xyz]
//     with p = p0 - c, n = e1 x e2, p0n = p . n, a2 = p x e2, a1 = p x e1;
//     det = -(d . n), t_num = o . n - p0n,
//     u_num = d . a2 + (o x d) . e2, v_num = -(d . a1 + (o x d) . e1).
//   sphere row, 4 floats: [centre - c, |centre - c|^2 - r^2].
#pragma once

#include <cuda_runtime.h>

namespace wpt {

constexpr float BIG = 3.0e37f;
constexpr int STAGE_MAX = 131072;   // bytes of table staged whole in shared memory
constexpr int CHUNK = 256;          // primitives per pass beyond it (16 KB of triangles)

struct Ray {
    float ox, oy, oz;        // origin minus the scene centre
    float dx, dy, dz;
    float xx, xy, xz;        // (o - c) x d
    float od, oo, dd;        // (o - c) . d, |o - c|^2, |d|^2
    float tmin, tmax;
};

__device__ __forceinline__ float sgn(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); }

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        const float* __restrict__ tmin,
                                        const float* __restrict__ tmax, int i, float cx, float cy,
                                        float cz) {
    Ray r;
    r.ox = o[3 * i + 0] - cx;
    r.oy = o[3 * i + 1] - cy;
    r.oz = o[3 * i + 2] - cz;
    r.dx = d[3 * i + 0];
    r.dy = d[3 * i + 1];
    r.dz = d[3 * i + 2];
    r.xx = r.oy * r.dz - r.oz * r.dy;
    r.xy = r.oz * r.dx - r.ox * r.dz;
    r.xz = r.ox * r.dy - r.oy * r.dx;
    r.od = __fmaf_rn(r.oz, r.dz, __fmaf_rn(r.oy, r.dy, r.ox * r.dx));
    r.oo = __fmaf_rn(r.oz, r.oz, __fmaf_rn(r.oy, r.oy, r.ox * r.ox));
    r.dd = __fmaf_rn(r.dz, r.dz, __fmaf_rn(r.dy, r.dy, r.dx * r.dx));
    r.tmin = tmin[i];
    r.tmax = tmax[i];
    return r;
}

// Moller-Trumbore numerators of one triangle; true when the hit lies inside
// the triangle and strictly inside (tmin, tmax), with the division-free
// predicates of intersect_mxu._decode_closest.
__device__ __forceinline__ bool tri_test(const Ray& r, const float4* __restrict__ row, float& det,
                                         float& tn, float& un, float& vn) {
    const float4 c0 = row[0], c1 = row[1], c2 = row[2], c3 = row[3];
    det = -(r.dx * c0.x + r.dy * c0.y + r.dz * c0.z);
    tn = -c0.w + r.ox * c0.x + r.oy * c0.y + r.oz * c0.z;
    un = r.dx * c1.x + r.dy * c1.y + r.dz * c1.z + r.xx * c1.w + r.xy * c2.x + r.xz * c2.y;
    vn = -(r.dx * c2.z + r.dy * c2.w + r.dz * c3.x + r.xx * c3.y + r.xy * c3.z + r.xz * c3.w);
    const float s = sgn(det), ad = fabsf(det);
    return ad > 1e-12f && un * s >= 0.f && vn * s >= 0.f && (un + vn) * s <= ad &&
           tn * s > r.tmin * ad && tn * s < r.tmax * ad;
}

// Stable sphere quadratic (hitable_sphere.hpp:128-151); true with the entry
// (or, from inside, exit) distance in `ts` when it lies in (tmin, tmax).
// half_b and cq accumulate as the feature product's dot does: products
// fused from the first column on, the constant term first for cq.
__device__ __forceinline__ bool sphere_test(const Ray& r, const float4 s, float& ts) {
    const float half_b = __fmaf_rn(r.dz, -s.z, __fmaf_rn(r.dy, -s.y, r.dx * -s.x)) + r.od;
    const float cq =
        __fmaf_rn(r.oz, -2.f * s.z, __fmaf_rn(r.oy, -2.f * s.y, __fmaf_rn(r.ox, -2.f * s.x, s.w))) +
        r.oo;
    const float disc = __fmaf_rn(half_b, half_b, -(r.dd * cq));
    const float sq = sqrtf(fmaxf(disc, 1e-20f));
    const float q = -(half_b + sgn(half_b) * sq);
    const float t0 = q / fmaxf(r.dd, 1e-20f);
    const float t1 = cq / (fabsf(q) > 1e-20f ? q : 1.f);
    const float tlo = fminf(t0, t1), thi = fmaxf(t0, t1);
    ts = tlo > r.tmin ? tlo : thi;
    return disc > 0.f && ts > r.tmin && ts < r.tmax;
}

// Dynamic shared memory of a cast over this table: all of it, or a chunk.
inline size_t table_bytes(int n_tris, int n_spheres) {
    return (4 * static_cast<size_t>(n_tris) + static_cast<size_t>(n_spheres)) * sizeof(float4);
}

inline bool staged_whole(int n_tris, int n_spheres) {
    return table_bytes(n_tris, n_spheres) <= static_cast<size_t>(STAGE_MAX);
}

inline size_t launch_smem(int n_tris, int n_spheres) {
    return staged_whole(n_tris, n_spheres) ? table_bytes(n_tris, n_spheres)
                                           : static_cast<size_t>(CHUNK) * 4 * sizeof(float4);
}

}  // namespace wpt
