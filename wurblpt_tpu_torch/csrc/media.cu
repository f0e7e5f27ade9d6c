// KM: homogeneous participating media folded into a segment's closest hit.
//
// Replaces the JAX package's apply_media (wurblpt_tpu/render/media.py:32-155),
// a hand-shaped XLA hot path: it brute-forces every medium's boundary twice
// per traced segment as [N, P] broadcasts, 2-3 times a bounce on every lane
// (the closest cast and, in a scene with media, each NEE shadow ray's closest
// cast). As PyTorch ops that is some 60 launches a medium per cast.
//
// One thread a lane. For each medium in id order: the first boundary probe
// from t_min (the entry, or the exit where the segment starts inside), the
// second from entry + 1e-4 (the exit), the free path
// dist = -log1p(-clip(u, 0, 0.999999)) / max(rho, 1e-20) with u drawn by
// PCG4D on (pixel, sample, bounce, Salt.MEDIUM + (salt_ctx << 8) + m), and a
// scatter where the first probe found the boundary and entry + dist ends
// before the exit and before the nearest hit so far (carried across media).
// A probe tests the medium's triangles, then its spheres, each keeping the
// first strict minimum in row order (jnp.argmin's tie rule); the host orders
// the boundary rows by medium, so medium m's rows are one contiguous range
// (tri_off, sph_off).
//
// Bound: bytes. A lane reads 68 bytes (o, d, t_min, the solid hit, its three
// counter words) and writes 21; the boundary tables are a few hundred bytes
// (a sphere, an octahedron), read through __ldg from L1. Its arithmetic,
// about 2 x (40 a triangle, 30 a sphere) operations a medium, is far below
// what the bytes take at the FP32 rate.
//
// Every expression follows the plain version (render/media.py
// apply_media_plain) term by term, and the library is built with -fmad=false
// and without --use_fast_math, so each operation rounds as its PyTorch op
// does. Where bits may part: log1pf against PyTorch's CUDA log1p.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.0e37f;
constexpr int BLOCK = 128;

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p) { return {__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }
__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
// core/vecmath.dot: the products summed left to right
__device__ __forceinline__ float dot3(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

struct Media {
    const float* tri_p0;   // [MT, 3]
    const float* tri_e1;
    const float* tri_e2;
    const int* tri_off;    // [M + 1]
    const float* sph_c;    // [MS, 3]
    const float* sph_r;    // [MS]
    const int* sph_off;    // [M + 1]
    const float* density;  // [M]
    const int* phase_mat;  // [M]
    int n_media;
};

// The closest boundary hit of medium m after tmin (media.py:32-101): its t
// (BIG where none) and whether the ray meets the boundary from inside.
__device__ __forceinline__ void boundary_hit(const Media& md, int m, V3 o, V3 d, float tmin,
                                             float& best_t, bool& best_back) {
    best_t = BIG;
    best_back = false;
    const int tlo = __ldg(md.tri_off + m), thi = __ldg(md.tri_off + m + 1);
    float tj = BIG;
    int j = -1;
    for (int k = tlo; k < thi; ++k) {
        const V3 p0 = load3(md.tri_p0 + 3 * k);
        const V3 e1 = load3(md.tri_e1 + 3 * k);
        const V3 e2 = load3(md.tri_e2 + 3 * k);
        const V3 pvec = cross3(d, e2);
        const float det = dot3(e1, pvec);
        const bool big = fabsf(det) > 1e-12f;
        const float inv_det = big ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
        const V3 tvec = sub3(o, p0);
        const float u = dot3(tvec, pvec) * inv_det;
        const V3 qvec = cross3(tvec, e1);
        const float v = dot3(d, qvec) * inv_det;
        const float t = dot3(e2, qvec) * inv_det;
        const bool ok = big && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin;
        const float tt = ok ? t : BIG;
        if (tt < tj) {
            tj = tt;
            j = k;
        }
    }
    if (j >= 0 && tj < best_t) {
        const V3 fn = cross3(load3(md.tri_e1 + 3 * j), load3(md.tri_e2 + 3 * j));
        best_back = dot3(d, fn) > 0.0f;
        best_t = tj;
    }
    const int slo = __ldg(md.sph_off + m), shi = __ldg(md.sph_off + m + 1);
    float sj = BIG;
    j = -1;
    for (int k = slo; k < shi; ++k) {
        const V3 c = load3(md.sph_c + 3 * k);
        const float r = __ldg(md.sph_r + k);
        const V3 oc = sub3(o, c);
        const float a = dot3(d, d);
        const float half_b = dot3(oc, d);
        const float cc = dot3(oc, oc) - r * r;
        const float disc = half_b * half_b - a * cc;
        const float sq = sqrtf(fmaxf(disc, 1e-20f));
        const float sgn = half_b > 0.0f ? 1.0f : (half_b < 0.0f ? -1.0f : 0.0f);
        const float q = -(half_b + sgn * sq);
        const float t0 = q / fmaxf(a, 1e-20f);
        const float t1 = cc / (fabsf(q) > 1e-20f ? q : 1.0f);
        const float lo = fminf(t0, t1), hi = fmaxf(t0, t1);
        const float t = lo > tmin ? lo : hi;
        const bool ok = disc > 0.0f && t > tmin;
        const float tt = ok ? t : BIG;
        if (tt < sj) {
            sj = tt;
            j = k;
        }
    }
    if (j >= 0 && sj < best_t) {
        const V3 c = load3(md.sph_c + 3 * j);
        const V3 p = {o.x + sj * d.x, o.y + sj * d.y, o.z + sj * d.z};
        best_back = dot3(d, sub3(p, c)) > 0.0f;
        best_t = sj;
    }
}

// core/rng.py uniform1: PCG4D's first word, its top 24 bits
__device__ __forceinline__ float uniform1(long long pixel, long long sample, long long depth,
                                          uint32_t salt) {
    uint32_t v[4] = {static_cast<uint32_t>(pixel), static_cast<uint32_t>(sample),
                     static_cast<uint32_t>(depth), salt};
    for (int c = 0; c < 4; ++c) v[c] = v[c] * 1664525u + 1013904223u;
    v[0] += v[1] * v[3];
    v[1] += v[2] * v[0];
    v[2] += v[0] * v[1];
    v[3] += v[1] * v[2];
    for (int c = 0; c < 4; ++c) v[c] ^= v[c] >> 16;
    v[0] += v[1] * v[3];
    v[1] += v[2] * v[0];
    v[2] += v[0] * v[1];
    v[3] += v[1] * v[2];
    return static_cast<float>(v[0] >> 8) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(BLOCK)
    media_kernel(Media md, const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ t_min, const float* __restrict__ t_solid,
                 const int* __restrict__ prim_solid, const float* __restrict__ u_solid,
                 const float* __restrict__ v_solid, const long long* __restrict__ pixel,
                 const long long* __restrict__ sample, const long long* __restrict__ bounce,
                 uint32_t salt_base, int n_solid, int n, float* __restrict__ t_out,
                 int* __restrict__ prim_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, bool* __restrict__ mask_out,
                 int* __restrict__ mat_out) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= n) return;
    const V3 ro = load3(o + 3 * i), rd = load3(d + 3 * i);
    const float tmin = t_min[i];
    float t_best = t_solid[i];
    int p_best = prim_solid[i];
    bool mask = false;
    int mat = 0;
    const long long px = pixel[i], smp = sample[i], k = bounce[i];
    for (int m = 0; m < md.n_media; ++m) {
        float t1, t2;
        bool back1, back2;
        boundary_hit(md, m, ro, rd, tmin, t1, back1);
        const float entry = back1 ? tmin : t1;
        boundary_hit(md, m, ro, rd, entry + 1e-4f, t2, back2);
        const float exit_t = back1 ? t1 : t2;
        const float u = uniform1(px, smp, k, salt_base + static_cast<uint32_t>(m));
        const float dist =
            -log1pf(-fminf(fmaxf(u, 0.0f), 0.999999f)) / fmaxf(__ldg(md.density + m), 1e-20f);
        const float t_sc = entry + dist;
        if (t1 < BIG && t_sc < exit_t && t_sc < t_best) {
            t_best = t_sc;
            p_best = n_solid + m;
            mask = true;
            mat = __ldg(md.phase_mat + m);
        }
    }
    t_out[i] = t_best;
    prim_out[i] = p_best;
    u_out[i] = mask ? 0.0f : u_solid[i];
    v_out[i] = mask ? 0.0f : v_solid[i];
    mask_out[i] = mask;
    mat_out[i] = mat;
}

}  // namespace

// KM on n lanes: the boundary tables of n_media media (rows ordered by
// medium, tri_off / sph_off their ranges), the lanes' rays, solid hits and
// counter words; salt_base = Salt.MEDIUM + (salt_ctx << 8). Returns
// cudaGetLastError() after the launch.
extern "C" int wpt_apply_media(const float* o, const float* d, const float* t_min,
                               const float* t_solid, const int* prim_solid,
                               const float* u_solid, const float* v_solid,
                               const long long* pixel, const long long* sample,
                               const long long* bounce, int salt_base, int n,
                               const float* tri_p0, const float* tri_e1, const float* tri_e2,
                               const int* tri_off, const float* sph_c, const float* sph_r,
                               const int* sph_off, const float* density, const int* phase_mat,
                               int n_media, int n_solid, float* t_out, int* prim_out,
                               float* u_out, float* v_out, bool* mask_out, int* mat_out,
                               void* stream) {
    if (n <= 0) return 0;
    const Media md{tri_p0, tri_e1, tri_e2, tri_off, sph_c, sph_r, sph_off, density, phase_mat,
                   n_media};
    media_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        md, o, d, t_min, t_solid, prim_solid, u_solid, v_solid, pixel, sample, bounce,
        static_cast<uint32_t>(salt_base), n_solid, n, t_out, prim_out, u_out, v_out, mask_out,
        mat_out);
    return static_cast<int>(cudaGetLastError());
}
