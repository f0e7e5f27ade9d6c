// Shared pieces of the brute-force sweeps KS1 (sweep_closest.cu) and KS2
// (sweep_any.cu): the ray, the object-space ray of an animation, and the two
// primitive tests of the JAX package's tiled sweeps.
//
// Every expression is evaluated in the order of the plain PyTorch versions
// in wurblpt_tpu_torch/render/intersect_sweep.py (ray_tri_tile,
// ray_sphere_tile) and scene/animation.py (matvec), and the library is built
// with -fmad=false and without --use_fast_math: each operation rounds as the
// PyTorch op does, so kernel and plain version agree bit for bit. The
// minimum, maximum, clamp and sign follow PyTorch's NaN semantics.
//
// Tables (render/intersect_sweep.py build_sweep_scene):
//   triangle row, 12 floats = 3 x float4: p0 xyz, 0 | e1 xyz, 0 | e2 xyz, 0
//   sphere row, 4 floats: centre xyz, radius
//   an int32 animation id per primitive, and per animation a frame row of
//   30 floats at the frame's one instant (scene/animation.py anim_frames):
//   r_inv (row major) | t_inv | m_fwd | m_nrm, row `aid` for every ray.
#pragma once

#include <cuda_runtime.h>

namespace wpt_sweep {

constexpr float BIG = 3.0e37f;
constexpr int BLOCK = 128;   // rays per block, one thread each
constexpr int CHUNK = 256;   // primitives staged in shared memory per pass (12 KB of triangles)
constexpr int FRAME = 30;

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }

__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.minimum / torch.maximum / torch.clamp_min / torch.sign
__device__ __forceinline__ float min_(float a, float b) {
    return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float max_(float a, float b) {
    return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_min_(float x, float lo) { return isnan_(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float sign_(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : x); }

// m (row major, 9 floats) times v, each row summed left to right (matvec).
__device__ __forceinline__ V3 matvec(const float* __restrict__ m, V3 v) {
    return {m[0] * v.x + m[1] * v.y + m[2] * v.z, m[3] * v.x + m[4] * v.y + m[5] * v.z,
            m[6] * v.x + m[7] * v.y + m[8] * v.z};
}

// A lane's ray in the object space of one animation: r_inv (o - t_inv), r_inv d.
__device__ __forceinline__ void object_ray(const float* __restrict__ f, V3 o, V3 d, V3& oa,
                                           V3& da) {
    oa = matvec(f, sub3(o, load3(f + 9)));
    da = matvec(f, d);
}

// Moller-Trumbore with a true division by the determinant (intersect.py:155):
// true when the hit lies in the triangle (u, v >= 0, u + v <= 1 inclusive) and
// strictly inside (tmin, tmax).
__device__ __forceinline__ bool tri_test(V3 o, V3 d, V3 p0, V3 e1, V3 e2, float tmin, float tmax,
                                         float& t, float& u, float& v) {
    const V3 pvec = cross3(d, e2);
    const float det = dot3(e1, pvec);
    const bool ok = fabsf(det) > 1e-12f;
    const float inv_det = ok ? 1.f / det : 0.f;
    const V3 tvec = sub3(o, p0);
    u = dot3(tvec, pvec) * inv_det;
    const V3 qvec = cross3(tvec, e1);
    v = dot3(d, qvec) * inv_det;
    t = dot3(e2, qvec) * inv_det;
    return ok && u >= 0.f && v >= 0.f && u + v <= 1.f && t > tmin && t < tmax;
}

// The stable sphere quadratic in world (or object) space (intersect.py:189,
// hitable_sphere.hpp:128-151); true with the entry (or, from inside, exit)
// distance in ts when it lies in (tmin, tmax).
__device__ __forceinline__ bool sphere_test(V3 o, V3 d, float4 s, float tmin, float tmax,
                                            float& ts) {
    const V3 oc = {o.x - s.x, o.y - s.y, o.z - s.z};
    const float a = dot3(d, d);
    const float half_b = dot3(oc, d);
    const float c = dot3(oc, oc) - s.w * s.w;
    const float disc = half_b * half_b - a * c;
    const float sq = sqrtf(clamp_min_(disc, 1e-20f));
    const float q = -(half_b + sign_(half_b) * sq);
    const float t0 = q / clamp_min_(a, 1e-20f);
    const float t1 = c / (fabsf(q) > 1e-20f ? q : 1.f);
    const float tlo = min_(t0, t1), thi = max_(t0, t1);
    ts = tlo > tmin ? tlo : thi;
    return disc > 0.f && ts > tmin && ts < tmax;
}

// One lane's ray and its cached object-space ray (the primitives of one
// mesh share an animation id, so the cache is refreshed rarely).
struct Lane {
    V3 o, d, oa, da;
    float tmin, tmax;
    int cur;   // animation id of oa, da (-1: none yet)
    const float* frames;   // the animations' rows, or nullptr for world rays

    __device__ __forceinline__ void rays_of(int aid, V3& ro, V3& rd) {
        if (frames == nullptr) {
            ro = o;
            rd = d;
            return;
        }
        if (aid != cur) {
            object_ray(frames + aid * FRAME, o, d, oa, da);
            cur = aid;
        }
        ro = oa;
        rd = da;
    }
};

__device__ __forceinline__ Lane load_lane(const float* __restrict__ o, const float* __restrict__ d,
                                          const float* __restrict__ tmin,
                                          const float* __restrict__ tmax,
                                          const float* __restrict__ frames, int i) {
    Lane l;
    l.o = load3(o + 3 * i);
    l.d = load3(d + 3 * i);
    l.tmin = tmin[i];
    l.tmax = tmax[i];
    l.cur = -1;
    l.frames = frames;
    return l;
}

}  // namespace wpt_sweep
