// K3: hit-record assembly for the winners of a closest-hit cast.
//
// Replaces wurblpt_tpu/render/intersect_mxu.py mxu_tri_attrs and the
// static-scene body of intersect.py assemble_hit (:489-632). On the TPU the
// attribute fetch was a one-hot [N,T] x [T,29] matrix product, because row
// gathers were priced per descriptor there. Here one thread per lane reads
// the winner's packed row directly and does the arithmetic of
// intersect.py:535-632: position, interpolated shading normal, uv and
// Gram-Schmidt tangent (ONB fallback when the tangent degenerates), the
// geometric normal, the material, the sphere branch (normal, lat/long uv,
// pole-safe tangent), and the front-face flip with the backside flag.
//
// Bound on the card: memory. Per lane ~40 bytes in and ~60 bytes out, plus
// one ~116-byte table row that stays in L1/L2 (the table is tiny). At
// N = 131072 that is ~13 MB of traffic, a few microseconds at 3.35 TB/s.
//
// Left for later: fusing this into K1's epilogue so t/prim/u/v never leave
// registers. It stays a separate kernel now so each kernel is tested alone.
//
// K3a, the animated branch (ANIM = true, wpt_assemble_hit_anim), replaces
// intersect.py:510-530 and :605-620: the winner's animation id (its
// triangle's or sphere's), the ray in that animation's object space (the
// frame rows of scene/animation.py anim_frames: r_inv, t_inv), the sphere's
// normal, uv and tangent from the hit point there (a triangle's attributes
// are object-space already), then the normals back to world by the normal
// matrix R diag(1/s) and the tangent by the forward map R diag(s), each
// normalized, before the front-face flip against the world ray. The same
// memory bound, plus the 120-byte frame row of the winner's animation (the
// frame's few rows stay in L1).
//
// Evaluation order matches intersect.assemble_hit_plain term by term; the
// library is built with -fmad=false, so both agree to the bit except where
// atan2f/asinf differ from PyTorch's (sphere uv only). The object-space ray
// is the sweeps' own (sweep_common.cuh object_ray), so a winner's hit point
// there is formed from the ray its test took.
#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

using wpt_sweep::dot3;
using wpt_sweep::FRAME;   // r_inv | t_inv | m_fwd | m_nrm
using wpt_sweep::load3;
using wpt_sweep::matvec;
using wpt_sweep::object_ray;
using wpt_sweep::V3;

constexpr int BLOCK = 128;
constexpr int TRI_F = 27;  // n0 n1 n2 | uv0 uv1 uv2 | tan0 tan1 tan2 | gn

__device__ __forceinline__ V3 scale3(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

__device__ __forceinline__ V3 normalize3(V3 a) {
    const float inv = 1.f / sqrtf(fmaxf(dot3(a, a), 1e-20f));
    return scale3(a, inv);
}

// w * a + u * b + v * c, left to right.
__device__ __forceinline__ V3 interp3(float w, float u, float v, V3 a, V3 b, V3 c) {
    return {w * a.x + u * b.x + v * c.x, w * a.y + u * b.y + v * c.y, w * a.z + u * b.z + v * c.z};
}

__device__ __forceinline__ void store3(float* p, V3 a) {
    p[0] = a.x;
    p[1] = a.y;
    p[2] = a.z;
}

// The animation rows of a K3a launch (all null for K3).
struct Anim {
    const int* tri_anim;
    const int* sph_anim;
    const float* frames;   // [A, FRAME]: each animation at the frame's instant
};

template <bool ANIM>
__global__ void __launch_bounds__(BLOCK)
assemble_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t, const int* __restrict__ prim,
                    const float* __restrict__ u_in, const float* __restrict__ v_in, int n,
                    const float* __restrict__ tri_f, const int* __restrict__ tri_i, int n_tris,
                    const float* __restrict__ sph_f, const int* __restrict__ sph_mat,
                    int n_spheres, Anim anim, float* __restrict__ pos_out,
                    float* __restrict__ nrm_out, float* __restrict__ gn_out,
                    float* __restrict__ tan_out, float* __restrict__ uv_out,
                    int* __restrict__ mat_out, bool* __restrict__ backside_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int p = prim[i];
    const bool hit = p >= 0;
    const int ps = hit ? p : 0;
    const bool is_tri = hit && ps < n_tris;
    const V3 ro = load3(o + 3 * i), rd = load3(d + 3 * i);
    const float tp = hit ? t[i] : 1.f;
    const V3 pos = {ro.x + tp * rd.x, ro.y + tp * rd.y, ro.z + tp * rd.z};
    V3 pos_local = pos;
    const float* frow = nullptr;
    if (ANIM) {
        const int aid_t = n_tris > 0 ? __ldg(anim.tri_anim + min(ps, n_tris - 1)) : 0;
        const int aid_s =
            n_spheres > 0 ? __ldg(anim.sph_anim + min(max(ps - n_tris, 0), n_spheres - 1)) : 0;
        const int aid = is_tri ? aid_t : aid_s;
        frow = anim.frames + aid * FRAME;
        V3 oa, da;
        object_ray(frow, ro, rd, oa, da);
        pos_local = {oa.x + tp * da.x, oa.y + tp * da.y, oa.z + tp * da.z};
    }

    V3 nrm = {0.f, 0.f, 0.f}, gn = {0.f, 0.f, 0.f}, tan = {0.f, 0.f, 0.f};
    float uv0 = 0.f, uv1 = 0.f;
    int mat = 0;
    if (is_tri) {
        const float* row = tri_f + static_cast<long>(ps) * TRI_F;
        const float u = u_in[i], v = v_in[i];
        const float w = 1.f - u - v;
        nrm = normalize3(interp3(w, u, v, load3(row + 0), load3(row + 3), load3(row + 6)));
        uv0 = w * __ldg(row + 9) + u * __ldg(row + 11) + v * __ldg(row + 13);
        uv1 = w * __ldg(row + 10) + u * __ldg(row + 12) + v * __ldg(row + 14);
        const V3 traw = interp3(w, u, v, load3(row + 15), load3(row + 18), load3(row + 21));
        gn = load3(row + 24);
        mat = __ldg(tri_i + 2 * ps);
        const bool has_tan = (__ldg(tri_i + 2 * ps + 1) & 2) > 0;
        const float tdn = dot3(traw, nrm);
        const V3 tgs = {traw.x - tdn * nrm.x, traw.y - tdn * nrm.y, traw.z - tdn * nrm.z};
        const float tlen = sqrtf(fmaxf(dot3(tgs, tgs), 1e-20f));
        if (has_tan && tlen > 1e-8f) {
            const float l = fmaxf(tlen, 1e-20f);
            tan = {tgs.x / l, tgs.y / l, tgs.z / l};
        } else {  // onb_from_normal(nrm) tangent
            const float sign = nrm.z >= 0.f ? 1.f : -1.f;
            const float a = -1.f / (sign + nrm.z);
            const float b = nrm.x * nrm.y * a;
            tan = {1.f + sign * nrm.x * nrm.x * a, sign * b, -sign * nrm.x};
        }
    } else if (n_spheres > 0) {
        const int si = min(max(ps - n_tris, 0), n_spheres - 1);
        const float* row = sph_f + 4 * si;
        const float r = fmaxf(__ldg(row + 3), 1e-20f);
        const V3 c = load3(row);
        const V3 local = {(pos_local.x - c.x) / r, (pos_local.y - c.y) / r,
                          (pos_local.z - c.z) / r};
        nrm = normalize3(local);
        gn = nrm;
        uv0 = 0.5f + atan2f(nrm.x, nrm.z) * 0.15915494309189535f;       // 1 / (2 pi)
        uv1 = 0.5f + asinf(fminf(fmaxf(nrm.y, -1.f), 1.f)) * 0.3183098861837907f;  // 1 / pi
        const V3 tr = {nrm.z, 0.f, -nrm.x};
        const float ln = sqrtf(fmaxf(dot3(tr, tr), 1e-20f));
        if (ln < 1e-6f) {
            tan = {1.f, 0.f, 0.f};
        } else {
            const float l = fmaxf(ln, 1e-20f);
            tan = {tr.x / l, tr.y / l, tr.z / l};
        }
        mat = __ldg(sph_mat + si);
    }
    if (ANIM) {
        nrm = normalize3(matvec(frow + 21, nrm));
        gn = normalize3(matvec(frow + 21, gn));
        tan = normalize3(matvec(frow + 12, tan));
    }
    const bool backside = dot3(rd, gn) > 0.f;
    const float flip = backside ? -1.f : 1.f;
    store3(pos_out + 3 * i, pos);
    store3(nrm_out + 3 * i, scale3(nrm, flip));
    store3(gn_out + 3 * i, scale3(gn, flip));
    store3(tan_out + 3 * i, tan);
    uv_out[2 * i + 0] = uv0;
    uv_out[2 * i + 1] = uv1;
    mat_out[i] = hit ? mat : 0;
    backside_out[i] = backside && hit;
}

}  // namespace

extern "C" int wpt_assemble_hit(const float* o, const float* d, const float* t, const int* prim,
                                const float* u, const float* v, int n, const float* tri_f,
                                const int* tri_i, int n_tris, const float* sph_f,
                                const int* sph_mat, int n_spheres, float* pos, float* nrm,
                                float* gn, float* tan, float* uv, int* mat, bool* backside,
                                void* stream) {
    if (n > 0) {
        const int grid = (n + BLOCK - 1) / BLOCK;
        assemble_hit_kernel<false><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            o, d, t, prim, u, v, n, tri_f, tri_i, n_tris, sph_f, sph_mat, n_spheres, Anim{}, pos,
            nrm, gn, tan, uv, mat, backside);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_assemble_hit_anim(const float* o, const float* d, const float* t,
                                     const int* prim, const float* u, const float* v, int n,
                                     const float* tri_f, const int* tri_i, int n_tris,
                                     const float* sph_f, const int* sph_mat, int n_spheres,
                                     const int* tri_anim, const int* sph_anim,
                                     const float* frames, float* pos, float* nrm, float* gn,
                                     float* tan, float* uv, int* mat, bool* backside,
                                     void* stream) {
    if (n > 0) {
        const int grid = (n + BLOCK - 1) / BLOCK;
        assemble_hit_kernel<true><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            o, d, t, prim, u, v, n, tri_f, tri_i, n_tris, sph_f, sph_mat, n_spheres,
            Anim{tri_anim, sph_anim, frames}, pos, nrm, gn, tan, uv, mat, backside);
    }
    return static_cast<int>(cudaGetLastError());
}
