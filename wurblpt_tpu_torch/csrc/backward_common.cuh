// The per-lane arithmetic of K3T, K8T and K7T, the backward kernels of K3's
// hit assembly (with the winner's intersection), of K8's sky radiance and
// of K7's measured RGL BRDF (eval and sample).
// Included by backward.cu (the kernels) and, through tests/cuda_host, by
// the host build that runs it on the CPU.
//
// Each lane function follows the plain PyTorch version
// (wurblpt_tpu_torch/render/backward.py assemble_hit_bwd_plain,
// env_radiance_bwd_plain; K7T: autograd through materials/rgl.py's
// rgl_eval_plain / rgl_sample_plain) term by term and hands its lane's
// terms to the kernel's block function (assemble_hit_bwd_lanes,
// env_radiance_bwd_lanes, rgl_bwd_lanes), which first sums them over the
// lanes of a warp that add to the same row, texel cell or table cell
// (group_sum: __match_any_sync and a shuffle tree), then adds each group's
// sums: K3T and K7T into a block-private copy of their tables in shared
// memory where they fit (its nonzero words added to the tables at the
// end), else into the tables; K8T into the map with one float4 atomic a
// texel. K8T's sample backward sums its lanes' rotation terms per thread
// and per block (env_sample_bwd_lanes), skipping the lanes whose cotangent
// is zero, and the last block to finish sums the blocks' partials.
// Float atomics make the sums' order vary from run to run (the checks hold
// them to a tolerance relative to the sum of the terms' magnitudes).
#pragma once

#include <cuda_runtime.h>

#include "envmap_common.cuh"
#include "rgl_common.cuh"

namespace wpt_bwd {

constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float PI = 3.14159265358979323846f;
constexpr float INV_2PI = 1.f / TWO_PI;
constexpr float INV_PI = 1.f / PI;
constexpr int TRI_F = 27;   // n0 n1 n2 | uv0 uv1 uv2 | tan0 tan1 tan2 | gn
constexpr int TRI_G = 9;    // p0 e1 e2

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void store3(float* p, V3 a) {
    p[0] = a.x;
    p[1] = a.y;
    p[2] = a.z;
}
__device__ __forceinline__ void add1(float* p, float v) {
    if (v != 0.f) atomicAdd(p, v);
}
__device__ __forceinline__ void add3(float* p, V3 a) {
    add1(p, a.x);
    add1(p + 1, a.y);
    add1(p + 2, a.z);
}

// Cotangent of a from that of a * rsqrt(max(a.a, 1e-20)).
__device__ __forceinline__ V3 normalize_bwd(V3 a, V3 g) {
    const float aa = dot(a, a);
    const float inv = 1.f / sqrtf(fmaxf(aa, 1e-20f));
    if (aa < 1e-20f) return inv * g;
    const V3 n = inv * a;
    return inv * (g - dot(n, g) * n);
}

// Cotangent of n from that of onb_from_normal(n)'s tangent
// (1 + s nx^2 a, s nx ny a, -s nx), s = sign(nz), a = -1 / (s + nz).
__device__ __forceinline__ V3 onb_tangent_bwd(V3 n, V3 g) {
    const float s = n.z >= 0.f ? 1.f : -1.f;
    const float a = -1.f / (s + n.z);
    return {g.x * (2.f * s * n.x * a) + g.y * (s * n.y * a) - g.z * s, g.y * (s * n.x * a),
            (g.x * n.x * n.x + g.y * n.x * n.y) * (s * a * a)};
}

// K3T's inputs: the cast's winners and K3's backside flags, the tables,
// the record's cotangents, and the outputs (g_o, g_d per lane; the
// tables' cotangents, zeroed before the launch, scatter-added).
struct HitIn {
    const float *o, *d, *t;
    const int* prim;
    const float *u, *v;
    const bool* backside;
    int n;
};
struct Tables {
    const float* tri_g;
    const float* tri_f;
    const int* tri_i;   // material, flags
    int n_tris;
    const float* sph_f;   // centre, radius
    int n_spheres;
};
struct Cot {
    const float *g_t, *g_pos, *g_nrm, *g_gn, *g_tan, *g_uv;
};
struct HitOut {
    float *g_o, *g_d, *g_tri_g, *g_tri_f, *g_sph_f;
};

// K3aT's animation rows: the winners' animation ids, the frame rows
// (scene/animation.py: r_inv | t_inv | m_fwd | m_nrm, FRAME floats; [A,
// FRAME] at one instant, stride 0, or [N, A, FRAME] per ray, stride A
// FRAME) and their cotangents (the rows' shape, zeroed before the launch).
constexpr int FRAME = 30;

struct AnimIn {
    const int* tri_anim;
    const int* sph_anim;
    const float* frames;
    long long stride;
    float* g_frames;
};

// One lane's terms of the tables (K3T, K3aT), which the block function
// sums over the lanes that share a row: the winner's row (a triangle's
// prim id, a sphere's n_tris + its index; -1: none) and its terms (a
// triangle's TRI_F words of tri_f, then its TRI_G words of tri_g; a
// sphere's 4 words of sph_f), and at one instant (K3aT) the winner's frame
// row (-1: none) and its FRAME terms.
struct HitTerms {
    int row;
    float v[TRI_F + TRI_G];
    int frame;
    float f[FRAME];
};

// m v and m^T v for a row-major 3 x 3 m.
__device__ __forceinline__ V3 matvec(const float* m, V3 a) {
    return {m[0] * a.x + m[1] * a.y + m[2] * a.z, m[3] * a.x + m[4] * a.y + m[5] * a.z,
            m[6] * a.x + m[7] * a.y + m[8] * a.z};
}
__device__ __forceinline__ V3 matvec_t(const float* m, V3 a) {
    return {m[0] * a.x + m[3] * a.y + m[6] * a.z, m[1] * a.x + m[4] * a.y + m[7] * a.z,
            m[2] * a.x + m[5] * a.y + m[8] * a.z};
}

// r (row major, 9 floats) += a b^T.
__device__ __forceinline__ void outer_add(float* r, V3 a, V3 b) {
    const float av[3] = {a.x, a.y, a.z}, bv[3] = {b.x, b.y, b.z};
    for (int k = 0; k < 3; ++k)
        for (int j = 0; j < 3; ++j) r[3 * k + j] += av[k] * bv[j];
}

// K3T for lane i (render/backward.py assemble_hit_bwd_plain): g_o and g_d
// written, the tables' terms left in h (h.row and h.frame -1 where there
// are none; the caller zeroes h.v and h.f). ANIM: K3aT, the winner's hit in
// its animation's object space (o_s = r_inv (o - t_inv), d_s = r_inv d
// from the lane's row), its normals pushed to world by m_nrm and its
// tangent by m_fwd, each normalized: the world cotangents go back through
// both, the object-space backward runs on (o_s, d_s), and the row's
// cotangent goes to h.f at one instant, to the lane's own row of g_frames
// under per-ray rows.
template <bool ANIM>
__device__ __forceinline__ void assemble_hit_bwd_lane(int i, const HitIn& in, const Tables& tb,
                                                      const Cot& c, const HitOut& out,
                                                      const AnimIn& an, HitTerms& h) {
    const int p = in.prim[i];
    const bool hit = p >= 0;
    const int ps = hit ? p : 0;
    const bool is_tri = hit && ps < tb.n_tris;
    const float t = in.t[i], u = in.u[i], v = in.v[i];
    const float tp = hit ? t : 1.f;
    const V3 o = load3(in.o + 3 * i), d = load3(in.d + 3 * i);
    const V3 pos = o + tp * d;
    const float flip = in.backside[i] ? -1.f : 1.f;
    const V3 g_pw = load3(c.g_pos + 3 * i);   // the world position's cotangent
    const V3 g_nrm = load3(c.g_nrm + 3 * i), g_gn = load3(c.g_gn + 3 * i);
    const V3 g_tan = load3(c.g_tan + 3 * i);
    const float g_uu = c.g_uv[2 * i], g_uvv = c.g_uv[2 * i + 1];
    // the winner's space: its animation's object space (ANIM) or the world
    const float* fr = nullptr;
    float* gfr = nullptr;
    V3 os = o, ds = d, pos_s = pos, oo = o;
    int aid = 0;
    if (ANIM) {
        aid =
            is_tri ? an.tri_anim[ps]
                   : (tb.n_spheres > 0 ? an.sph_anim[min(max(ps - tb.n_tris, 0), tb.n_spheres - 1)]
                                       : 0);
        fr = an.frames + i * an.stride + aid * FRAME;
        gfr = an.g_frames + i * an.stride + aid * FRAME;
        oo = o - load3(fr + 9);
        os = matvec(fr, oo);
        ds = matvec(fr, d);
        pos_s = os + tp * ds;
    }
    // the winner's frame in its space: a triangle's interpolated normal and
    // tangent, a sphere's normal at the hit point
    const float* row = nullptr;
    V3 n0{}, n1{}, n2{}, t0{}, t1{}, t2{}, n_raw{}, n_i{}, tan_raw{}, tan_gs{};
    float tdn = 0.f, tl = 1.f;
    bool use_gs = false;
    int si = 0;
    V3 sc = {0.f, 0.f, 0.f}, local{}, n_s{};
    float sr = 0.f, rr = 1.f, den = 0.f, ln = 1.f;
    const float w = 1.f - u - v;
    if (is_tri) {
        row = tb.tri_f + static_cast<long>(ps) * TRI_F;
        n0 = load3(row), n1 = load3(row + 3), n2 = load3(row + 6);
        t0 = load3(row + 15), t1 = load3(row + 18), t2 = load3(row + 21);
        n_raw = w * n0 + u * n1 + v * n2;
        n_i = (1.f / sqrtf(fmaxf(dot(n_raw, n_raw), 1e-20f))) * n_raw;
        tan_raw = w * t0 + u * t1 + v * t2;
        tdn = dot(tan_raw, n_i);
        tan_gs = tan_raw - tdn * n_i;
        tl = sqrtf(fmaxf(dot(tan_gs, tan_gs), 1e-20f));
        use_gs = (tb.tri_i[2 * ps + 1] & 2) != 0 && tl > 1e-8f;
    } else if (tb.n_spheres > 0) {
        si = min(max(ps - tb.n_tris, 0), tb.n_spheres - 1);
        sc = load3(tb.sph_f + 4 * si);
        sr = tb.sph_f[4 * si + 3];
        rr = fmaxf(sr, 1e-20f);
        local = (pos_s - sc) / rr;
        n_s = (1.f / sqrtf(fmaxf(dot(local, local), 1e-20f))) * local;
        den = n_s.x * n_s.x + n_s.z * n_s.z;
        ln = sqrtf(fmaxf(den, 1e-20f));
    }
    // cotangents of that frame: the record's, unflipped, and (ANIM) back
    // through the world's normalizations and maps
    V3 g_no = flip * g_nrm, g_go = flip * g_gn, g_to = g_tan;
    float grow[FRAME];
    if (ANIM) {
        for (int k = 0; k < FRAME; ++k) grow[k] = 0.f;
        V3 n_obj = {0.f, 0.f, 0.f}, gn_obj = n_obj, tan_obj = n_obj;
        if (is_tri) {
            n_obj = n_i;
            gn_obj = load3(row + 24);
            if (use_gs) {
                tan_obj = tan_gs / tl;
            } else {
                const float s = n_i.z >= 0.f ? 1.f : -1.f;
                const float a = -1.f / (s + n_i.z);
                tan_obj = {1.f + s * n_i.x * n_i.x * a, s * (n_i.x * n_i.y * a), -s * n_i.x};
            }
        } else if (tb.n_spheres > 0) {
            n_obj = gn_obj = n_s;
            tan_obj = ln < 1e-6f ? V3{1.f, 0.f, 0.f} : V3{n_s.z / ln, 0.f, -n_s.x / ln};
        }
        const V3 a_n = normalize_bwd(matvec(fr + 21, n_obj), g_no);
        const V3 a_g = normalize_bwd(matvec(fr + 21, gn_obj), g_go);
        const V3 a_t = normalize_bwd(matvec(fr + 12, tan_obj), g_to);
        g_no = matvec_t(fr + 21, a_n);
        g_go = matvec_t(fr + 21, a_g);
        g_to = matvec_t(fr + 12, a_t);
        outer_add(grow + 12, a_t, tan_obj);
        outer_add(grow + 21, a_n, n_obj);
        outer_add(grow + 21, a_g, gn_obj);
    }
    // the position's cotangent in the winner's space (K3T: the world's)
    V3 g_ps = ANIM ? V3{0.f, 0.f, 0.f} : g_pw;
    float g_u = 0.f, g_v = 0.f;
    V3 g_c = {0.f, 0.f, 0.f};
    float g_r = 0.f;
    if (is_tri) {
        V3 g_ni = g_no;
        V3 g_traw = {0.f, 0.f, 0.f};
        if (use_gs) {
            const V3 tan_tri = tan_gs / tl;
            const V3 g_gs = (g_to - dot(tan_tri, g_to) * tan_tri) / tl;
            const float gsn = dot(g_gs, n_i);
            g_traw = g_gs - gsn * n_i;
            g_ni = g_ni - gsn * tan_raw - tdn * g_gs;
        } else {
            g_ni = g_ni + onb_tangent_bwd(n_i, g_to);
        }
        const V3 g_nraw = normalize_bwd(n_raw, g_ni);
        const float du0 = row[11] - row[9], du1 = row[12] - row[10];
        const float dv0 = row[13] - row[9], dv1 = row[14] - row[10];
        g_u = dot(g_nraw, n1 - n0) + dot(g_traw, t1 - t0) + (g_uu * du0 + g_uvv * du1);
        g_v = dot(g_nraw, n2 - n0) + dot(g_traw, t2 - t0) + (g_uu * dv0 + g_uvv * dv1);
        float* gr = h.v;
        h.row = ps;
        store3(gr, w * g_nraw);
        store3(gr + 3, u * g_nraw);
        store3(gr + 6, v * g_nraw);
        gr[9] = w * g_uu;
        gr[10] = w * g_uvv;
        gr[11] = u * g_uu;
        gr[12] = u * g_uvv;
        gr[13] = v * g_uu;
        gr[14] = v * g_uvv;
        store3(gr + 15, w * g_traw);
        store3(gr + 18, u * g_traw);
        store3(gr + 21, v * g_traw);
        store3(gr + 24, g_go);
    } else if (tb.n_spheres > 0) {
        V3 g_ns = g_no + g_go;
        // lat/long uv: u = 1/2 + atan2(x, z) / 2 pi, v = 1/2 + asin(y) / pi
        if (g_uu != 0.f) {
            const float tu = g_uu * INV_2PI / den;
            g_ns.x += tu * n_s.z;
            g_ns.z -= tu * n_s.x;
        }
        if (g_uvv != 0.f && fabsf(n_s.y) <= 1.f) g_ns.y += g_uvv * INV_PI / sqrtf(1.f - n_s.y * n_s.y);
        // the pole-safe tangent (z, 0, -x) / |(z, -x)|
        if (ln >= 1e-6f) {
            const float qx = n_s.z / ln, qz = -n_s.x / ln;
            const float qg = qx * g_to.x + qz * g_to.z;
            const float gqx = (g_to.x - qx * qg) / ln, gqz = (g_to.z - qz * qg) / ln;
            g_ns.x -= gqz;
            g_ns.z += gqx;
        }
        const V3 g_local = normalize_bwd(local, g_ns);
        g_ps = g_ps + g_local / rr;
        g_c = (-1.f * g_local) / rr;
        g_r = sr >= 1e-20f ? -dot(g_local, local) / rr : 0.f;
    }
    V3 g_os = g_ps;
    V3 g_ds = tp * g_ps;
    float g_tt = 0.f;
    if (hit) {
        g_tt = c.g_t[i] + dot(g_ps, ds);
        if (ANIM) g_tt = g_tt + dot(g_pw, d);
    }
    if (is_tri) {
        // o + t d = p0 + u e1 + v e2: lambda = [d, -e1, -e2]^-T (g_t, g_u, g_v)
        const float* geo = tb.tri_g + static_cast<long>(ps) * TRI_G;
        const V3 e1 = load3(geo + 3), e2 = load3(geo + 6);
        const V3 nv = cross(e1, e2), pv = cross(ds, e2), qv = cross(e1, ds);
        const V3 lam = (g_tt * nv + g_u * pv + g_v * qv) / dot(ds, nv);
        g_os = g_os - lam;
        g_ds = g_ds - t * lam;
        float* gg = h.v + TRI_F;
        store3(gg, lam);
        store3(gg + 3, u * lam);
        store3(gg + 6, v * lam);
    } else if (tb.n_spheres > 0) {
        if (hit) {   // |o + t d - c| = r
            const V3 q = pos_s - sc;
            const float s = g_tt / dot(q, ds);
            g_os = g_os - s * q;
            g_ds = g_ds - (s * t) * q;
            g_c = g_c + s * q;
            g_r = g_r + s * sr;
        }
        h.row = tb.n_tris + si;
        store3(h.v, g_c);
        h.v[3] = g_r;
    }
    V3 g_o = g_os, g_d = g_ds;
    if (ANIM) {
        // o_s = r_inv (o - t_inv), d_s = r_inv d
        g_o = g_pw + matvec_t(fr, g_os);
        g_d = tp * g_pw + matvec_t(fr, g_ds);
        outer_add(grow, g_os, oo);
        outer_add(grow, g_ds, d);
        const V3 g_ti = -1.f * matvec_t(fr, g_os);
        grow[9] = g_ti.x;
        grow[10] = g_ti.y;
        grow[11] = g_ti.z;
        if (an.stride == 0) {
            h.frame = aid;
            for (int k = 0; k < FRAME; ++k) h.f[k] = grow[k];
        } else {
            for (int k = 0; k < FRAME; ++k) gfr[k] = grow[k];
        }
    }
    store3(out.g_o + 3 * i, g_o);
    store3(out.g_d + 3 * i, g_d);
}

// ---------------------------------------------------------------------------
// K8T
// ---------------------------------------------------------------------------

__device__ __forceinline__ V3 quat_rotate(float ux, float uy, float uz, float w, V3 v) {
    const V3 uu = {ux, uy, uz};
    const V3 t = 2.f * cross(uu, v);
    return v + w * t + cross(uu, t);
}

// Cotangent of q = (u, w) from that g of quat_rotate(q, v) = v + w t + u x t,
// t = 2 u x v (for s = a x b: g_a = b x g_s, g_b = g_s x a).
__device__ __forceinline__ float4 quat_rotate_bwd_q(V3 u, float w, V3 v, V3 g) {
    const V3 t = 2.f * cross(u, v);
    const V3 g_t = w * g + cross(g, u);
    const V3 g_u = cross(t, g) + 2.f * cross(v, g_t);
    return make_float4(g_u.x, g_u.y, g_u.z, dot(g, t));
}

__device__ __forceinline__ float mod1(float x) {
    const float r = fmodf(x, 1.f);
    return (r != 0.f && r < 0.f) ? r + 1.f : r;
}

__device__ __forceinline__ float dot4(const float* g, float4 a) {
    return g[0] * a.x + g[1] * a.y + g[2] * a.z + g[3] * a.w;
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
    const float gf = 1.f - f;
    return make_float4(a.x * gf + b.x * f, a.y * gf + b.y * f, a.z * gf + b.z * f,
                       a.w * gf + b.w * f);
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
    return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// One lane's terms of the map's cotangent (K8T): its four taps' texels
// (tap[0] also names the lookup's cell: the other three follow from it)
// and their 4 words each, v[4 k + c] for tap k and channel c.
struct SkyTaps {
    int tap[4];
    float v[16];
};

__device__ __forceinline__ void scale4(float* p, const float* g, float s) {
    for (int k = 0; k < 4; ++k) p[k] = g[k] * s;
}

// The bilinear lookup's backward: taps i00 (1 - fx)(1 - fy), i01 fx (1 - fy),
// i10 (1 - fx) fy, i11 fx fy and their cotangents left in t; returns the
// cotangents of fx and fy.
__device__ __forceinline__ void bilinear_bwd(const float4* img, SkyTaps& t, const float* g,
                                             int i00, int i01, int i10, int i11, float fx,
                                             float fy, float* g_fx, float* g_fy) {
    const float4 c00 = img[i00], c01 = img[i01], c10 = img[i10], c11 = img[i11];
    const float gx = 1.f - fx, gy = 1.f - fy;
    t.tap[0] = i00;
    t.tap[1] = i01;
    t.tap[2] = i10;
    t.tap[3] = i11;
    scale4(t.v, g, gx * gy);
    scale4(t.v + 4, g, fx * gy);
    scale4(t.v + 8, g, gx * fy);
    scale4(t.v + 12, g, fx * fy);
    const float4 a = sub4(c01, c00), b = sub4(c11, c10);
    *g_fx = dot4(g, make_float4(a.x * gy + b.x * fy, a.y * gy + b.y * fy, a.z * gy + b.z * fy,
                                a.w * gy + b.w * fy));
    *g_fy = dot4(g, sub4(lerp4(c10, c11, fx), lerp4(c00, c01, fx)));
}

// K8T for lane i of an equirect (kind 1) or cube (kind 2) map
// (render/backward.py env_radiance_bwd_plain): the texels' cotangents left
// in t, the direction's written to g_d; returns the lane's term of the
// rotation's cotangent (ROT; zero otherwise), that of dm =
// quat_rotate(conj(q), d) with respect to q.
template <bool ROT>
__device__ __forceinline__ float4 env_radiance_bwd_lane(int i, const float* d, int kind,
                                                        const float4* img, int h, int w,
                                                        const float* rot, const float* g,
                                                        float* g_d, SkyTaps& t) {
    const float* gi = g + 4 * i;
    const V3 di = load3(d + 3 * i);
    const V3 dm = quat_rotate(-rot[0], -rot[1], -rot[2], rot[3], di);
    V3 g_dm;
    if (kind == 1) {
        const float u = mod1(atan2f(dm.x, -dm.z) / TWO_PI);
        const float v = acosf(fminf(fmaxf(dm.y, -1.f), 1.f)) / PI;
        const float x = u * static_cast<float>(w) - 0.5f;
        const float y = v * static_cast<float>(h) - 0.5f;
        const float x0 = floorf(x), y0 = floorf(y);
        const int x0i = ((static_cast<int>(x0) % w) + w) % w;
        const int y0i = min(max(static_cast<int>(y0), 0), h - 1);
        const int x1i = (x0i + 1) % w;
        const int y1i = min(y0i + 1, h - 1);
        float g_fx, g_fy;
        bilinear_bwd(img, t, gi, y0i * w + x0i, y0i * w + x1i, y1i * w + x0i, y1i * w + x1i,
                     x - x0, y - y0, &g_fx, &g_fy);
        const float g_u = g_fx * static_cast<float>(w), g_v = g_fy * static_cast<float>(h);
        const float tu = g_u * INV_2PI / (dm.x * dm.x + dm.z * dm.z);
        const float tv = fabsf(dm.y) <= 1.f ? -g_v * INV_PI / sqrtf(1.f - dm.y * dm.y) : 0.f;
        g_dm = {-dm.z * tu, tv, dm.x * tu};
    } else {
        const float ax = fabsf(dm.x), ay = fabsf(dm.y), az = fabsf(dm.z);
        const bool is_x = ax >= ay && ax >= az;
        const bool is_y = !is_x && ay >= az;
        int face;
        float major, sc, tc;
        if (is_x) {
            face = dm.x > 0.f ? 0 : 1;
            major = ax;
            sc = dm.x > 0.f ? -dm.z : dm.z;
            tc = -dm.y;
        } else if (is_y) {
            face = dm.y > 0.f ? 2 : 3;
            major = ay;
            sc = dm.x;
            tc = dm.y > 0.f ? dm.z : -dm.z;
        } else {
            face = dm.z > 0.f ? 4 : 5;
            major = az;
            sc = dm.z > 0.f ? dm.x : -dm.x;
            tc = -dm.y;
        }
        const float ma = fmaxf(major, 1e-20f);
        const float u = 0.5f * (sc / ma + 1.f);
        const float v = 0.5f * (tc / ma + 1.f);
        const float us_ = u * static_cast<float>(w) - 0.5f, vs_ = v * static_cast<float>(h) - 0.5f;
        const float us = fmaxf(us_, 0.f), vs = fmaxf(vs_, 0.f);
        const int x0 = min(max(static_cast<int>(us), 0), w - 1);
        const int y0 = min(max(static_cast<int>(vs), 0), h - 1);
        const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
        const int f = face * h * w;
        float g_a, g_b;
        bilinear_bwd(img, t, gi, f + y0 * w + x0, f + y0 * w + x1, f + y1 * w + x0,
                     f + y1 * w + x1, us - static_cast<float>(x0), vs - static_cast<float>(y0),
                     &g_a, &g_b);
        const float g_u = us_ >= 0.f ? g_a * static_cast<float>(w) : 0.f;
        const float g_v = vs_ >= 0.f ? g_b * static_cast<float>(h) : 0.f;
        const float g_sc = 0.5f * g_u / ma, g_tc = 0.5f * g_v / ma;
        const float g_ma = major >= 1e-20f ? -(g_sc * sc + g_tc * tc) / ma : 0.f;
        const auto sgn = [](float a) { return a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f); };
        if (is_x)
            g_dm = {g_ma * sgn(dm.x), -g_tc, dm.x > 0.f ? -g_sc : g_sc};
        else if (is_y)
            g_dm = {g_sc, g_ma * sgn(dm.y), dm.y > 0.f ? g_tc : -g_tc};
        else
            g_dm = {dm.z > 0.f ? g_sc : -g_sc, -g_tc, g_ma * sgn(dm.z)};
    }
    // dm = R(conj q) d: its adjoint is R(q)
    store3(g_d + 3 * i, quat_rotate(rot[0], rot[1], rot[2], rot[3], g_dm));
    if (!ROT) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 gc = quat_rotate_bwd_q({-rot[0], -rot[1], -rot[2]}, rot[3], di, g_dm);
    return make_float4(-gc.x, -gc.y, -gc.z, gc.w);
}

// The sample's backward for lane i (render/backward.py env_sample_bwd_plain):
// the lane's term of the rotation's cotangent, that of dir = quat_rotate(q,
// d_map) with respect to q, from the direction's cotangent g, d_map the
// sample's map-space direction recomputed from the uniforms u3
// (envmap_common.cuh sample_map); the pdf carries none.
__device__ __forceinline__ float4 env_sample_bwd_lane(int i, const float* u3, const float* pdf,
                                                      const float* alias_prob,
                                                      const int* alias_idx, int res,
                                                      const float* rot, V3 g) {
    float3 dm;
    wpt_env::sample_map(u3[3 * i], u3[3 * i + 1], u3[3 * i + 2], pdf, alias_prob, alias_idx, res,
                        &dm);
    return quat_rotate_bwd_q({rot[0], rot[1], rot[2]}, rot[3], {dm.x, dm.y, dm.z}, g);
}

// ---------------------------------------------------------------------------
// K3T's and K8T's block functions: each lane's terms summed over the lanes
// of its warp that add to the same row or cell, then per block
// ---------------------------------------------------------------------------

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int HIT_BLOCK = 256;          // K3T's and K3aT's threads a block
constexpr int SKY_BLOCK = 1024;         // K8T's (at most 64 registers a thread)
constexpr int HIT_SMEM_WORDS = 12288;   // 48 KB: the largest hit tables summed in shared memory

// The lanes of the warp whose key equals this lane's (a key below 0: no
// group), ranked in lane order: this lane's rank, the group's size and
// peers, and the largest group of the warp. Every thread of the warp calls
// it, each with its own key.
struct WarpGroup {
    unsigned above;   // the group's lanes after this one
    int rank, size, most;
    bool first;       // the group's first lane (of a key >= 0)
};
__device__ __forceinline__ WarpGroup group_of(int key) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned peers = __match_any_sync(FULL_MASK, key);
    const unsigned below = peers & ((1u << lane) - 1u);
    WarpGroup gr;
    gr.above = peers & ~below & ~(1u << lane);
    gr.rank = __popc(below);
    gr.size = key >= 0 ? __popc(peers) : 1;
    gr.most = __reduce_max_sync(FULL_MASK, gr.size);
    gr.first = key >= 0 && gr.rank == 0;
    return gr;
}

// Sums v over the lanes of this lane's group (group_of): a shuffle tree over
// the group's ranks, at step s = 1, 2, 4, ... rank r (a multiple of 2 s)
// adding the partial sum of rank r + s, an order fixed by the group's
// lanes. Every thread of the warp calls it; returns true in the group's
// first lane, which then holds the group's sums.
template <int N>
__device__ __forceinline__ bool group_add(const WarpGroup& gr, float (&v)[N]) {
    const unsigned lane = threadIdx.x & 31u;
    unsigned above = gr.above;   // at step s: less its first s - 1
    for (int s = 1; s < gr.most; s <<= 1) {
        const bool take = (gr.rank & (2 * s - 1)) == 0 && gr.rank + s < gr.size;
        const int src = take ? __ffs(above) - 1 : static_cast<int>(lane);
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const float o = __shfl_sync(FULL_MASK, v[j], src);
            if (take) v[j] += o;
        }
        for (int k = 0; k < s; ++k) above &= above - 1u;
    }
    return gr.first;
}

// Sums v over the lanes of the warp whose key equals this lane's
// (group_of, group_add). Every thread of the warp calls it, each with its
// own key; a key below 0 is no group and sums nothing (a warp without a
// key returns at its first vote). Returns true in the group's first lane,
// which then holds the group's sums.
template <int N>
__device__ __forceinline__ bool group_sum(int key, float (&v)[N]) {
    if (!__any_sync(FULL_MASK, key >= 0)) return false;   // a render's sparse cotangents
    return group_add(group_of(key), v);
}

// v summed over the block of B threads, in thread 0 (the other threads get
// their own v back): shuffles within each warp, the warps' sums in shared
// memory. Every thread of the block calls it.
template <int B>
__device__ __forceinline__ float4 block_sum4(float4 v) {
    __shared__ float4 part[B / 32];
    for (int off = 16; off > 0; off >>= 1) {
        v.x += __shfl_xor_sync(FULL_MASK, v.x, off);
        v.y += __shfl_xor_sync(FULL_MASK, v.y, off);
        v.z += __shfl_xor_sync(FULL_MASK, v.z, off);
        v.w += __shfl_xor_sync(FULL_MASK, v.w, off);
    }
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x != 0) return v;
    float4 s = part[0];
    for (int k = 1; k < B / 32; ++k) {
        s.x += part[k].x;
        s.y += part[k].y;
        s.z += part[k].z;
        s.w += part[k].w;
    }
    return s;
}

// Adds v, summed over the block of B threads (block_sum4), to out[0..3]:
// one atomicAdd per nonzero component from thread 0. Every thread of the
// block calls it, last.
template <int B>
__device__ __forceinline__ void block_add4(float4 v, float* out) {
    const float4 s = block_sum4<B>(v);
    if (threadIdx.x != 0) return;
    add1(out, s.x);
    add1(out + 1, s.y);
    add1(out + 2, s.z);
    add1(out + 3, s.w);
}

// Adds v to a texel's 4 words in global memory (16-byte aligned) where any
// is nonzero: one vector atomic (sm_90's float4 atomicAdd, each word added
// atomically), a quarter of the scalar atomics' operations.
__device__ __forceinline__ void add_texel(float* p, float4 v) {
    if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
        atomicAdd(reinterpret_cast<float4*>(p), v);
}

// A persistent launch over n lanes with at most `resident` blocks: each
// block takes a contiguous chunk of lanes, a multiple of `block`, so that
// its loop makes the same trips in every thread and its terms land on a
// local part of the tables. Returns the grid and sets *chunk.
inline int chunked_grid(long long n, int resident, int block, int* chunk) {
    const long long per = (n + resident - 1) / resident;
    const long long c = (per + block - 1) / block * block;
    *chunk = static_cast<int>(c);
    return static_cast<int>((n + c - 1) / c);
}

// K3T's and K3aT's tables summed in shared memory, in words: tri_f, tri_g,
// sph_f and (K3aT at one instant) the [A, FRAME] frame rows, in that order.
__host__ __device__ inline long long hit_table_words(int n_tris, int n_spheres, int frame_rows) {
    return static_cast<long long>(n_tris) * (TRI_F + TRI_G) + 4LL * n_spheres +
           static_cast<long long>(FRAME) * frame_rows;
}

// Whether K3T (frame_rows 0) or K3aT (frame_rows A at one instant, 0 per
// ray) sums its tables in shared memory: where they fit `limit_words`
// (HIT_SMEM_WORDS on the card).
inline bool hit_takes_shared(int n_tris, int n_spheres, int frame_rows, long long limit_words) {
    return hit_table_words(n_tris, n_spheres, frame_rows) <= limit_words;
}

// Where a block adds its groups' sums: its tables in shared memory, or the
// tables' cotangents themselves.
struct HitSink {
    float *tri_f, *tri_g, *sph_f, *frames;
};

// K3T (ANIM: K3aT) over the block's chunk of lanes [blockIdx.x chunk, +
// chunk): each lane's terms (assemble_hit_bwd_lane) summed over the warp's
// lanes of one row (group_sum on the row; K3aT's rows of one instant on the
// frame row), each group's sums added by its first lane into the block's
// tables in shared memory (SHARED: `acc`, hit_table_words of them with the
// n_anims rows of one instant, zeroed here and their nonzero words added to
// the tables at the end) or into the tables. Every thread calls it.
template <bool ANIM, bool SHARED>
__device__ __forceinline__ void assemble_hit_bwd_lanes(const HitIn& in, const Tables& tb,
                                                       const Cot& c, const HitOut& out,
                                                       const AnimIn& an, int n_anims, int chunk,
                                                       float* acc) {
    const bool one_instant = ANIM && an.stride == 0;
    const long long f_words = static_cast<long long>(tb.n_tris) * TRI_F;
    const long long t_words = static_cast<long long>(tb.n_tris) * (TRI_F + TRI_G);
    const long long s_words = t_words + 4LL * tb.n_spheres;
    const long long words = hit_table_words(tb.n_tris, tb.n_spheres, one_instant ? n_anims : 0);
    HitSink sink{out.g_tri_f, out.g_tri_g, out.g_sph_f, an.g_frames};
    if (SHARED) {
        for (long long k = threadIdx.x; k < words; k += HIT_BLOCK) acc[k] = 0.f;
        sink = HitSink{acc, acc + f_words, acc + t_words, acc + s_words};
        __syncthreads();
    }
    const int start = blockIdx.x * chunk;
    const int end = min(in.n, start + chunk);
    for (int base = start; base < end; base += HIT_BLOCK) {
        const int i = base + static_cast<int>(threadIdx.x);
        HitTerms h;
        h.row = -1;
        h.frame = -1;
        for (int j = 0; j < TRI_F + TRI_G; ++j) h.v[j] = 0.f;
        for (int k = 0; k < FRAME; ++k) h.f[k] = 0.f;
        if (i < end) assemble_hit_bwd_lane<ANIM>(i, in, tb, c, out, an, h);
        if (group_sum(h.row, h.v)) {
            if (h.row < tb.n_tris) {
                float* rf = sink.tri_f + static_cast<long long>(h.row) * TRI_F;
                float* rg = sink.tri_g + static_cast<long long>(h.row) * TRI_G;
                for (int j = 0; j < TRI_F; ++j) add1(rf + j, h.v[j]);
                for (int j = 0; j < TRI_G; ++j) add1(rg + j, h.v[TRI_F + j]);
            } else {
                float* rs = sink.sph_f + 4LL * (h.row - tb.n_tris);
                for (int j = 0; j < 4; ++j) add1(rs + j, h.v[j]);
            }
        }
        if (one_instant && group_sum(h.frame, h.f)) {
            float* rf = sink.frames + static_cast<long long>(h.frame) * FRAME;
            for (int k = 0; k < FRAME; ++k) add1(rf + k, h.f[k]);
        }
    }
    if (SHARED) {
        __syncthreads();
        for (long long k = threadIdx.x; k < words; k += HIT_BLOCK) {
            const float s = acc[k];
            if (s == 0.f) continue;
            float* dst = k < f_words   ? out.g_tri_f + k
                         : k < t_words ? out.g_tri_g + (k - f_words)
                         : k < s_words ? out.g_sph_f + (k - t_words)
                                       : an.g_frames + (k - s_words);
            atomicAdd(dst, s);
        }
    }
}

// K8T over the block's chunk of lanes [blockIdx.x chunk, + chunk). An
// equirect or cube map: each lane's taps (env_radiance_bwd_lane) summed over
// the warp's lanes of one lookup cell (group_sum; a lane whose cotangent is
// zero adds nothing), each group's sums added by its first lane to g_img, a
// texel's 4 words by one vector atomic. ROT: the lanes' rotation terms
// summed per thread, then per block (block_add4). A constant sky (kind 3):
// g_d = 0 and the lanes' cotangents summed per thread, then per block into
// g_const. `active` (or null: every lane): a lane outside it carries no
// cotangent (K8's masked lanes write constants) and gets g_d = 0. Every
// thread calls it.
template <bool ROT>
__device__ __forceinline__ void env_radiance_bwd_lanes(const float* d, int n, int kind,
                                                       const float4* img, int h, int w,
                                                       const float* rot, const float* g,
                                                       const bool* active, float* g_d,
                                                       float* g_img, float* g_const,
                                                       float* g_rot, int chunk) {
    const int start = blockIdx.x * chunk;
    const int end = min(n, start + chunk);
    if (kind == 3) {   // g_rot stays 0
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = start + static_cast<int>(threadIdx.x); i < end; i += SKY_BLOCK) {
            store3(g_d + 3 * i, {0.f, 0.f, 0.f});
            if (active != nullptr && !active[i]) continue;
            s.x += g[4 * i];
            s.y += g[4 * i + 1];
            s.z += g[4 * i + 2];
            s.w += g[4 * i + 3];
        }
        block_add4<SKY_BLOCK>(s, g_const);
        return;
    }
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = start; base < end; base += SKY_BLOCK) {
        const int i = base + static_cast<int>(threadIdx.x);
        SkyTaps t;
        for (int j = 0; j < 16; ++j) t.v[j] = 0.f;
        int cell = -1;
        if (i < end && active != nullptr && !active[i]) {
            store3(g_d + 3 * i, {0.f, 0.f, 0.f});
        } else if (i < end) {
            const float4 qi = env_radiance_bwd_lane<ROT>(i, d, kind, img, h, w, rot, g, g_d, t);
            q.x += qi.x;
            q.y += qi.y;
            q.z += qi.z;
            q.w += qi.w;
            const float* gi = g + 4 * i;
            if (gi[0] != 0.f || gi[1] != 0.f || gi[2] != 0.f || gi[3] != 0.f) cell = t.tap[0];
        }
        if (group_sum(cell, t.v))
            for (int k = 0; k < 4; ++k) {
                const float* v = t.v + 4 * k;
                add_texel(g_img + 4LL * t.tap[k], make_float4(v[0], v[1], v[2], v[3]));
            }
    }
    if (ROT) block_add4<SKY_BLOCK>(q, g_rot);
}

constexpr int SAMPLE_BLOCK = 1024;   // K8T's sample backward's threads a block

// K8T's sample backward over the block's chunk of lanes [blockIdx.x chunk,
// + chunk): a lane outside `active` (where given: K8's masked lanes, whose
// direction is a constant) or whose direction's cotangent is zero in all
// three words adds nothing and is skipped before its uniforms and tables
// are read (a render's NEE directions carry a cotangent on a few lanes); the
// others' rotation terms (env_sample_bwd_lane) are summed per thread, then
// per block into partial[blockIdx.x]. The block that finishes last (`done`
// counts the finished blocks; it is 0 at the launch and reset to 0 here)
// sums the grid's partials in block order and writes g_rot: no float
// atomic, no zeroed output, the same sum in every run. Every thread calls
// it.
__device__ __forceinline__ void env_sample_bwd_lanes(const float* u3, int n, const float* pdf,
                                                     const float* alias_prob,
                                                     const int* alias_idx, int res,
                                                     const float* rot, const float* g_dir,
                                                     const bool* active, float4* partial,
                                                     unsigned* done, float* g_rot, int chunk) {
    __shared__ bool last;
    const int start = blockIdx.x * chunk;
    const int end = min(n, start + chunk);
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = start + static_cast<int>(threadIdx.x); i < end; i += SAMPLE_BLOCK) {
        if (active != nullptr && !active[i]) continue;   // a masked lane's constant direction
        const V3 g = load3(g_dir + 3 * i);
        if (g.x == 0.f && g.y == 0.f && g.z == 0.f) continue;
        const float4 qi = env_sample_bwd_lane(i, u3, pdf, alias_prob, alias_idx, res, rot, g);
        q.x += qi.x;
        q.y += qi.y;
        q.z += qi.z;
        q.w += qi.w;
    }
    const float4 s = block_sum4<SAMPLE_BLOCK>(q);
    if (threadIdx.x == 0) {
        partial[blockIdx.x] = s;
        __threadfence();   // the partial is seen by the block that counts last
        last = atomicAdd(done, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += SAMPLE_BLOCK) {
        const float4 p = __ldcg(partial + b);
        t.x += p.x;
        t.y += p.y;
        t.z += p.z;
        t.w += p.w;
    }
    t = block_sum4<SAMPLE_BLOCK>(t);
    if (threadIdx.x != 0) return;
    g_rot[0] = t.x;
    g_rot[1] = t.y;
    g_rot[2] = t.z;
    g_rot[3] = t.w;
    *done = 0u;
}

// ---------------------------------------------------------------------------
// P0T: the row gather's backward, out[clamp(idx[i]), c] += g[i, c]
// ---------------------------------------------------------------------------

constexpr int SCATTER_BLOCK = 256;           // P0T's threads a block
constexpr int SCATTER_WARPS = SCATTER_BLOCK / 32;
constexpr int SCATTER_COLS = 8;              // the columns a warp's groups sum at once
constexpr int SCATTER_SMEM_WORDS = 12288;    // 48 KB: the most P0T sums in shared memory

// Where P0T sums a table of rows x cols words: in a copy per warp of the
// block in shared memory (SCATTER_WARPS) where they fit `limit_words`
// (SCATTER_SMEM_WORDS on the card), else in one copy for the block (1)
// where that fits, else in the table (0).
inline int scatter_copies(long long rows, int cols, long long limit_words) {
    const long long words = rows * cols;
    return words * SCATTER_WARPS <= limit_words ? SCATTER_WARPS : words <= limit_words ? 1 : 0;
}

// P0T over the block's chunk of lanes [blockIdx.x chunk, + chunk), a thread
// a lane: the warp's lanes of one row (idx clamped to [0, rows); group_of,
// once a lane) sum their cotangent rows SCATTER_COLS columns at a time
// (group_add; columns where the warp's lanes are all zero skipped), and
// each group's first lane adds the sums into the warp's own copy of the
// table in shared memory (COPIES SCATTER_WARPS: no other thread writes
// those words then, so plain adds) or the block's copy (COPIES 1: atomics);
// the copies (`acc`, COPIES rows x cols words, zeroed here) are summed at
// the end and their nonzero words added to the table. On the global path
// (COPIES 0) the warp reads its lanes' 8 columns through a stage in shared
// memory, 4 rows' 32 bytes at a time (a lane's own 8 loads would each
// touch 32 rows), and the groups' sums go back to the stage, from which the
// warp adds them to the table together, a row's columns after another's
// (a leader's own adds would each cover one column of 32 rows). Every
// thread calls it.
template <int COPIES>
__device__ __forceinline__ void row_scatter_lanes(const float* g, const int* idx, int n, int cols,
                                                  int rows, float* out, int chunk, float* acc) {
    constexpr int S = SCATTER_COLS + 1;   // a staged lane's stride: no bank conflicts
    __shared__ float stage[COPIES == 0 ? SCATTER_WARPS : 1][32 * S];
    const int lane = static_cast<int>(threadIdx.x & 31u);
    float* st = stage[COPIES == 0 ? threadIdx.x >> 5 : 0];
    const long long words = static_cast<long long>(rows) * cols;
    float* sink = out;
    if (COPIES > 0) {
        for (long long k = threadIdx.x; k < words * COPIES; k += SCATTER_BLOCK) acc[k] = 0.f;
        sink = acc + (COPIES == 1 ? 0 : (threadIdx.x >> 5) * words);
        __syncthreads();
    }
    const int start = blockIdx.x * chunk;
    const int end = min(n, start + chunk);
    for (int base = start; base < end; base += SCATTER_BLOCK) {
        const int i = base + static_cast<int>(threadIdx.x);
        const bool live = i < end;
        const int r = live ? min(max(__ldg(idx + i), 0), rows - 1) : 0;
        const float* gi = g + static_cast<long long>(live ? i : 0) * cols;
        const WarpGroup gr = group_of(live ? r : -1);
        const int first = i - lane, lanes = min(32, end - first);   // the warp's lanes
        for (int c0 = 0; c0 < cols; c0 += SCATTER_COLS) {
            float v[SCATTER_COLS];
            if (COPIES == 0) {   // the warp's 32 rows' 8 columns read 4 rows at a time
#pragma unroll
                for (int e = lane; e < 32 * SCATTER_COLS; e += 32) {
                    const int l = e / SCATTER_COLS, j = e - l * SCATTER_COLS;
                    st[l * S + j] = l < lanes && c0 + j < cols
                                        ? __ldg(g + static_cast<long long>(first + l) * cols + c0 + j)
                                        : 0.f;
                }
                __syncwarp();
            }
            bool any = false;
#pragma unroll
            for (int j = 0; j < SCATTER_COLS; ++j) {
                if (COPIES == 0)
                    v[j] = st[lane * S + j];
                else
                    v[j] = live && c0 + j < cols ? __ldg(gi + c0 + j) : 0.f;
                any = any || v[j] != 0.f;
            }
            if (COPIES == 0) __syncwarp();   // the stage read before the sums land in it
            if (!__any_sync(FULL_MASK, any)) continue;   // a render's rows are mostly zero
            const bool lead = group_add(gr, v);
            if (COPIES > 0) {
                if (lead) {
                    float* p = sink + static_cast<long long>(r) * cols + c0;
#pragma unroll
                    for (int j = 0; j < SCATTER_COLS; ++j) {
                        if (c0 + j >= cols || v[j] == 0.f) continue;
                        if (COPIES == SCATTER_WARPS)
                            p[j] += v[j];
                        else
                            atomicAdd(p + j, v[j]);
                    }
                }
                if (COPIES == SCATTER_WARPS) __syncwarp();   // the adds seen by the next group
                continue;
            }
#pragma unroll
            for (int j = 0; j < SCATTER_COLS; ++j) st[lane * S + j] = lead ? v[j] : 0.f;
            __syncwarp();
#pragma unroll
            for (int e = lane; e < 32 * SCATTER_COLS; e += 32) {   // lane l's column j
                const int l = e / SCATTER_COLS, j = e - l * SCATTER_COLS;
                const int rl = __shfl_sync(FULL_MASK, r, l);
                const float sum = st[l * S + j];
                if (sum != 0.f) atomicAdd(out + static_cast<long long>(rl) * cols + c0 + j, sum);
            }
            __syncwarp();   // the stage read before the next columns land in it
        }
    }
    if (COPIES > 0) {
        __syncthreads();
        for (long long k = threadIdx.x; k < words; k += SCATTER_BLOCK) {
            float s = acc[k];
            for (int w = 1; w < COPIES; ++w) s += acc[w * words + k];
            if (s != 0.f) atomicAdd(out + k, s);
        }
    }
}

// ---------------------------------------------------------------------------
// K7T: the backward of K7 (rgl_common.cuh eval_lane / sample_lane; the
// JAX package's rgl_eval :633 and rgl_sample :650, as materials/rgl.py
// rgl_eval_plain / rgl_sample_plain follow them), one lane at a time in
// rgl_bwd_lane<SAMPLE, FULL>, over a block's chunk of lanes in
// rgl_bwd_lanes<SAMPLE, FULL, SHARED>. K7's forward is recomputed with the
// functions of rgl_common.cuh. Searches are discrete: a cotangent lands only
// on the entries read at the cell the forward found. The lane leaves its
// table terms to the block function in RglTerms, a few cells each, before
// its parameter corners' weights (a lane reads each table at one cell of up
// to four (phi_i, theta_i) corners): the block function weights them per
// corner, sums them over the warp's lanes that add to the same corner and
// cell (group_sum) and adds each group's sums, into the block's copy of the
// tables in shared memory where they fit, else into the tables.
//   The tail form (FULL false), where only rgb, ndf and sigma are on the
// tape: the forward up to the warp positions and the half vector, then
// fr_common's backward from the cotangent of f*cos,
//   f_c = max(bilinear(rgb_c), 0) * ndf(u_wm) / max(4 sigma(u_wi), 1e-12),
// into rgb's param-bilinear x spatial-bilinear cells and ndf's and sigma's
// bilinear cells.
//   The full form (FULL true) runs reverse mode by hand through the whole
// forward, from the cotangents of f*cos, the pdf and sample's wo: the
// parameter weights in theta_i and phi_i (_param_weights :338) and wi's
// angles, the warps' bilinear density (_Warp2.eval :413), the inversion
// (:429-458: the cond row pair and the marginal value at the found cell),
// the sampling (:459-505: the marginal and cond rows' values at the found
// cell, both quadratic inversions), _u_wm, _fr_common (the tail's terms and
// those of the positions and corner weights) and _jacobian (:609-632), the
// half vector and the sampled direction; the lane's wi (and eval's wo)
// cotangents are written.
// ---------------------------------------------------------------------------

}  // namespace wpt_bwd

// At file scope, as RglTables: the C entry takes it (materials/rgl.py
// _CGrads, field for field). The tables' cotangents in RglTables' order,
// zeroed before the launch and scatter-added, then the lanes' direction
// cotangents [N, 3], written (wo: eval's; the tail form writes rgb, ndf and
// sigma only).
struct RglOut {
    float *phi_i, *theta_i, *ndf, *sigma, *vndf_data, *vndf_marg, *vndf_cond, *lum_data,
        *lum_marg, *lum_cond, *rgb, *wi, *wo;
};

namespace wpt_bwd {

constexpr int RGL_BLOCK = 256;           // K7T's threads a block
constexpr int RGL_SMEM_WORDS = 12288;    // 48 KB: the largest tables summed in shared memory
constexpr int RGL_TABLES = 11;           // RglOut's tables, phi_i .. rgb

// The words of each of RglOut's tables (phi_i .. rgb, RglTables' order)
// that the form's cotangents fill: the full form every one, the tail form
// ndf, sigma and rgb (the others 0). Returns their sum.
__host__ __device__ inline long long rgl_table_words(const RglTables& t, bool full,
                                                     long long* words) {
    const long long s = static_cast<long long>(t.M) * t.P * t.T;
    const long long all[RGL_TABLES] = {
        static_cast<long long>(t.M) * t.P, static_cast<long long>(t.M) * t.T,
        static_cast<long long>(t.M) * t.Hn * t.Wn, static_cast<long long>(t.M) * t.Hs * t.Ws,
        s * t.Hv * t.Wv, s * t.Hv, s * t.Hv * t.Wv, s * t.Hl * t.Wl, s * t.Hl, s * t.Hl * t.Wl,
        s * 4 * t.Hl * t.Wl};
    long long sum = 0;
    for (int k = 0; k < RGL_TABLES; ++k) {
        words[k] = full || k == 2 || k == 3 || k == 10 ? all[k] : 0;
        sum += words[k];
    }
    return sum;
}

// Whether K7T sums the form's tables in shared memory: where they fit
// `limit_words` (RGL_SMEM_WORDS on the card).
inline bool rgl_takes_shared(const RglTables& t, bool full, long long limit_words) {
    long long words[RGL_TABLES];
    return rgl_table_words(t, full, words) <= limit_words;
}

// The cotangents a lane gathers on its parameter frame: of the corner
// weights (cw) and of the incident angles.
struct FrameBwd {
    float cw[4];
    float phi_i, theta_i;
};

// One lane's table terms, before its corners' weights (rgl_bwd_lanes
// weights them per corner of the lane's Frame). A cell below 0: no terms.
//   rgb: fr_common's luminance-warp cell y0 Wl + x0, its four channels'
// taps (00, 10, 01, 11) channel by channel; ndf, sig: eval0's cell y0 W +
// x0 of the material's plane, its taps.
//   The full form also: lum, vndf: the warp's cell row W + col (eval's
// luminance warp: fr_common's cell), its data taps (00, 10, 01, 11), cond
// at (row, col), (row + 1, col), (row, w - 1) and (row + 1, w - 1), marg
// at row (WARP_* below); phi, theta: param_weights' interval i0 of the
// material's grid, the terms of its entries i0 and i1.
struct RglTerms {
    int rgb_cell, ndf_cell, sig_cell, lum_cell, vndf_cell, phi_i0, theta_i0;
    float rgb[16], ndf[4], sig[4], lum[9], vndf[9], phi[2], theta[2];
};
enum { WARP_D00, WARP_D10, WARP_D01, WARP_D11, WARP_C0, WARP_C1, WARP_R0, WARP_R1, WARP_M };

__device__ __forceinline__ void clear_terms(RglTerms& tm) {
    tm.rgb_cell = tm.ndf_cell = tm.sig_cell = tm.lum_cell = tm.vndf_cell = -1;
    tm.phi_i0 = tm.theta_i0 = -1;
#pragma unroll
    for (int j = 0; j < 16; ++j) tm.rgb[j] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) tm.ndf[j] = tm.sig[j] = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j) tm.lum[j] = tm.vndf[j] = 0.f;
    tm.phi[0] = tm.phi[1] = tm.theta[0] = tm.theta[1] = 0.f;
}

// A param-bilinear read's backward (gsum): its cotangent g into the lane's
// term tv and, with CW, g times each corner's entry into that corner
// weight's cotangent.
template <bool CW = true>
__device__ __forceinline__ void gsum_bwd(const wpt_rgl::Frame& fr, const float* arr, int stride,
                                         int off, float g, float& tv, FrameBwd& b) {
    tv += g;
    if constexpr (CW) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (k < fr.nc)
                b.cw[k] += g * wpt_rgl::ld(arr + static_cast<long long>(fr.slice[k]) * stride + off);
    }
}
__device__ __forceinline__ void gd_bwd(const wpt_rgl::Frame& fr, const wpt_rgl::Warp& wp, int y,
                                       int x, float g, float& tv, FrameBwd& b) {
    gsum_bwd(fr, wp.data, wp.H * wp.W, y * wp.W + x, g, tv, b);
}
__device__ __forceinline__ void gc_bwd(const wpt_rgl::Frame& fr, const wpt_rgl::Warp& wp, int y,
                                       int x, float g, float& tv, FrameBwd& b) {
    gsum_bwd(fr, wp.cond, wp.H * wp.W, y * wp.W + x, g, tv, b);
}
__device__ __forceinline__ void gm_bwd(const wpt_rgl::Frame& fr, const wpt_rgl::Warp& wp, int y,
                                       float g, float& tv, FrameBwd& b) {
    gsum_bwd(fr, wp.marg, wp.H, y, g, tv, b);
}

// The backward of (1 - sy) ((1 - sx) v00 + sx v10) + sy ((1 - sx) v01 + sx v11):
// the taps' cotangents into gv[4] (v00, v10, v01, v11) and sx's, sy's added.
__device__ __forceinline__ void bilerp_bwd(float v00, float v10, float v01, float v11, float sx,
                                           float sy, float g, float gv[4], float& g_sx,
                                           float& g_sy) {
    gv[0] = g * ((1.f - sy) * (1.f - sx));
    gv[1] = g * ((1.f - sy) * sx);
    gv[2] = g * (sy * (1.f - sx));
    gv[3] = g * (sy * sx);
    g_sx += g * ((1.f - sy) * (v10 - v00) + sy * (v11 - v01));
    g_sy += g * (((1.f - sx) * v01 + sx * v11) - ((1.f - sx) * v00 + sx * v10));
}

// Cotangent of d from that g of elevation(d) = 2 asin(clamp(|d - z|/2, -1, 1)).
__device__ __forceinline__ V3 elevation_bwd(wpt_rgl::Vec3 d, float g) {
    const float dz = d.z - 1.f;
    const float s = sqrtf(d.x * d.x + d.y * d.y + dz * dz);
    const float c = 0.5f * s;
    if (g == 0.f || !(c >= -1.f && c <= 1.f)) return {0.f, 0.f, 0.f};
    const float g_s = 0.5f * (g * 2.f / sqrtf(1.f - c * c));
    return {g_s * d.x / s, g_s * d.y / s, g_s * dz / s};
}

// Cotangents of (x, y) from that g of atan2(y, x), as (x, y, 0).
__device__ __forceinline__ V3 atan2_bwd(float y, float x, float g) {
    if (g == 0.f) return {0.f, 0.f, 0.f};
    const float r = x * x + y * y;
    return {-g * y / r, g * x / r, 0.f};
}

// Cotangent of theta from that g of theta2u(theta) = sqrt(max(theta, 0) 2 / pi) = u.
__device__ __forceinline__ float theta2u_bwd(float theta, float u, float g) {
    return (g != 0.f && theta >= 0.f) ? g / (2.f * u) * wpt_rgl::TWO_OVER_PI_F : 0.f;
}

// Cotangent of param_weights' w1 (g) into the terms of the row's entries
// i0 and i1 (tv[0], tv[1]; the interval into *i0) and, returned, into x.
__device__ __forceinline__ float param_weights_bwd(const float* row, int n, float x, float g,
                                                   int* i0_out, float tv[2]) {
    if (n <= 1 || g == 0.f) return 0.f;
    int cnt = 0;
    for (int j = 0; j < n; ++j) cnt += wpt_rgl::ld(row + j) <= x;
    const int i0 = wpt_rgl::clip_count(cnt, n), i1 = min(i0 + 1, max(n - 1, 0));
    const float p0 = wpt_rgl::ld(row + i0), p1 = wpt_rgl::ld(row + i1);
    const bool same = p1 == p0;
    const float den = same ? 1.f : p1 - p0;
    const float q = (x - p0) / den;
    if (!(q >= 0.f && q <= 1.f)) return 0.f;   // clamp passes inside [0, 1]
    const float g_num = g / den;
    *i0_out = i0;
    tv[0] -= g_num;
    if (!same) {
        const float g_den = -g * q / den;
        tv[1] += g_den;
        tv[0] -= g_den;
    }
    return g_num;
}

// Cotangent of eval0's bilinear value (g) into the terms of its raw [H, W]
// plane's four taps (tv, the cell into *cell) and, with FULL, into the
// position (px, py), added (clamped to [0, 1]: passes inside).
template <bool FULL>
__device__ __forceinline__ void eval0_bwd(const float* arr, const int* hw, int H, int W, int mid,
                                          float px, float py, float g, float& g_px, float& g_py,
                                          int* cell, float tv[4]) {
    if (g == 0.f) return;
    const int h = hw[2 * mid], w = hw[2 * mid + 1];
    const float fx = wpt_rgl::clampf(px, 0.f, 1.f) * static_cast<float>(w - 1);
    const float fy = wpt_rgl::clampf(py, 0.f, 1.f) * static_cast<float>(h - 1);
    const int x0 = wpt_rgl::clampi(static_cast<int>(fx), 0, w - 2);
    const int y0 = wpt_rgl::clampi(static_cast<int>(fy), 0, h - 2);
    const float sx = fx - static_cast<float>(x0), sy = fy - static_cast<float>(y0);
    // y0 <= h - 2 <= H - 2: the taps' rows y0 and y0 + 1
    const int offs[4] = {y0 * W + x0, y0 * W + x0 + 1, (y0 + 1) * W + x0, (y0 + 1) * W + x0 + 1};
    float v[4] = {0.f, 0.f, 0.f, 0.f};   // read only where the position's terms are
    if constexpr (FULL)
        for (int q = 0; q < 4; ++q) v[q] = wpt_rgl::ld(arr + mid * H * W + offs[q]);
    float gv[4], g_sx = 0.f, g_sy = 0.f;
    bilerp_bwd(v[0], v[1], v[2], v[3], sx, sy, g, gv, g_sx, g_sy);
    *cell = offs[0];
    for (int q = 0; q < 4; ++q) tv[q] += gv[q];
    if constexpr (FULL) {
        if (px >= 0.f && px <= 1.f) g_px += g_sx * static_cast<float>(w - 1);
        if (py >= 0.f && py <= 1.f) g_py += g_sy * static_cast<float>(h - 1);
    }
}
// warp_eval's backward: the density's cotangent g into the data taps' terms
// (tv, the cell into *cell) and the corner weights, and into the position,
// added to (g_px, g_py).
__device__ __forceinline__ void warp_eval_bwd(const wpt_rgl::Frame& fr, const wpt_rgl::Warp& wp,
                                              float px, float py, float g, float& g_px,
                                              float& g_py, FrameBwd& b, int* cell, float* tv) {
    if (g == 0.f) return;
    int x0, y0;
    float sx, sy;
    wpt_rgl::cell(wp, px, py, x0, y0, sx, sy);
    const int y1 = y0 + 1;   // y0 <= h - 2 <= H - 2
    const float v00 = wpt_rgl::gd(fr, wp, y0, x0), v10 = wpt_rgl::gd(fr, wp, y0, x0 + 1);
    const float v01 = wpt_rgl::gd(fr, wp, y1, x0), v11 = wpt_rgl::gd(fr, wp, y1, x0 + 1);
    float gv[4], g_sx = 0.f, g_sy = 0.f;
    bilerp_bwd(v00, v10, v01, v11, sx, sy, g * wpt_rgl::area(wp), gv, g_sx, g_sy);
    *cell = y0 * wp.W + x0;
    gd_bwd(fr, wp, y0, x0, gv[0], tv[WARP_D00], b);
    gd_bwd(fr, wp, y0, x0 + 1, gv[1], tv[WARP_D10], b);
    gd_bwd(fr, wp, y1, x0, gv[2], tv[WARP_D01], b);
    gd_bwd(fr, wp, y1, x0 + 1, gv[3], tv[WARP_D11], b);
    g_px += g_sx * static_cast<float>(wp.w - 1);
    g_py += g_sy * static_cast<float>(wp.h - 1);
}

// warp_invert's backward at the position (px, py): the cotangents of its
// outputs (g_ux, g_uy) and of its density g_pdf into the terms of the
// data, cond and marg entries read at the found cell (tv, the cell into
// *cell) and the corner weights, and into the position, added to (g_px,
// g_py).
__device__ __forceinline__ void warp_invert_bwd(const wpt_rgl::Frame& fr,
                                                const wpt_rgl::Warp& wp, float px, float py,
                                                float g_ux, float g_uy, float g_pdf, float& g_px,
                                                float& g_py, FrameBwd& b, int* cell, float* tv) {
    using namespace wpt_rgl;
    int x0, y0;
    float sx, sy;
    wpt_rgl::cell(wp, px, py, x0, y0, sx, sy);
    const int y1 = y0 + 1;   // y0 <= h - 2 <= H - 2
    const float v00 = gd(fr, wp, y0, x0), v10 = gd(fr, wp, y0, x0 + 1);
    const float v01 = gd(fr, wp, y1, x0), v11 = gd(fr, wp, y1, x0 + 1);
    const float c0 = (1.f - sy) * v00 + sy * v01;
    const float c1 = (1.f - sy) * v10 + sy * v11;
    const float k0 = gc(fr, wp, y0, x0), k1 = gc(fr, wp, y1, x0);
    const float x = sx * (c0 + 0.5f * sx * (c1 - c0)) + ((1.f - sy) * k0 + sy * k1);
    const int wlast = max(wp.w - 1, 0);
    const float r0 = gc(fr, wp, y0, wlast), r1 = gc(fr, wp, y1, wlast);
    const float dn_raw = (1.f - sy) * r0 + sy * r1;
    const float dn = clampminf(dn_raw, 1e-20f);
    *cell = y0 * wp.W + x0;
    // uy = sy (r0 + sy (r1 - r0) / 2) + marg(y0)
    float g_sx = 0.f;
    float g_sy = g_uy * ((r0 + 0.5f * sy * (r1 - r0)) + sy * 0.5f * (r1 - r0));
    float g_r0 = g_uy * sy * (1.f - 0.5f * sy), g_r1 = g_uy * sy * (0.5f * sy);
    gm_bwd(fr, wp, y0, g_uy, tv[WARP_M], b);
    // ux = x / max((1 - sy) r0 + sy r1, 1e-20)
    const float g_x = g_ux / dn;
    const float g_dn = dn_raw >= 1e-20f ? -g_ux * (x / dn) / dn : 0.f;
    g_r0 += g_dn * (1.f - sy);
    g_r1 += g_dn * sy;
    g_sy += g_dn * (r1 - r0);
    gc_bwd(fr, wp, y0, wlast, g_r0, tv[WARP_R0], b);
    gc_bwd(fr, wp, y1, wlast, g_r1, tv[WARP_R1], b);
    // x = sx (c0 + sx (c1 - c0) / 2) + (1 - sy) k0 + sy k1
    gc_bwd(fr, wp, y0, x0, g_x * (1.f - sy), tv[WARP_C0], b);
    gc_bwd(fr, wp, y1, x0, g_x * sy, tv[WARP_C1], b);
    g_sy += g_x * (k1 - k0);
    g_sx += g_x * (c0 + sx * (c1 - c0));
    float g_c0 = g_x * sx * (1.f - 0.5f * sx), g_c1 = g_x * sx * (0.5f * sx);
    // pdf = ((1 - sx) c0 + sx c1) area
    const float g_p = g_pdf * area(wp);
    g_c0 += g_p * (1.f - sx);
    g_c1 += g_p * sx;
    g_sx += g_p * (c1 - c0);
    // c0 = (1 - sy) v00 + sy v01, c1 = (1 - sy) v10 + sy v11
    gd_bwd(fr, wp, y0, x0, g_c0 * (1.f - sy), tv[WARP_D00], b);
    gd_bwd(fr, wp, y1, x0, g_c0 * sy, tv[WARP_D01], b);
    gd_bwd(fr, wp, y0, x0 + 1, g_c1 * (1.f - sy), tv[WARP_D10], b);
    gd_bwd(fr, wp, y1, x0 + 1, g_c1 * sy, tv[WARP_D11], b);
    g_sy += g_c0 * (v01 - v00) + g_c1 * (v11 - v10);
    g_px += g_sx * static_cast<float>(wp.w - 1);
    g_py += g_sy * static_cast<float>(wp.h - 1);
}

// The backward of a quadratic inversion t = 2 A / max(a + b, 1e-20) where
// |a - b| < 1e-4 (a + b), else (a - sqrt(max(a^2 - 2 A (a - b), 0))) / (a -
// b or 1): t's cotangent g into those of A, a and b, added. Where the root
// is real (D > 0) the derivative is taken through the same function's
// rationalized form, t = 2 A / (a + sqrt(D)): the formula itself cancels
// as a approaches b (at |a - b| ~ 1e-3 (a + b) its float32 derivative by
// the chain rule keeps no correct digit; the JAX package's autodiff and
// the plain version take it so), the rationalized form does not.
__device__ __forceinline__ void quad_inv_bwd(bool is_const, float A, float a, float b, float t,
                                             float g, float& g_A, float& g_a, float& g_b) {
    if (is_const) {
        const float den = wpt_rgl::clampminf(a + b, 1e-20f);
        g_A += g * 2.f / den;
        if (a + b >= 1e-20f) {
            const float g_den = -g * (t / den);
            g_a += g_den;
            g_b += g_den;
        }
        return;
    }
    const float D = a * a - 2.f * A * (a - b);
    if (D > 0.f) {
        const float disc = sqrtf(D);
        const float den = a + disc;
        const float g_den = -g * (t / den);
        g_A += g * 2.f / den;
        g_a += g_den;
        const float g_D = g_den / (2.f * disc);
        g_a += g_D * (2.f * a - 2.f * A);
        g_b += g_D * (2.f * A);
        g_A += g_D * (-2.f * (a - b));
        return;
    }
    // no real root: t = a / (a - b or 1), D clamped (no cotangent)
    const bool flat = a == b;
    const float den = flat ? 1.f : a - b;
    g_a += g / den;
    if (!flat) {
        const float g_den = -g * (t / den);
        g_a += g_den;
        g_b -= g_den;
    }
}

// warp_sample's backward from the uniforms (u0, u1) at the row and column
// its searches found (`found`): the cotangents of its position (g_px,
// g_py) and density g_pdf into the terms of the marg, cond and data entries
// read there (tv, the cell into *cell) and the corner weights, and into
// (u0, u1) (clamped: passes inside), added to (g_u0, g_u1).
__device__ __forceinline__ void warp_sample_bwd(const wpt_rgl::Frame& fr,
                                                const wpt_rgl::Warp& wp, float u0, float u1,
                                                const int found[2], float g_px, float g_py,
                                                float g_pdf, float& g_u0, float& g_u1,
                                                FrameBwd& b, int* cell, float* tv) {
    using namespace wpt_rgl;
    // the forward (rgl_common.cuh warp_sample) at the row and column its
    // searches found, its intermediates kept
    const float ux0 = clampf(u0, U_LO, U_HI), uy0 = clampf(u1, U_LO, U_HI);
    const int row = found[0], col = found[1];
    const float uy1 = uy0 - gm(fr, wp, row);
    const int row1 = row + 1;   // row <= h - 2 <= H - 2
    const int wlast = max(wp.w - 1, 0);
    const float r0 = gc(fr, wp, row, wlast), r1 = gc(fr, wp, row1, wlast);
    const bool is_const = fabsf(r0 - r1) < 1e-4f * (r0 + r1);
    const float disc = sqrtf(clampminf(r0 * r0 - 2.f * uy1 * (r0 - r1), 0.f));
    const float uy2 = is_const ? 2.f * uy1 / clampminf(r0 + r1, 1e-20f)
                               : (r0 - disc) / ((is_const || r0 == r1) ? 1.f : r0 - r1);
    const float L = (1.f - uy2) * r0 + uy2 * r1;
    const float ux1 = ux0 * L;
    const float q0 = gc(fr, wp, row, col), q1 = gc(fr, wp, row1, col);
    const float ux2 = ux1 - ((1.f - uy2) * q0 + uy2 * q1);
    const float v00 = gd(fr, wp, row, col), v10 = gd(fr, wp, row, col + 1);
    const float v01 = gd(fr, wp, row1, col), v11 = gd(fr, wp, row1, col + 1);
    const float c0 = (1.f - uy2) * v00 + uy2 * v01;
    const float c1 = (1.f - uy2) * v10 + uy2 * v11;
    const bool is_const2 = fabsf(c0 - c1) < 1e-4f * (c0 + c1);
    const float disc2 = sqrtf(clampminf(c0 * c0 - 2.f * ux2 * (c0 - c1), 0.f));
    const float ux3 = is_const2 ? 2.f * ux2 / clampminf(c0 + c1, 1e-20f)
                                : (c0 - disc2) / ((is_const2 || c0 == c1) ? 1.f : c0 - c1);
    *cell = row * wp.W + col;
    // reverse: pdf = ((1 - ux3) c0 + ux3 c1) area, px = (col + ux3) / (w - 1),
    // py = (row + uy2) / (h - 1)
    const float g_p = g_pdf * area(wp);
    float g_ux3 = g_px / static_cast<float>(wp.w - 1) + g_p * (c1 - c0);
    float g_c0 = g_p * (1.f - ux3), g_c1 = g_p * ux3;
    float g_uy2 = g_py / static_cast<float>(wp.h - 1);
    float g_ux2 = 0.f;
    quad_inv_bwd(is_const2, ux2, c0, c1, ux3, g_ux3, g_ux2, g_c0, g_c1);
    gd_bwd(fr, wp, row, col, g_c0 * (1.f - uy2), tv[WARP_D00], b);
    gd_bwd(fr, wp, row1, col, g_c0 * uy2, tv[WARP_D01], b);
    gd_bwd(fr, wp, row, col + 1, g_c1 * (1.f - uy2), tv[WARP_D10], b);
    gd_bwd(fr, wp, row1, col + 1, g_c1 * uy2, tv[WARP_D11], b);
    g_uy2 += g_c0 * (v01 - v00) + g_c1 * (v11 - v10);
    // ux2 = ux1 - ((1 - uy2) q0 + uy2 q1)
    gc_bwd(fr, wp, row, col, -g_ux2 * (1.f - uy2), tv[WARP_C0], b);
    gc_bwd(fr, wp, row1, col, -g_ux2 * uy2, tv[WARP_C1], b);
    g_uy2 -= g_ux2 * (q1 - q0);
    // ux1 = ux0 ((1 - uy2) r0 + uy2 r1)
    const float g_L = g_ux2 * ux0;
    float g_r0 = g_L * (1.f - uy2), g_r1 = g_L * uy2;
    g_uy2 += g_L * (r1 - r0);
    float g_uy1 = 0.f;
    quad_inv_bwd(is_const, uy1, r0, r1, uy2, g_uy2, g_uy1, g_r0, g_r1);
    gc_bwd(fr, wp, row, wlast, g_r0, tv[WARP_R0], b);
    gc_bwd(fr, wp, row1, wlast, g_r1, tv[WARP_R1], b);
    // uy1 = uy0 - marg(row)
    gm_bwd(fr, wp, row, -g_uy1, tv[WARP_M], b);
    if (u0 >= U_LO && u0 <= U_HI) g_u0 += g_ux2 * L;
    if (u1 >= U_LO && u1 <= U_HI) g_u1 += g_uy1;
}

// fr_common's backward at luminance-warp position (px, py) and half-vector
// position (uwm_x, uwm_y), for the cotangent g[4] of its f: into the terms
// of rgb's, ndf's and sigma's cells (tm) and, with FULL, into the
// cotangents of (px, py), of u_wm and of u_wi, added, and of the corner
// weights (b).
template <bool FULL>
__device__ __forceinline__ void fr_common_bwd(const RglTables& t, const wpt_rgl::Frame& fr,
                                              const wpt_rgl::Warp& lum, float px, float py,
                                              float uwm_x, float uwm_y, const float g[4],
                                              float& g_px, float& g_py, float& g_uwm_x,
                                              float& g_uwm_y, float& g_uwi_x, float& g_uwi_y,
                                              FrameBwd& b, RglTerms& tm) {
    if (g[0] == 0.f && g[1] == 0.f && g[2] == 0.f && g[3] == 0.f) return;
    int x0, y0;
    float sx, sy;
    wpt_rgl::cell(lum, px, py, x0, y0, sx, sy);
    const int y1 = y0 + 1;   // y0 <= h - 2 <= H - 2
    const int plane = lum.H * lum.W;
    const float ndf_v = wpt_rgl::eval0(t.ndf, t.ndf_hw, t.Hn, t.Wn, fr.mid, uwm_x, uwm_y);
    const float sig4 = 4.f * wpt_rgl::eval0(t.sigma, t.sigma_hw, t.Hs, t.Ws, fr.mid, fr.uwi_x,
                                            fr.uwi_y);
    const float denom = wpt_rgl::clampminf(sig4, 1e-12f);
    const float scale = ndf_v / denom;
    const int offs[4] = {y0 * lum.W + x0, y0 * lum.W + x0 + 1, y1 * lum.W + x0,
                         y1 * lum.W + x0 + 1};
    tm.rgb_cell = offs[0];
    float g_scale = 0.f, g_sx = 0.f, g_sy = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int base = c * plane;
        const float v00 = wpt_rgl::gsum(fr, t.rgb, 4 * plane, base + offs[0]);
        const float v10 = wpt_rgl::gsum(fr, t.rgb, 4 * plane, base + offs[1]);
        const float v01 = wpt_rgl::gsum(fr, t.rgb, 4 * plane, base + offs[2]);
        const float v11 = wpt_rgl::gsum(fr, t.rgb, 4 * plane, base + offs[3]);
        const float o = (1.f - sy) * ((1.f - sx) * v00 + sx * v10)
                        + sy * ((1.f - sx) * v01 + sx * v11);
        g_scale += g[c] * wpt_rgl::clampminf(o, 0.f);
        if (!(o >= 0.f) || g[c] == 0.f) continue;   // clamp_min passes where o >= 0
        float gv[4];
        bilerp_bwd(v00, v10, v01, v11, sx, sy, g[c] * scale, gv, g_sx, g_sy);
#pragma unroll
        for (int q = 0; q < 4; ++q)
            gsum_bwd<FULL>(fr, t.rgb, 4 * plane, base + offs[q], gv[q], tm.rgb[4 * c + q], b);
    }
    if constexpr (FULL) {
        g_px += g_sx * static_cast<float>(lum.w - 1);
        g_py += g_sy * static_cast<float>(lum.h - 1);
    }
    if (g_scale == 0.f) return;
    eval0_bwd<FULL>(t.ndf, t.ndf_hw, t.Hn, t.Wn, fr.mid, uwm_x, uwm_y, g_scale / denom, g_uwm_x,
                    g_uwm_y, &tm.ndf_cell, tm.ndf);
    if (sig4 >= 1e-12f)
        eval0_bwd<FULL>(t.sigma, t.sigma_hw, t.Hs, t.Ws, fr.mid, fr.uwi_x, fr.uwi_y,
                        -(g_scale * ndf_v / (denom * denom)) * 4.f, g_uwi_x, g_uwi_y,
                        &tm.sig_cell, tm.sig);
}
// jacobian's backward (J = max(2 pi^2 u_x sin theta_m, 1e-6) 4 (wi . wm)):
// the cotangent g_J into wi's, wm's and u_wm.x's, added.
__device__ __forceinline__ void jacobian_bwd(wpt_rgl::Vec3 wi, wpt_rgl::Vec3 wm, float uwm_x,
                                             float g_J, V3& g_wi, V3& g_wm, float& g_uwm_x) {
    if (g_J == 0.f) return;
    const float sin_tm = sqrtf(wm.x * wm.x + wm.y * wm.y);
    const float m_raw = wpt_rgl::TWO_PI2_F * uwm_x * sin_tm;
    const float m4 = wpt_rgl::clampminf(m_raw, 1e-6f) * 4.f;
    const float dd = wpt_rgl::dot3(wi, wm);
    const float g_dd = g_J * m4;
    g_wi = g_wi + g_dd * V3{wm.x, wm.y, wm.z};
    g_wm = g_wm + g_dd * V3{wi.x, wi.y, wi.z};
    if (m_raw >= 1e-6f) {
        const float g_m = g_J * dd * 4.f;
        g_uwm_x += g_m * sin_tm * wpt_rgl::TWO_PI2_F;
        const float g_s = g_m * (wpt_rgl::TWO_PI2_F * uwm_x);
        g_wm.x += g_s * wm.x / sin_tm;
        g_wm.y += g_s * wm.y / sin_tm;
    }
}

// prepare's backward: the corner weights' and the angles' cotangents (b,
// u_wi's) into the parameter grids' terms (tm) and wi's, added.
__device__ __forceinline__ void prepare_bwd(const RglTables& t, const wpt_rgl::Frame& fr,
                                            wpt_rgl::Vec3 wi, const FrameBwd& b, float g_uwi_x,
                                            float g_uwi_y, V3& g_wi, RglTerms& tm) {
    using namespace wpt_rgl;
    const int mid = fr.mid;
    const float theta_i = elevation(wi);
    float g_theta = b.theta_i + theta2u_bwd(theta_i, fr.uwi_x, g_uwi_x);
    float g_phi = b.phi_i + g_uwi_y * INV_TWO_PI_F;
    int pi, ti;
    float wp1, wt1;
    param_weights(t.phi_i + mid * t.P, t.n_phi[mid], fr.phi_i, pi, wp1);
    param_weights(t.theta_i + mid * t.T, t.n_theta[mid], theta_i, ti, wt1);
    const float wp0 = 1.f - wp1, wt0 = 1.f - wt1;
    float g_wp1 = 0.f, g_wt1 = 0.f;
    if (t.P == 1 && t.T == 1) {
    } else if (t.T == 1) {
        g_wp1 = b.cw[1] - b.cw[0];
    } else if (t.P == 1) {
        g_wt1 = b.cw[1] - b.cw[0];
    } else {
        g_wp1 = (b.cw[2] * wt0 + b.cw[3] * wt1) - (b.cw[0] * wt0 + b.cw[1] * wt1);
        g_wt1 = (b.cw[1] * wp0 + b.cw[3] * wp1) - (b.cw[0] * wp0 + b.cw[2] * wp1);
    }
    g_phi += param_weights_bwd(t.phi_i + mid * t.P, t.n_phi[mid], fr.phi_i, g_wp1, &tm.phi_i0,
                               tm.phi);
    g_theta += param_weights_bwd(t.theta_i + mid * t.T, t.n_theta[mid], theta_i, g_wt1,
                                 &tm.theta_i0, tm.theta);
    g_wi = g_wi + elevation_bwd(wi, g_theta) + atan2_bwd(wi.y, wi.x, g_phi);
}

// One lane of K7T: x is wo (eval) or the two uniforms (sample), g_f [4] the
// cotangent of the lane's f*cos. The lane's parameter frame goes to fr and
// its table terms to tm (both as the caller set them where the lane adds
// nothing). The tail form (FULL false) recomputes the forward up to its
// warp positions; a lane whose f the forward zeroed (below the surface, or
// a sample that is not ok) adds nothing, and g_pdf and g_wo are not read.
// The full form also takes g_pdf and (sample) g_wo [3], the cotangents of
// the lane's pdf and sampled direction, and writes the lane's wi cotangent
// (and eval's wo's) to out.wi + 3 i (out.wo + 3 i). The block function
// hands it only lanes that carry a cotangent (rgl_carries). The sample's
// backward reuses the rows and columns its forward's searches found.
template <bool SAMPLE, bool FULL>
__device__ __forceinline__ void rgl_bwd_lane(const RglTables& t, const RglOut& out, int i,
                                             int mid, wpt_rgl::Vec3 wi, const float* x,
                                             const float* g_f, float g_pdf, const float* g_wo,
                                             wpt_rgl::Frame& fr, RglTerms& tm) {
    using namespace wpt_rgl;
    const float g[4] = {g_f[0], g_f[1], g_f[2], g_f[3]};
    fr = prepare(t, mid, wi);
    const Warp lum = lum_warp(t, mid), vndf = vndf_warp(t, mid);
    FrameBwd b = {{0.f, 0.f, 0.f, 0.f}, 0.f, 0.f};
    V3 g_wi = {0.f, 0.f, 0.f}, g_wm = {0.f, 0.f, 0.f};
    float g_px = 0.f, g_py = 0.f, g_uwm_x = 0.f, g_uwm_y = 0.f, g_uwi_x = 0.f, g_uwi_y = 0.f;
    if constexpr (SAMPLE) {
        float px, py, uwm_x, uwm_y;
        int lum_rc[2], vndf_rc[2];
        const float lum_pdf = warp_sample(fr, lum, x[1], x[0], px, py, lum_rc);
        const float ndf_pdf = warp_sample(fr, vndf, px, py, uwm_x, uwm_y, vndf_rc);
        float phi_m = (2.f * uwm_y - 1.f) * PI_F;
        const float theta_m = uwm_x * uwm_x * HALF_PI_F;
        if (fr.iso) phi_m = phi_m + fr.phi_i;
        const float sin_t = sinf(theta_m), cos_t = cosf(theta_m);
        const float sin_p = sinf(phi_m), cos_p = cosf(phi_m);
        const Vec3 wm = {cos_p * sin_t, sin_p * sin_t, cos_t};
        const float d2 = 2.f * dot3(wm, wi);
        const bool valid = wi.z > 0.f && d2 * wm.z - wi.z > 0.f;
        float f[4];
        fr_common(t, fr, lum, px, py, uwm_x, uwm_y, f);
        const float J = jacobian(wi, wm, uwm_x);
        const float p = ndf_pdf * lum_pdf / J;
        bool finite = true;
        for (int c = 0; c < 4; ++c) finite = finite && isfinite(f[c]);
        const bool ok = valid && p > 0.f && finite;
        if constexpr (!FULL) {
            if (ok)
                fr_common_bwd<false>(t, fr, lum, px, py, uwm_x, uwm_y, g, g_px, g_py, g_uwm_x,
                                     g_uwm_y, g_uwi_x, g_uwi_y, b, tm);
            return;
        } else {
            float gf[4];
            for (int c = 0; c < 4; ++c) gf[c] = ok ? g[c] : 0.f;
            const float gp = ok ? g_pdf : 0.f;
            const float g_num = gp != 0.f ? gp / J : 0.f;   // J = 0 on lanes that are not ok
            const float g_ndf_pdf = g_num * lum_pdf, g_lum_pdf = g_num * ndf_pdf;
            jacobian_bwd(wi, wm, uwm_x, gp != 0.f ? -gp * (p / J) : 0.f, g_wi, g_wm, g_uwm_x);
            fr_common_bwd<true>(t, fr, lum, px, py, uwm_x, uwm_y, gf, g_px, g_py, g_uwm_x,
                                g_uwm_y, g_uwi_x, g_uwi_y, b, tm);
            // wo = 2 (wm . wi) wm - wi
            const V3 gwo = load3(g_wo);
            const float g_d2 = 2.f * (gwo.x * wm.x + gwo.y * wm.y + gwo.z * wm.z);
            g_wm = g_wm + d2 * gwo + g_d2 * V3{wi.x, wi.y, wi.z};
            g_wi = g_wi + g_d2 * V3{wm.x, wm.y, wm.z} - gwo;
            // wm from theta_m = u_x^2 pi / 2 and phi_m = (2 u_y - 1) pi (+ phi_i)
            const float g_theta =
                g_wm.x * (cos_p * cos_t) + g_wm.y * (sin_p * cos_t) - g_wm.z * sin_t;
            const float g_phi = -g_wm.x * (sin_p * sin_t) + g_wm.y * (cos_p * sin_t);
            g_uwm_x += g_theta * HALF_PI_F * 2.f * uwm_x;
            g_uwm_y += g_phi * PI_F * 2.f;
            if (fr.iso) b.phi_i += g_phi;
            warp_sample_bwd(fr, vndf, px, py, vndf_rc, g_uwm_x, g_uwm_y, g_ndf_pdf, g_px, g_py,
                            b, &tm.vndf_cell, tm.vndf);
            float g_u0 = 0.f, g_u1 = 0.f;   // the uniforms carry none
            warp_sample_bwd(fr, lum, x[1], x[0], lum_rc, g_px, g_py, g_lum_pdf, g_u0, g_u1, b,
                            &tm.lum_cell, tm.lum);
        }
    } else {
        const Vec3 wo = {x[0], x[1], x[2]};
        V3 g_wo_out = {0.f, 0.f, 0.f};
        if (wi.z > 0.f && wo.z > 0.f) {
            const V3 s = {wi.x + wo.x, wi.y + wo.y, wi.z + wo.z};
            const Vec3 wm = normalize3({s.x, s.y, s.z});
            const float theta_m = elevation(wm);
            const float phi_m = atan2f(wm.y, wm.x);
            const float um_y0 = phi2u(fr.iso ? phi_m - fr.phi_i : phi_m);
            const float uwm_x = theta2u(theta_m), uwm_y = um_y0 - floorf(um_y0);
            float px, py;
            const float vndf_pdf = warp_invert(fr, vndf, uwm_x, uwm_y, px, py);
            if constexpr (!FULL) {
                fr_common_bwd<false>(t, fr, lum, px, py, uwm_x, uwm_y, g, g_px, g_py, g_uwm_x,
                                     g_uwm_y, g_uwi_x, g_uwi_y, b, tm);
                return;
            } else {
                const float lum_pdf = warp_eval(fr, lum, px, py);
                const float J = jacobian(wi, wm, uwm_x);
                const float pdf_raw = vndf_pdf * lum_pdf / J;
                const float gp = pdf_raw >= 0.f ? g_pdf : 0.f;   // clamp_min passes where >= 0
                const float g_num = gp != 0.f ? gp / J : 0.f;
                jacobian_bwd(wi, wm, uwm_x, gp != 0.f ? -gp * (pdf_raw / J) : 0.f, g_wi, g_wm,
                             g_uwm_x);
                warp_eval_bwd(fr, lum, px, py, g_num * vndf_pdf, g_px, g_py, b, &tm.lum_cell,
                              tm.lum);
                fr_common_bwd<true>(t, fr, lum, px, py, uwm_x, uwm_y, g, g_px, g_py, g_uwm_x,
                                    g_uwm_y, g_uwi_x, g_uwi_y, b, tm);
                warp_invert_bwd(fr, vndf, uwm_x, uwm_y, g_px, g_py, g_num * lum_pdf, g_uwm_x,
                                g_uwm_y, b, &tm.vndf_cell, tm.vndf);
                // u_wm = (theta2u(theta_m), phi2u(phi_m - iso phi_i) mod 1)
                const float g_a = g_uwm_y * INV_TWO_PI_F;
                if (fr.iso) b.phi_i -= g_a;
                g_wm = g_wm + elevation_bwd(wm, theta2u_bwd(theta_m, uwm_x, g_uwm_x))
                       + atan2_bwd(wm.y, wm.x, g_a);
                // wm = normalize(wi + wo)
                const V3 g_s = normalize_bwd(s, g_wm);
                g_wi = g_wi + g_s;
                g_wo_out = g_s;
            }
        }
        if constexpr (FULL) store3(out.wo + 3 * i, g_wo_out);
    }
    if constexpr (FULL) {
        prepare_bwd(t, fr, wi, b, g_uwi_x, g_uwi_y, g_wi, tm);
        store3(out.wi + 3 * i, g_wi);
    }
}

// A cell's terms weighted by w into v, summed over the warp's lanes of the
// same key (group_sum; every thread of the warp calls it); true in the
// group's first lane, which then holds the sums.
template <int N>
__device__ __forceinline__ bool group_terms(int key, const float (&tv)[N], float w,
                                            float (&v)[N]) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = tv[j] * w;
    return group_sum(key, v);
}

// A warp's terms of one corner (slice s, weight w: v = tv w) summed over the
// warp's lanes of the same slice and cell, the group's sums added to the
// data taps, the cond entries and the marg entry (WARP_*) of the warp's
// tables in sk (data, marg, cond; [slices, H, W] and [slices, H]) at the
// cell row W + col, the material's last column wlast.
__device__ __forceinline__ void add_warp_terms(float* data, float* marg, float* cond, int H,
                                               int W, int wlast, int s, bool on, int cell,
                                               const float (&tv)[9], float w) {
    float v[9];
    const int key = on && cell >= 0 ? s * H * W + cell : -1;
    if (!group_terms(key, tv, w, v)) return;
    const int row = cell / W;
    add1(data + key, v[WARP_D00]);
    add1(data + key + 1, v[WARP_D10]);
    add1(data + key + W, v[WARP_D01]);
    add1(data + key + W + 1, v[WARP_D11]);
    add1(cond + key, v[WARP_C0]);
    add1(cond + key + W, v[WARP_C1]);
    const int last = s * H * W + row * W + wlast;
    add1(cond + last, v[WARP_R0]);
    add1(cond + last + W, v[WARP_R1]);
    add1(marg + s * H + row, v[WARP_M]);
}

// A lane's terms (tm, on its frame fr: nc 0 where it adds nothing), each
// cell's summed over the warp's lanes of the same corner slice (or
// material) and cell, added by each group's first lane to the tables of sk
// (the block's copy in shared memory, or the tables). Every thread of the
// warp calls it.
template <bool FULL>
__device__ __forceinline__ void add_rgl_terms(const RglTables& t, const RglOut& sk,
                                              const wpt_rgl::Frame& fr, const RglTerms& tm) {
    const int pl = t.Hl * t.Wl;
    const int mid = fr.nc > 0 ? fr.mid : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const bool on = k < fr.nc;
        const int s = on ? fr.slice[k] : 0;
        const float w = on ? fr.cw[k] : 0.f;
        float v[16];
        const int key = on && tm.rgb_cell >= 0 ? s * 4 * pl + tm.rgb_cell : -1;
        if (group_terms(key, tm.rgb, w, v)) {
            const int taps[4] = {0, 1, t.Wl, t.Wl + 1};
#pragma unroll
            for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int q = 0; q < 4; ++q) add1(sk.rgb + key + c * pl + taps[q], v[4 * c + q]);
        }
        if constexpr (FULL) {
            add_warp_terms(sk.lum_data, sk.lum_marg, sk.lum_cond, t.Hl, t.Wl,
                           t.lum_hw[2 * mid + 1] - 1, s, on, tm.lum_cell, tm.lum, w);
            add_warp_terms(sk.vndf_data, sk.vndf_marg, sk.vndf_cond, t.Hv, t.Wv,
                           t.vndf_hw[2 * mid + 1] - 1, s, on, tm.vndf_cell, tm.vndf, w);
        }
    }
    float v[4];
    int key = tm.ndf_cell >= 0 ? mid * t.Hn * t.Wn + tm.ndf_cell : -1;
    if (group_terms(key, tm.ndf, 1.f, v)) {
        add1(sk.ndf + key, v[0]);
        add1(sk.ndf + key + 1, v[1]);
        add1(sk.ndf + key + t.Wn, v[2]);
        add1(sk.ndf + key + t.Wn + 1, v[3]);
    }
    key = tm.sig_cell >= 0 ? mid * t.Hs * t.Ws + tm.sig_cell : -1;
    if (group_terms(key, tm.sig, 1.f, v)) {
        add1(sk.sigma + key, v[0]);
        add1(sk.sigma + key + 1, v[1]);
        add1(sk.sigma + key + t.Ws, v[2]);
        add1(sk.sigma + key + t.Ws + 1, v[3]);
    }
    if constexpr (FULL) {
        float p[2];
        key = tm.phi_i0 >= 0 ? mid * t.P + tm.phi_i0 : -1;
        if (group_terms(key, tm.phi, 1.f, p)) {
            add1(sk.phi_i + key, p[0]);
            add1(sk.phi_i + mid * t.P + min(tm.phi_i0 + 1, max(t.n_phi[mid] - 1, 0)), p[1]);
        }
        key = tm.theta_i0 >= 0 ? mid * t.T + tm.theta_i0 : -1;
        if (group_terms(key, tm.theta, 1.f, p)) {
            add1(sk.theta_i + key, p[0]);
            add1(sk.theta_i + mid * t.T + min(tm.theta_i0 + 1, max(t.n_theta[mid] - 1, 0)),
                 p[1]);
        }
    }
}

// The block's copy of the form's tables in shared memory: RglOut's tables
// (phi_i .. rgb) at their offsets in acc, `words` of each.
__device__ __forceinline__ RglOut shared_tables(float* acc, const long long* words) {
    RglOut s;
    float* p = acc;
    s.phi_i = p;
    s.theta_i = p += words[0];
    s.ndf = p += words[1];
    s.sigma = p += words[2];
    s.vndf_data = p += words[3];
    s.vndf_marg = p += words[4];
    s.vndf_cond = p += words[5];
    s.lum_data = p += words[6];
    s.lum_marg = p += words[7];
    s.lum_cond = p += words[8];
    s.rgb = p += words[9];
    s.wi = s.wo = nullptr;
    return s;
}

// Adds the block's nonzero sums src[0, n) to dst[0, n).
__device__ __forceinline__ void add_block_sums(const float* src, float* dst, long long n) {
    for (long long e = threadIdx.x; e < n; e += RGL_BLOCK) {
        const float s = src[e];
        if (s != 0.f) atomicAdd(dst + e, s);
    }
}

// Whether K7T's lane i carries a cotangent: of its f*cos or, in the full
// form, of its pdf or sample's wo. A lane that carries none adds nothing
// (every term is a product with a zero cotangent; the plain version takes
// such a lane so too) and, in the full form, has zero direction cotangents.
template <bool SAMPLE, bool FULL>
__device__ __forceinline__ bool rgl_carries(int i, const float* g_f, const float* g_pdf,
                                            const float* g_wo) {
    const float* g = g_f + 4 * i;
    bool carry = g[0] != 0.f || g[1] != 0.f || g[2] != 0.f || g[3] != 0.f;
    if (FULL) carry = carry || g_pdf[i] != 0.f;
    if (FULL && SAMPLE)
        carry = carry || g_wo[3 * i] != 0.f || g_wo[3 * i + 1] != 0.f || g_wo[3 * i + 2] != 0.f;
    return carry;
}

// K7T over the block's chunk of lanes [blockIdx.x chunk, + chunk): the
// lanes that carry a cotangent (rgl_carries) and an RGL material (a
// negative id: K7 wrote zeros, which take none; the full form writes the
// others' zero direction cotangents) queued in shared memory in lane
// order (a __ballot_sync / __popc prefix per warp), so that a round of the
// block's threads takes RGL_BLOCK of them (the rest at the chunk's end): a
// render's cotangents are sparse, and a warp with one such lane among 32
// would take a whole lane's time. Each queued lane's terms (rgl_bwd_lane)
// are summed over the warp's lanes of one corner and cell and added by
// each group's first lane (add_rgl_terms) into the block's copy of the
// form's tables in shared memory (SHARED: `acc`, rgl_table_words of them in
// RglOut's order, zeroed here and their nonzero words added to the tables
// at the end) or into the tables. The lanes' direction cotangents (FULL)
// are written to out. Every thread calls it.
template <bool SAMPLE, bool FULL, bool SHARED>
__device__ __forceinline__ void rgl_bwd_lanes(const RglTables& t, const RglOut& out,
                                              const int* mids, const float* wi, const float* x,
                                              int n, const float* g_f, const float* g_pdf,
                                              const float* g_wo, int chunk, float* acc) {
    __shared__ int s_lane[2 * RGL_BLOCK];     // the queue: at most a round and a scan's lanes
    __shared__ int s_count[RGL_BLOCK / 32];
    const int lane = static_cast<int>(threadIdx.x & 31u), warp = static_cast<int>(threadIdx.x >> 5);
    long long words[RGL_TABLES];
    const long long total = rgl_table_words(t, FULL, words);
    RglOut sk = out;
    if (SHARED) {
        for (long long k = threadIdx.x; k < total; k += RGL_BLOCK) acc[k] = 0.f;
        sk = shared_tables(acc, words);
        __syncthreads();
    }
    const int start = blockIdx.x * chunk;
    const int end = min(n, start + chunk);
    int queued = 0;   // the same in every thread
    for (int base = start; base < end || queued > 0; base += RGL_BLOCK) {
        if (base < end) {   // scan RGL_BLOCK lanes into the queue
            const int i = base + static_cast<int>(threadIdx.x);
            const bool carry =
                i < end && mids[i] >= 0 && rgl_carries<SAMPLE, FULL>(i, g_f, g_pdf, g_wo);
            if (FULL && i < end && !carry) {
                store3(out.wi + 3 * i, {0.f, 0.f, 0.f});
                if (!SAMPLE) store3(out.wo + 3 * i, {0.f, 0.f, 0.f});
            }
            const unsigned m = __ballot_sync(FULL_MASK, carry);
            if (lane == 0) s_count[warp] = __popc(m);
            __syncthreads();
            int pos = queued + __popc(m & ((1u << lane) - 1u)), scanned = 0;
            for (int w = 0; w < RGL_BLOCK / 32; ++w) {
                const int c = s_count[w];
                pos += w < warp ? c : 0;
                scanned += c;
            }
            if (carry) s_lane[pos] = i;
            queued += scanned;
            __syncthreads();
            if (queued < RGL_BLOCK && base + RGL_BLOCK < end) continue;   // a whole round first
        }
        const int take = min(queued, RGL_BLOCK);   // a round
        const int q = static_cast<int>(threadIdx.x) < take ? s_lane[threadIdx.x] : -1;
        wpt_rgl::Frame fr;
        fr.nc = 0;
        fr.mid = 0;
        RglTerms tm;
        clear_terms(tm);
        if (q >= 0) {
            const int mid = wpt_rgl::clampi(mids[q], 0, t.M - 1);
            rgl_bwd_lane<SAMPLE, FULL>(t, out, q, mid, {wi[3 * q], wi[3 * q + 1], wi[3 * q + 2]},
                                       x + (SAMPLE ? 2 : 3) * q, g_f + 4 * q,
                                       FULL ? g_pdf[q] : 0.f,
                                       SAMPLE && FULL ? g_wo + 3 * q : nullptr, fr, tm);
        }
        add_rgl_terms<FULL>(t, sk, fr, tm);
        __syncthreads();   // the round's lanes read before the rest of the queue moves up
        if (static_cast<int>(threadIdx.x) < queued - take)
            s_lane[threadIdx.x] = s_lane[take + threadIdx.x];
        queued -= take;
        __syncthreads();
    }
    if (SHARED) {
        add_block_sums(sk.phi_i, out.phi_i, words[0]);
        add_block_sums(sk.theta_i, out.theta_i, words[1]);
        add_block_sums(sk.ndf, out.ndf, words[2]);
        add_block_sums(sk.sigma, out.sigma, words[3]);
        add_block_sums(sk.vndf_data, out.vndf_data, words[4]);
        add_block_sums(sk.vndf_marg, out.vndf_marg, words[5]);
        add_block_sums(sk.vndf_cond, out.vndf_cond, words[6]);
        add_block_sums(sk.lum_data, out.lum_data, words[7]);
        add_block_sums(sk.lum_marg, out.lum_marg, words[8]);
        add_block_sums(sk.lum_cond, out.lum_cond, words[9]);
        add_block_sums(sk.rgb, out.rgb, words[10]);
    }
}

}  // namespace wpt_bwd
