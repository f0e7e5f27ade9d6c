// The per-lane arithmetic of K3T, K8T and K7T, the backward kernels of K3's
// hit assembly (with the winner's intersection), of K8's sky radiance and
// of K7's measured RGL BRDF (eval and sample).
// Included by backward.cu (the kernels) and, through tests/cuda_host, by
// the host build that runs it on the CPU.
//
// Each lane function follows the plain PyTorch version
// (wurblpt_tpu_torch/render/backward.py assemble_hit_bwd_plain,
// env_radiance_bwd_plain; K7T: autograd through materials/rgl.py's
// rgl_eval_plain / rgl_sample_plain) term by term; the scatter into the tables is an
// atomicAdd per nonzero term, so sums land in an order that varies from
// run to run (the checks hold them to a tolerance relative to the sum of
// the terms' magnitudes).
#pragma once

#include <cuda_runtime.h>

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

// K3T for lane i (render/backward.py assemble_hit_bwd_plain); ANIM: K3aT,
// the winner's hit in its animation's object space (o_s = r_inv (o -
// t_inv), d_s = r_inv d from the lane's row), its normals pushed to world
// by m_nrm and its tangent by m_fwd, each normalized: the world
// cotangents go back through both, the object-space backward runs on
// (o_s, d_s), and the row's cotangent is added into g_frames (atomically
// at one instant; the lane's own row under per-ray rows).
template <bool ANIM>
__device__ __forceinline__ void assemble_hit_bwd_lane(int i, const HitIn& in, const Tables& tb,
                                                      const Cot& c, const HitOut& out,
                                                      const AnimIn& an) {
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
    if (ANIM) {
        const int aid =
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
        float* gr = out.g_tri_f + static_cast<long>(ps) * TRI_F;
        add3(gr, w * g_nraw);
        add3(gr + 3, u * g_nraw);
        add3(gr + 6, v * g_nraw);
        add1(gr + 9, w * g_uu);
        add1(gr + 10, w * g_uvv);
        add1(gr + 11, u * g_uu);
        add1(gr + 12, u * g_uvv);
        add1(gr + 13, v * g_uu);
        add1(gr + 14, v * g_uvv);
        add3(gr + 15, w * g_traw);
        add3(gr + 18, u * g_traw);
        add3(gr + 21, v * g_traw);
        add3(gr + 24, g_go);
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
        float* gg = out.g_tri_g + static_cast<long>(ps) * TRI_G;
        add3(gg, lam);
        add3(gg + 3, u * lam);
        add3(gg + 6, v * lam);
    } else if (tb.n_spheres > 0) {
        if (hit) {   // |o + t d - c| = r
            const V3 q = pos_s - sc;
            const float s = g_tt / dot(q, ds);
            g_os = g_os - s * q;
            g_ds = g_ds - (s * t) * q;
            g_c = g_c + s * q;
            g_r = g_r + s * sr;
        }
        float* gs = out.g_sph_f + 4 * si;
        add3(gs, g_c);
        add1(gs + 3, g_r);
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
            for (int k = 0; k < FRAME; ++k) add1(gfr + k, grow[k]);
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

__device__ __forceinline__ void add4(float* p, const float* g, float s) {
    for (int k = 0; k < 4; ++k) add1(p + k, g[k] * s);
}

// The bilinear lookup's backward: taps i00 (1 - fx)(1 - fy), i01 fx (1 - fy),
// i10 (1 - fx) fy, i11 fx fy scatter-added into g_img; returns the
// cotangents of fx and fy.
__device__ __forceinline__ void bilinear_bwd(const float4* img, float* g_img, const float* g,
                                             int i00, int i01, int i10, int i11, float fx,
                                             float fy, float* g_fx, float* g_fy) {
    const float4 c00 = img[i00], c01 = img[i01], c10 = img[i10], c11 = img[i11];
    const float gx = 1.f - fx, gy = 1.f - fy;
    add4(g_img + 4 * i00, g, gx * gy);
    add4(g_img + 4 * i01, g, fx * gy);
    add4(g_img + 4 * i10, g, gx * fy);
    add4(g_img + 4 * i11, g, fx * fy);
    const float4 a = sub4(c01, c00), b = sub4(c11, c10);
    *g_fx = dot4(g, make_float4(a.x * gy + b.x * fy, a.y * gy + b.y * fy, a.z * gy + b.z * fy,
                                a.w * gy + b.w * fy));
    *g_fy = dot4(g, sub4(lerp4(c10, c11, fx), lerp4(c00, c01, fx)));
}

// K8T for lane i of an equirect (kind 1) or cube (kind 2) map
// (render/backward.py env_radiance_bwd_plain): the texels' cotangents
// scatter-added into g_img, the direction's written to g_d.
__device__ __forceinline__ void env_radiance_bwd_lane(int i, const float* d, int kind,
                                                      const float4* img, int h, int w,
                                                      const float* rot, const float* g,
                                                      float* g_d, float* g_img) {
    const float* gi = g + 4 * i;
    const V3 dm = quat_rotate(-rot[0], -rot[1], -rot[2], rot[3], load3(d + 3 * i));
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
        bilinear_bwd(img, g_img, gi, y0i * w + x0i, y0i * w + x1i, y1i * w + x0i, y1i * w + x1i,
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
        bilinear_bwd(img, g_img, gi, f + y0 * w + x0, f + y0 * w + x1, f + y1 * w + x0,
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
}

// ---------------------------------------------------------------------------
// K7T: the backward of K7 (rgl_common.cuh eval_lane / sample_lane) into the
// tables its reflectance tail reads, fr_common's
//   f_c = max(bilinear(rgb_c), 0) * ndf(u_wm) / max(4 sigma(u_wi), 1e-12):
// rgb's param-bilinear x spatial-bilinear cells, ndf's and sigma's bilinear
// cells. The warp positions and the half vector are recomputed as the
// forward lane computes them (the same functions of rgl_common.cuh); the
// warp tables (vndf_*, lum_*) and the directions carry no cotangent here
// (the wrapper refuses them where they require grad).
// ---------------------------------------------------------------------------

struct RglGrads {
    float* rgb;     // like RglTables::rgb
    float* ndf;
    float* sigma;
};

// Cotangent g of a bilinear blend of a raw [H, W] plane into its four cells
// (eval0's weights, its clamped position).
__device__ __forceinline__ void eval0_bwd(float* g_arr, const int* hw, int H, int W, int mid,
                                          float px, float py, float g) {
    const int h = hw[2 * mid], w = hw[2 * mid + 1];
    const float fx = wpt_rgl::clampf(px, 0.f, 1.f) * static_cast<float>(w - 1);
    const float fy = wpt_rgl::clampf(py, 0.f, 1.f) * static_cast<float>(h - 1);
    const int x0 = wpt_rgl::clampi(static_cast<int>(fx), 0, w - 2);
    const int y0 = wpt_rgl::clampi(static_cast<int>(fy), 0, h - 2);
    const float sx = fx - static_cast<float>(x0), sy = fy - static_cast<float>(y0);
    const int y1 = min(y0 + 1, H - 1);
    float* a = g_arr + mid * H * W;
    add1(a + y0 * W + x0, g * ((1.f - sy) * (1.f - sx)));
    add1(a + y0 * W + x0 + 1, g * ((1.f - sy) * sx));
    add1(a + y1 * W + x0, g * (sy * (1.f - sx)));
    add1(a + y1 * W + x0 + 1, g * (sy * sx));
}

// fr_common's backward at luminance-warp position (px, py) and half-vector
// position (uwm_x, uwm_y), for the cotangent g[4] of its f.
__device__ __forceinline__ void fr_common_bwd(const RglTables& t, const wpt_rgl::Frame& fr,
                                              const wpt_rgl::Warp& lum, float px, float py,
                                              float uwm_x, float uwm_y, const float g[4],
                                              RglGrads out) {
    int x0, y0;
    float sx, sy;
    wpt_rgl::cell(lum, px, py, x0, y0, sx, sy);
    const int y1 = min(y0 + 1, lum.H - 1);
    const int plane = lum.H * lum.W;
    const float ndf_v = wpt_rgl::eval0(t.ndf, t.ndf_hw, t.Hn, t.Wn, fr.mid, uwm_x, uwm_y);
    const float sig4 = 4.f * wpt_rgl::eval0(t.sigma, t.sigma_hw, t.Hs, t.Ws, fr.mid, fr.uwi_x,
                                            fr.uwi_y);
    const float denom = wpt_rgl::clampminf(sig4, 1e-12f);
    const float scale = ndf_v / denom;
    const int offs[4] = {y0 * lum.W + x0, y0 * lum.W + x0 + 1, y1 * lum.W + x0,
                         y1 * lum.W + x0 + 1};
    const float ws[4] = {(1.f - sy) * (1.f - sx), (1.f - sy) * sx, sy * (1.f - sx), sy * sx};
    float g_scale = 0.f;
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
        const float gv = g[c] * scale;
        for (int k = 0; k < 4; ++k) {
            if (k >= fr.nc) break;
            float* slice = out.rgb + static_cast<long long>(fr.slice[k]) * 4 * plane + base;
            const float gk = gv * fr.cw[k];
            for (int q = 0; q < 4; ++q) add1(slice + offs[q], gk * ws[q]);
        }
    }
    if (g_scale == 0.f) return;
    eval0_bwd(out.ndf, t.ndf_hw, t.Hn, t.Wn, fr.mid, uwm_x, uwm_y, g_scale / denom);
    if (sig4 >= 1e-12f)
        eval0_bwd(out.sigma, t.sigma_hw, t.Hs, t.Ws, fr.mid, fr.uwi_x, fr.uwi_y,
                  -(g_scale * ndf_v / (denom * denom)) * 4.f);
}

// One lane of K7T: x is wo (eval) or the two uniforms (sample), g_f the
// cotangent [4] of the lane's f*cos. The lane's forward (eval_lane or
// sample_lane) is recomputed up to its warp positions; a lane whose f the
// forward zeroed (below the surface, or a sample that is not ok) adds nothing.
template <bool SAMPLE>
__device__ __forceinline__ void rgl_bwd_lane(const RglTables& t, int mid, wpt_rgl::Vec3 wi,
                                             const float* x, const float* g_f, RglGrads out) {
    using namespace wpt_rgl;
    const float g[4] = {g_f[0], g_f[1], g_f[2], g_f[3]};
    if (g[0] == 0.f && g[1] == 0.f && g[2] == 0.f && g[3] == 0.f) return;
    const Frame fr = prepare(t, mid, wi);
    const Warp lum = lum_warp(t, mid);
    float px, py, uwm_x, uwm_y;
    if (SAMPLE) {
        const float lum_pdf = warp_sample(fr, lum, x[1], x[0], px, py);
        const float ndf_pdf = warp_sample(fr, vndf_warp(t, mid), px, py, uwm_x, uwm_y);
        float phi_m = (2.f * uwm_y - 1.f) * PI_F;
        const float theta_m = uwm_x * uwm_x * HALF_PI_F;
        if (fr.iso) phi_m = phi_m + fr.phi_i;
        const float sin_t = sinf(theta_m), cos_t = cosf(theta_m);
        const Vec3 wm = {cosf(phi_m) * sin_t, sinf(phi_m) * sin_t, cos_t};
        const float d2 = 2.f * dot3(wm, wi);
        const bool valid = wi.z > 0.f && d2 * wm.z - wi.z > 0.f;
        float f[4];
        fr_common(t, fr, lum, px, py, uwm_x, uwm_y, f);
        const float p = ndf_pdf * lum_pdf / jacobian(wi, wm, uwm_x);
        bool finite = true;
        for (int c = 0; c < 4; ++c) finite = finite && isfinite(f[c]);
        if (!(valid && p > 0.f && finite)) return;
    } else {
        const Vec3 wo = {x[0], x[1], x[2]};
        if (!(wi.z > 0.f && wo.z > 0.f)) return;
        const Vec3 wm = normalize3({wi.x + wo.x, wi.y + wo.y, wi.z + wo.z});
        const float phi_m = atan2f(wm.y, wm.x);
        const float um_y0 = phi2u(fr.iso ? phi_m - fr.phi_i : phi_m);
        uwm_x = theta2u(elevation(wm));
        uwm_y = um_y0 - floorf(um_y0);
        warp_invert(fr, vndf_warp(t, mid), uwm_x, uwm_y, px, py);
    }
    fr_common_bwd(t, fr, lum, px, py, uwm_x, uwm_y, g, out);
}

}  // namespace wpt_bwd
