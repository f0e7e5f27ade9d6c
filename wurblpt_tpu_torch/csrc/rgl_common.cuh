// K7's arithmetic for one lane: the measured RGL BRDF's parameter frame,
// the Marginal2D warps (eval, invert, sample), the reflectance tail and the
// jacobian, and one lane of eval and of sample. Included by rgl.cu (K7's
// stand-alone kernels) and wavefront.cu (K4's lit shade, which evaluates and
// samples RGL lanes inline), so there is one copy of it.
//
// Row searches count over a row masked by the material's actual width, as
// the JAX package's _search_row does (never a bisection), so kernel, plain
// version and JAX take the same interval on every input, flat CDF runs
// included. Every expression follows the plain PyTorch version
// (wurblpt_tpu_torch/materials/rgl.py) in the same order; the including
// source is built with -fmad=false and without --use_fast_math.
//
// Every function is inlined and every loop over a lane's (phi_i, theta_i)
// corners runs over the four slots with constant indices, so no per-lane
// array is indexed at run time and none lands in local memory.
#pragma once

#include <cuda_runtime.h>

// At file scope: rgl.cu's C entry points take it, so it must have external
// linkage.
struct RglTables {              // RGLTables of materials/rgl.py, field for field
    const float* phi_i;         // [M, P]
    const float* theta_i;       // [M, T]
    const int* n_phi;           // [M]
    const int* n_theta;         // [M]
    const float* ndf;           // [M, Hn, Wn]
    const float* sigma;         // [M, Hs, Ws]
    const int* ndf_hw;          // [M, 2]
    const int* sigma_hw;        // [M, 2]
    const float* vndf_data;     // [M, P, T, Hv, Wv]
    const float* vndf_marg;     // [M, P, T, Hv]
    const float* vndf_cond;     // [M, P, T, Hv, Wv]
    const int* vndf_hw;         // [M, 2]
    const float* lum_data;      // [M, P, T, Hl, Wl]
    const float* lum_marg;      // [M, P, T, Hl]
    const float* lum_cond;      // [M, P, T, Hl, Wl]
    const int* lum_hw;          // [M, 2]
    const float* rgb;           // [M, P, T, 4, Hl, Wl]
    const int* isotropic;       // [M]
    int M, P, T, Hn, Wn, Hs, Ws, Hv, Wv, Hl, Wl;
};

namespace wpt_rgl {

constexpr double PI_D = 3.14159265358979323846;
constexpr float PI_F = static_cast<float>(PI_D);
constexpr float INV_TWO_PI_F = 0x1.45f306p-3f;   // float32(1) / float32(2 pi), as XLA divides
constexpr float HALF_PI_F = static_cast<float>(PI_D / 2.0);
constexpr float TWO_OVER_PI_F = static_cast<float>(2.0 / PI_D);
constexpr float TWO_PI2_F = static_cast<float>(2.0 * PI_D * PI_D);
constexpr float U_LO = static_cast<float>(1.0 - 0.999999940395355225);
constexpr float U_HI = static_cast<float>(0.999999940395355225);

// PyTorch's clamp / clamp_min: NaN passes through.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clampminf(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

struct Vec3 { float x, y, z; };

__device__ __forceinline__ float dot3(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ Vec3 normalize3(Vec3 a) {
    const float r = 1.f / sqrtf(clampminf(dot3(a, a), 1e-20f));
    return {a.x * r, a.y * r, a.z * r};
}

// Robust acos(d.z) (powitacq_rgb.inl:1016-1018).
__device__ __forceinline__ float elevation(Vec3 d) {
    const float dz = d.z - 1.f;
    return 2.f * asinf(clampf(0.5f * sqrtf(d.x * d.x + d.y * d.y + dz * dz), -1.f, 1.f));
}
__device__ __forceinline__ float theta2u(float theta) {
    return sqrtf(clampminf(theta, 0.f) * TWO_OVER_PI_F);
}
__device__ __forceinline__ float phi2u(float phi) { return (phi + PI_F) * INV_TWO_PI_F; }

// find_interval as a count: the largest i in [0, n-2] with row[i] < u (strict) or <= u.
__device__ __forceinline__ int clip_count(int cnt, int n) { return min(max(cnt - 1, 0), max(n - 2, 0)); }

// Parameter lookup: grid cell i0 and lerp weight w1 of x (powitacq_rgb.inl:335-355).
__device__ __forceinline__ void param_weights(const float* row, int n, float x, int& i0, float& w1) {
    int cnt = 0;
    for (int j = 0; j < n; ++j) cnt += ld(row + j) <= x;
    i0 = clip_count(cnt, n);
    const float p0 = ld(row + i0);
    const float p1 = ld(row + min(i0 + 1, max(n - 1, 0)));
    const float w = clampf((x - p0) / (p1 == p0 ? 1.f : p1 - p0), 0.f, 1.f);
    w1 = n <= 1 ? 0.f : w;
}

// The (phi_i, theta_i) corners of one lane, weights and slice offsets.
struct Frame {
    int mid, nc;
    float cw[4];
    int slice[4];               // (mid * P + p) * T + t of each corner
    float phi_i, uwi_x, uwi_y;
    bool iso;
};

__device__ __forceinline__ Frame prepare(const RglTables& t, int mid, Vec3 wi) {
    Frame fr;
    fr.mid = mid;
    const float theta_i = elevation(wi);
    const float phi_i = atan2f(wi.y, wi.x);
    int pi, ti;
    float wp1, wt1;
    param_weights(t.phi_i + mid * t.P, t.n_phi[mid], phi_i, pi, wp1);
    param_weights(t.theta_i + mid * t.T, t.n_theta[mid], theta_i, ti, wt1);
    const int pi1 = min(pi + 1, t.P - 1), ti1 = min(ti + 1, t.T - 1);
    const float wp0 = 1.f - wp1, wt0 = 1.f - wt1;
    int cp[4], ct[4];
    if (t.P == 1 && t.T == 1) {
        fr.nc = 1; fr.cw[0] = 1.f; cp[0] = pi; ct[0] = ti;
    } else if (t.T == 1) {
        fr.nc = 2; fr.cw[0] = wp0; cp[0] = pi; ct[0] = ti; fr.cw[1] = wp1; cp[1] = pi1; ct[1] = ti;
    } else if (t.P == 1) {
        fr.nc = 2; fr.cw[0] = wt0; cp[0] = pi; ct[0] = ti; fr.cw[1] = wt1; cp[1] = pi; ct[1] = ti1;
    } else {
        fr.nc = 4;
        fr.cw[0] = wp0 * wt0; cp[0] = pi; ct[0] = ti;
        fr.cw[1] = wp0 * wt1; cp[1] = pi; ct[1] = ti1;
        fr.cw[2] = wp1 * wt0; cp[2] = pi1; ct[2] = ti;
        fr.cw[3] = wp1 * wt1; cp[3] = pi1; ct[3] = ti1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (k < fr.nc) fr.slice[k] = (mid * t.P + cp[k]) * t.T + ct[k];
    }
    fr.phi_i = phi_i;
    fr.uwi_x = theta2u(theta_i);
    fr.uwi_y = phi2u(phi_i);
    fr.iso = t.isotropic[mid] != 0;
    return fr;
}

// Param-bilinear fetch: sum over the corners of arr[slice, off] for an array
// whose slices are `stride` floats apart.
__device__ __forceinline__ float gsum(const Frame& fr, const float* arr, int stride, int off) {
    float out = fr.cw[0] * ld(arr + fr.slice[0] * stride + off);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
        if (k < fr.nc) out = out + fr.cw[k] * ld(arr + fr.slice[k] * stride + off);
    }
    return out;
}

struct Warp {                   // one param-conditioned Marginal2D warp
    const float *data, *marg, *cond;
    int H, W;                   // padded
    int h, w;                   // this material's
};

__device__ __forceinline__ Warp make_warp(const float* data, const float* marg, const float* cond,
                                          const int* hw, int H, int W, int mid) {
    return {data, marg, cond, H, W, hw[2 * mid], hw[2 * mid + 1]};
}

__device__ __forceinline__ float gd(const Frame& fr, const Warp& wp, int y, int x) {
    return gsum(fr, wp.data, wp.H * wp.W, y * wp.W + x);
}
__device__ __forceinline__ float gc(const Frame& fr, const Warp& wp, int y, int x) {
    return gsum(fr, wp.cond, wp.H * wp.W, y * wp.W + x);
}
__device__ __forceinline__ float gm(const Frame& fr, const Warp& wp, int y) {
    return gsum(fr, wp.marg, wp.H, y);
}
__device__ __forceinline__ float area(const Warp& wp) {
    return static_cast<float>((wp.w - 1) * (wp.h - 1));
}

__device__ __forceinline__ void cell(const Warp& wp, float px, float py, int& x0, int& y0,
                                     float& sx, float& sy) {
    const float fx = px * static_cast<float>(wp.w - 1);
    const float fy = py * static_cast<float>(wp.h - 1);
    x0 = clampi(static_cast<int>(fx), 0, wp.w - 2);
    y0 = clampi(static_cast<int>(fy), 0, wp.h - 2);
    sx = fx - static_cast<float>(x0);
    sy = fy - static_cast<float>(y0);
}

// Bilinear density at (px, py) (powitacq_rgb.inl:530-583).
__device__ __forceinline__ float warp_eval(const Frame& fr, const Warp& wp, float px, float py) {
    int x0, y0;
    float sx, sy;
    cell(wp, px, py, x0, y0, sx, sy);
    const int y1 = min(y0 + 1, wp.H - 1);
    const float v00 = gd(fr, wp, y0, x0), v10 = gd(fr, wp, y0, x0 + 1);
    const float v01 = gd(fr, wp, y1, x0), v11 = gd(fr, wp, y1, x0 + 1);
    return ((1.f - sy) * ((1.f - sx) * v00 + sx * v10) + sy * ((1.f - sx) * v01 + sx * v11))
           * area(wp);
}

// Warped position back to the unit square, and the density (powitacq_rgb.inl:434-527).
__device__ __forceinline__ float warp_invert(const Frame& fr, const Warp& wp, float px, float py, float& ux,
                             float& uy) {
    int x0, y0;
    float sx, sy;
    cell(wp, px, py, x0, y0, sx, sy);
    const int y1 = min(y0 + 1, wp.H - 1);
    const float v00 = gd(fr, wp, y0, x0), v10 = gd(fr, wp, y0, x0 + 1);
    const float v01 = gd(fr, wp, y1, x0), v11 = gd(fr, wp, y1, x0 + 1);
    const float c0 = (1.f - sy) * v00 + sy * v01;
    const float c1 = (1.f - sy) * v10 + sy * v11;
    const float pdf = (1.f - sx) * c0 + sx * c1;
    float x = sx * (c0 + 0.5f * sx * (c1 - c0));
    x = x + ((1.f - sy) * gc(fr, wp, y0, x0) + sy * gc(fr, wp, y1, x0));
    const int wlast = max(wp.w - 1, 0);
    const float r0 = gc(fr, wp, y0, wlast), r1 = gc(fr, wp, y1, wlast);
    ux = x / clampminf((1.f - sy) * r0 + sy * r1, 1e-20f);
    uy = sy * (r0 + 0.5f * sy * (r1 - r0)) + gm(fr, wp, y0);
    return pdf * area(wp);
}

// Warp a uniform sample; returns the density (powitacq_rgb.inl:326-432).
// `found`, where given, gets the row and column the searches found.
__device__ __forceinline__ float warp_sample(const Frame& fr, const Warp& wp, float u0, float u1, float& px,
                             float& py, int* found = nullptr) {
    float ux = clampf(u0, U_LO, U_HI), uy = clampf(u1, U_LO, U_HI);
    int cnt = 0;
    for (int j = 0; j < wp.h; ++j) cnt += gm(fr, wp, j) < uy;
    const int row = clip_count(cnt, wp.h);
    uy = uy - gm(fr, wp, row);
    const int row1 = min(row + 1, wp.H - 1);
    const int wlast = max(wp.w - 1, 0);
    const float r0 = gc(fr, wp, row, wlast), r1 = gc(fr, wp, row1, wlast);
    const bool is_const = fabsf(r0 - r1) < 1e-4f * (r0 + r1);
    const float disc = sqrtf(clampminf(r0 * r0 - 2.f * uy * (r0 - r1), 0.f));
    uy = is_const ? 2.f * uy / clampminf(r0 + r1, 1e-20f)
                  : (r0 - disc) / ((is_const || r0 == r1) ? 1.f : r0 - r1);
    ux = ux * ((1.f - uy) * r0 + uy * r1);
    cnt = 0;
    for (int j = 0; j < wp.w; ++j)
        cnt += (1.f - uy) * gc(fr, wp, row, j) + uy * gc(fr, wp, row1, j) < ux;
    const int col = clip_count(cnt, wp.w);
    if (found) {
        found[0] = row;
        found[1] = col;
    }
    ux = ux - ((1.f - uy) * gc(fr, wp, row, col) + uy * gc(fr, wp, row1, col));
    const float v00 = gd(fr, wp, row, col), v10 = gd(fr, wp, row, col + 1);
    const float v01 = gd(fr, wp, row1, col), v11 = gd(fr, wp, row1, col + 1);
    const float c0 = (1.f - uy) * v00 + uy * v01;
    const float c1 = (1.f - uy) * v10 + uy * v11;
    const bool is_const2 = fabsf(c0 - c1) < 1e-4f * (c0 + c1);
    const float disc2 = sqrtf(clampminf(c0 * c0 - 2.f * ux * (c0 - c1), 0.f));
    ux = is_const2 ? 2.f * ux / clampminf(c0 + c1, 1e-20f)
                   : (c0 - disc2) / ((is_const2 || c0 == c1) ? 1.f : c0 - c1);
    px = (static_cast<float>(col) + ux) / static_cast<float>(wp.w - 1);
    py = (static_cast<float>(row) + uy) / static_cast<float>(wp.h - 1);
    return ((1.f - ux) * c0 + ux * c1) * area(wp);
}

// Plain bilinear of a raw [M, H, W] table (Warp2D0, powitacq_rgb.inl:286-312).
__device__ __forceinline__ float eval0(const float* arr, const int* hw, int H, int W, int mid, float px, float py) {
    const int h = hw[2 * mid], w = hw[2 * mid + 1];
    const float fx = clampf(px, 0.f, 1.f) * static_cast<float>(w - 1);
    const float fy = clampf(py, 0.f, 1.f) * static_cast<float>(h - 1);
    const int x0 = clampi(static_cast<int>(fx), 0, w - 2);
    const int y0 = clampi(static_cast<int>(fy), 0, h - 2);
    const float sx = fx - static_cast<float>(x0), sy = fy - static_cast<float>(y0);
    const int y1 = min(y0 + 1, H - 1);
    const float* a = arr + mid * H * W;
    const float v00 = ld(a + y0 * W + x0), v10 = ld(a + y0 * W + x0 + 1);
    const float v01 = ld(a + y1 * W + x0), v11 = ld(a + y1 * W + x0 + 1);
    return (1.f - sy) * ((1.f - sx) * v00 + sx * v10) + sy * ((1.f - sx) * v01 + sx * v11);
}

// Reflectance x ndf / (4 sigma(wi)) at a luminance-warp position (rgb_eval + the tail).
__device__ __forceinline__ void fr_common(const RglTables& t, const Frame& fr, const Warp& lum, float px,
                          float py, float uwm_x, float uwm_y, float f[4]) {
    int x0, y0;
    float sx, sy;
    cell(lum, px, py, x0, y0, sx, sy);
    const int y1 = min(y0 + 1, lum.H - 1);
    const int plane = lum.H * lum.W;
    const float ndf_v = eval0(t.ndf, t.ndf_hw, t.Hn, t.Wn, fr.mid, uwm_x, uwm_y);
    const float sigma_v = eval0(t.sigma, t.sigma_hw, t.Hs, t.Ws, fr.mid, fr.uwi_x, fr.uwi_y);
    const float scale = ndf_v / clampminf(4.f * sigma_v, 1e-12f);
    for (int c = 0; c < 4; ++c) {
        const float v00 = gsum(fr, t.rgb, 4 * plane, c * plane + y0 * lum.W + x0);
        const float v10 = gsum(fr, t.rgb, 4 * plane, c * plane + y0 * lum.W + x0 + 1);
        const float v01 = gsum(fr, t.rgb, 4 * plane, c * plane + y1 * lum.W + x0);
        const float v11 = gsum(fr, t.rgb, 4 * plane, c * plane + y1 * lum.W + x0 + 1);
        const float out = (1.f - sy) * ((1.f - sx) * v00 + sx * v10)
                          + sy * ((1.f - sx) * v01 + sx * v11);
        f[c] = clampminf(out, 0.f) * scale;
    }
}

__device__ __forceinline__ float jacobian(Vec3 wi, Vec3 wm, float uwm_x) {
    const float sin_theta_m = sqrtf(wm.x * wm.x + wm.y * wm.y);
    return clampminf(TWO_PI2_F * uwm_x * sin_theta_m, 1e-6f) * 4.f * dot3(wi, wm);
}

__device__ __forceinline__ Warp vndf_warp(const RglTables& t, int mid) {
    return make_warp(t.vndf_data, t.vndf_marg, t.vndf_cond, t.vndf_hw, t.Hv, t.Wv, mid);
}
__device__ __forceinline__ Warp lum_warp(const RglTables& t, int mid) {
    return make_warp(t.lum_data, t.lum_marg, t.lum_cond, t.lum_hw, t.Hl, t.Wl, mid);
}

// One lane of rgl_eval: f*cos [4] into f and the pdf of tangent-space wi
// (toward the viewer) and wo (the scatter direction); zero unless both lie
// above the surface.
__device__ __forceinline__ float eval_lane(const RglTables& t, int mid, Vec3 wi, Vec3 wo, float f[4]) {
    const bool valid = (wi.z > 0.f) && (wo.z > 0.f);
    const Vec3 wm = normalize3({wi.x + wo.x, wi.y + wo.y, wi.z + wo.z});
    const Frame fr = prepare(t, mid, wi);
    // u_wm: the half vector in the warp's (theta, phi) square
    const float theta_m = elevation(wm);
    const float phi_m = atan2f(wm.y, wm.x);
    const float um_y0 = phi2u(fr.iso ? phi_m - fr.phi_i : phi_m);
    const float uwm_x = theta2u(theta_m), uwm_y = um_y0 - floorf(um_y0);
    float px, py;
    const float vndf_pdf = warp_invert(fr, vndf_warp(t, mid), uwm_x, uwm_y, px, py);
    const Warp lum = lum_warp(t, mid);
    fr_common(t, fr, lum, px, py, uwm_x, uwm_y, f);
    const float lum_pdf = warp_eval(fr, lum, px, py);
    const float pdf = vndf_pdf * lum_pdf / jacobian(wi, wm, uwm_x);
    for (int c = 0; c < 4; ++c) f[c] = valid ? f[c] : 0.f;
    return valid ? clampminf(pdf, 0.f) : 0.f;
}

// One lane of rgl_sample from the uniforms (u0, u1): the sampled direction
// into *wo, f*cos [4] into f and the pdf into *pdf (both zero unless ok);
// returns ok: both directions above the surface, a positive pdf and a
// finite f.
__device__ __forceinline__ bool sample_lane(const RglTables& t, int mid, Vec3 wi, float u0, float u1,
                                   Vec3* wo, float f[4], float* pdf) {
    const Frame fr = prepare(t, mid, wi);
    const Warp lum = lum_warp(t, mid);
    float sx, sy, uwm_x, uwm_y;
    const float lum_pdf = warp_sample(fr, lum, u1, u0, sx, sy);
    const float ndf_pdf = warp_sample(fr, vndf_warp(t, mid), sx, sy, uwm_x, uwm_y);
    float phi_m = (2.f * uwm_y - 1.f) * PI_F;
    const float theta_m = uwm_x * uwm_x * HALF_PI_F;
    if (fr.iso) phi_m = phi_m + fr.phi_i;
    const float sin_t = sinf(theta_m), cos_t = cosf(theta_m);
    const Vec3 wm = {cosf(phi_m) * sin_t, sinf(phi_m) * sin_t, cos_t};
    const float d2 = 2.f * dot3(wm, wi);
    *wo = {d2 * wm.x - wi.x, d2 * wm.y - wi.y, d2 * wm.z - wi.z};
    const bool valid = (wi.z > 0.f) && (wo->z > 0.f);
    fr_common(t, fr, lum, sx, sy, uwm_x, uwm_y, f);
    const float p = ndf_pdf * lum_pdf / jacobian(wi, wm, uwm_x);
    bool finite = true;
    for (int c = 0; c < 4; ++c) finite = finite && isfinite(f[c]);
    const bool ok = valid && p > 0.f && finite;
    for (int c = 0; c < 4; ++c) f[c] = ok ? f[c] : 0.f;
    *pdf = ok ? p : 0.f;
    return ok;
}

}  // namespace wpt_rgl
