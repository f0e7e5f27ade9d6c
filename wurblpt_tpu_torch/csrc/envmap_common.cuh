// K8's arithmetic for one lane: the environment map's radiance lookups
// (equirect, cube), one importance sample and one pdf. Included by
// envmap.cu (K8's stand-alone kernels) and wavefront.cu (K4's env shade,
// which reads the map inline), so there is one copy of it.
//
// Every expression follows the plain PyTorch version
// (wurblpt_tpu_torch/render/envmap.py) in the same order; divisions by 2 pi,
// pi, R and the cube's major axis stay true divisions as in the JAX package.
// The including source is built with -fmad=false and without
// --use_fast_math.
#pragma once

#include <cuda_runtime.h>

namespace wpt_env {

constexpr float TWO_PI = 6.28318530717958647692f;
constexpr float PI = 3.14159265358979323846f;

__device__ __forceinline__ float3 cross3(float ax, float ay, float az, float3 b) {
    return make_float3(ay * b.z - az * b.y, az * b.x - ax * b.z, ax * b.y - ay * b.x);
}

// v + w t + u x t with t = 2 (u x v): core/transform.quat_rotate, q = (u, w).
__device__ __forceinline__ float3 quat_rotate(float ux, float uy, float uz, float w, float3 v) {
    const float3 c = cross3(ux, uy, uz, v);
    const float3 t = make_float3(2.f * c.x, 2.f * c.y, 2.f * c.z);
    const float3 e = cross3(ux, uy, uz, t);
    return make_float3(v.x + w * t.x + e.x, v.y + w * t.y + e.y, v.z + w * t.z + e.z);
}

// World direction -> map direction: rotate by the conjugate of the map's rotation.
__device__ __forceinline__ float3 to_map(const float* __restrict__ rot, float3 v) {
    return quat_rotate(-rot[0], -rot[1], -rot[2], rot[3], v);
}

// x mod 1 with the sign of the divisor (jnp.mod).
__device__ __forceinline__ float mod1(float x) {
    const float r = fmodf(x, 1.f);
    return (r != 0.f && r < 0.f) ? r + 1.f : r;
}

__device__ __forceinline__ float clamp1(float x) { return fminf(fmaxf(x, -1.f), 1.f); }

// Equirect: u = atan2(x, -z) / 2 pi mod 1, v = acos(y) / pi; bilinear, wrap
// in u, clamp in v.
__device__ __forceinline__ float4 equirect_lookup(const float4* __restrict__ img, int h, int w,
                                                  float3 dm) {
    const float u = mod1(atan2f(dm.x, -dm.z) / TWO_PI);
    const float v = acosf(clamp1(dm.y)) / PI;
    const float x = u * static_cast<float>(w) - 0.5f;
    const float y = v * static_cast<float>(h) - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const int x0i = ((static_cast<int>(x0) % w) + w) % w;
    const int y0i = min(max(static_cast<int>(y0), 0), h - 1);
    const int x1i = (x0i + 1) % w;
    const int y1i = min(y0i + 1, h - 1);
    const float4 c00 = __ldg(img + y0i * w + x0i), c01 = __ldg(img + y0i * w + x1i);
    const float4 c10 = __ldg(img + y1i * w + x0i), c11 = __ldg(img + y1i * w + x1i);
    const float gx = 1.f - fx, gy = 1.f - fy;
    return make_float4((c00.x * gx + c01.x * fx) * gy + (c10.x * gx + c11.x * fx) * fy,
                       (c00.y * gx + c01.y * fx) * gy + (c10.y * gx + c11.y * fx) * fy,
                       (c00.z * gx + c01.z * fx) * gy + (c10.z * gx + c11.z * fx) * fy,
                       (c00.w * gx + c01.w * fx) * gy + (c10.w * gx + c11.w * fx) * fy);
}

// Cube map, faces +x, -x, +y, -y, +z, -z of h x w texels each: the face of
// the largest |component| (ties to x, then y, as the >= tests order them),
// the standard per-face (sc, tc), then a bilinear lookup with edge clamp
// whose texel coordinates are clamped at 0 before the truncation.
__device__ __forceinline__ float4 cube_lookup(const float4* __restrict__ img, int h, int w,
                                              float3 dm) {
    const float ax = fabsf(dm.x), ay = fabsf(dm.y), az = fabsf(dm.z);
    const bool is_x = ax >= ay && ax >= az;
    const bool is_y = !is_x && ay >= az;
    int face;
    float ma, sc, tc;
    if (is_x) {
        face = dm.x > 0.f ? 0 : 1;
        ma = ax;
        sc = dm.x > 0.f ? -dm.z : dm.z;
        tc = -dm.y;
    } else if (is_y) {
        face = dm.y > 0.f ? 2 : 3;
        ma = ay;
        sc = dm.x;
        tc = dm.y > 0.f ? dm.z : -dm.z;
    } else {
        face = dm.z > 0.f ? 4 : 5;
        ma = az;
        sc = dm.z > 0.f ? dm.x : -dm.x;
        tc = -dm.y;
    }
    ma = fmaxf(ma, 1e-20f);
    const float u = 0.5f * (sc / ma + 1.f);
    const float v = 0.5f * (tc / ma + 1.f);
    const float us = fmaxf(u * static_cast<float>(w) - 0.5f, 0.f);
    const float vs = fmaxf(v * static_cast<float>(h) - 0.5f, 0.f);
    const int x0 = min(max(static_cast<int>(us), 0), w - 1);
    const int y0 = min(max(static_cast<int>(vs), 0), h - 1);
    const float a = us - static_cast<float>(x0), b = vs - static_cast<float>(y0);
    const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
    const float4* f = img + face * h * w;
    const float4 c00 = __ldg(f + y0 * w + x0), c10 = __ldg(f + y0 * w + x1);
    const float4 c01 = __ldg(f + y1 * w + x0), c11 = __ldg(f + y1 * w + x1);
    const float ga = 1.f - a, gb = 1.f - b;
    return make_float4((c00.x * ga + c10.x * a) * gb + (c01.x * ga + c11.x * a) * b,
                       (c00.y * ga + c10.y * a) * gb + (c01.y * ga + c11.y * a) * b,
                       (c00.z * ga + c10.z * a) * gb + (c01.z * ga + c11.z * a) * b,
                       (c00.w * ga + c10.w * a) * gb + (c01.w * ga + c11.w * a) * b);
}

// One importance sample (render/envmap.py env_sample_plain): the alias
// pick of a cell of the res x res equal-area grid by u0, a uniform point in
// it by (u1, u2), mapped to the sphere and rotated into the world. Writes
// the world direction to `dir` and returns the cell's solid-angle pdf.
__device__ __forceinline__ float sample(float u0, float u1, float u2,
                                        const float* __restrict__ pdf_flat,
                                        const float* __restrict__ alias_prob,
                                        const int* __restrict__ alias_idx, int res,
                                        const float* __restrict__ rot, float3* dir) {
    const int cells = res * res;
    const float a = u0 * static_cast<float>(cells);
    int cell = min(max(static_cast<int>(a), 0), cells - 1);
    const float accept = a - static_cast<float>(cell);
    if (accept > __ldg(alias_prob + cell)) cell = __ldg(alias_idx + cell);
    const float pdf = __ldg(pdf_flat + cell);
    const int ci = cell / res, cj = cell % res;
    const float fres = static_cast<float>(res);
    const float su = (static_cast<float>(cj) + u1) / fres;
    const float sv = (static_cast<float>(ci) + u2) / fres;
    // square_to_sphere: equal-area cylindrical map, y is the polar axis.
    const float phi = TWO_PI * su;
    const float y = 2.f * sv - 1.f;
    const float r = sqrtf(fmaxf(1.f - y * y, 1e-20f));
    const float3 dm = make_float3(r * cosf(phi), y, r * sinf(phi));
    *dir = quat_rotate(rot[0], rot[1], rot[2], rot[3], dm);
    return pdf;
}

// The solid-angle pdf of `sample` having produced world direction d
// (render/envmap.py env_pdf_plain): the pdf table at d's cell.
__device__ __forceinline__ float pdf(float3 d, const float* __restrict__ pdf_table, int res,
                                     const float* __restrict__ rot) {
    const float3 dm = to_map(rot, d);
    const float u = mod1(atan2f(dm.z, dm.x) / TWO_PI);
    const float v = 0.5f * (clamp1(dm.y) + 1.f);
    const float fres = static_cast<float>(res);
    const int cj = min(max(static_cast<int>(u * fres), 0), res - 1);
    const int ci = min(max(static_cast<int>(v * fres), 0), res - 1);
    return __ldg(pdf_table + ci * res + cj);
}

}  // namespace wpt_env
