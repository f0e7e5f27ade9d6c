// K8: environment maps — radiance lookup (equirect, cube, constant),
// importance sample, pdf.
//
// Replaces wurblpt_tpu/render/envmap.py env_radiance (the equirect branch with
// _equirect_uv and _bilinear_wrap, the cube branch _cube_lookup, the constant
// branch), env_sample and env_pdf. The TPU version read the four bilinear
// taps from a 16-channel "patch image" so that one descriptor-priced row
// gather served them, and packed the alias tables into one row per cell; here
// a thread reads the four texels (float4 each) and the table entries
// directly. The radiance kernel takes the map's kind and branches per launch
// (every lane of a launch takes the same branch).
//
// Bound on the card: memory latency of the gathers and the IEEE atan2f /
// acosf / sinf / cosf calls; the 64x128 equirect image (128 KB), the six
// 32x32 cube faces (96 KB) and the tables sit in L1/L2. Each lane is
// independent, one thread per lane.
//
// Every expression follows the plain PyTorch version
// (wurblpt_tpu_torch/render/envmap.py) in the same order, divisions by 2 pi,
// pi, R and the cube's major axis stay true divisions as in the JAX package,
// and the library is built with -fmad=false and without --use_fast_math.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 128;
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
__device__ __forceinline__ float3 to_map(const float* __restrict__ rot, const float* __restrict__ d,
                                         int i) {
    const float3 v = make_float3(d[3 * i + 0], d[3 * i + 1], d[3 * i + 2]);
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

// kind: 1 equirect [h, w] image, 2 cube [6, h, w] faces, 3 constant radiance.
__global__ void __launch_bounds__(BLOCK)
env_radiance_kernel(const float* __restrict__ d, int n, int kind, const float4* __restrict__ img,
                    int h, int w, const float* __restrict__ rot,
                    const float4* __restrict__ const_rad, float4* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    if (kind == 3) {
        out[i] = __ldg(const_rad);
        return;
    }
    const float3 dm = to_map(rot, d, i);
    out[i] = kind == 2 ? cube_lookup(img, h, w, dm) : equirect_lookup(img, h, w, dm);
}

__global__ void __launch_bounds__(BLOCK)
env_sample_kernel(const float* __restrict__ u3, int n, const float* __restrict__ pdf_flat,
                  const float* __restrict__ alias_prob, const int* __restrict__ alias_idx, int res,
                  const float* __restrict__ rot, float* __restrict__ d_out,
                  float* __restrict__ pdf_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int cells = res * res;
    const float a = u3[3 * i + 0] * static_cast<float>(cells);
    int cell = min(max(static_cast<int>(a), 0), cells - 1);
    const float accept = a - static_cast<float>(cell);
    if (accept > __ldg(alias_prob + cell)) cell = __ldg(alias_idx + cell);
    const float pdf = __ldg(pdf_flat + cell);
    const int ci = cell / res, cj = cell % res;
    const float fres = static_cast<float>(res);
    const float su = (static_cast<float>(cj) + u3[3 * i + 1]) / fres;
    const float sv = (static_cast<float>(ci) + u3[3 * i + 2]) / fres;
    // square_to_sphere: equal-area cylindrical map, y is the polar axis.
    const float phi = TWO_PI * su;
    const float y = 2.f * sv - 1.f;
    const float r = sqrtf(fmaxf(1.f - y * y, 1e-20f));
    const float3 dm = make_float3(r * cosf(phi), y, r * sinf(phi));
    const float3 dw = quat_rotate(rot[0], rot[1], rot[2], rot[3], dm);
    d_out[3 * i + 0] = dw.x;
    d_out[3 * i + 1] = dw.y;
    d_out[3 * i + 2] = dw.z;
    pdf_out[i] = pdf;
}

__global__ void __launch_bounds__(BLOCK)
env_pdf_kernel(const float* __restrict__ d, int n, const float* __restrict__ pdf_table, int res,
               const float* __restrict__ rot, float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float3 dm = to_map(rot, d, i);
    const float u = mod1(atan2f(dm.z, dm.x) / TWO_PI);
    const float v = 0.5f * (clamp1(dm.y) + 1.f);
    const float fres = static_cast<float>(res);
    const int cj = min(max(static_cast<int>(u * fres), 0), res - 1);
    const int ci = min(max(static_cast<int>(v * fres), 0), res - 1);
    out[i] = __ldg(pdf_table + ci * res + cj);
}

}  // namespace

extern "C" int wpt_env_radiance(const float* d, int n, int kind, const float* img, int h, int w,
                                const float* rot, const float* const_rad, float* out,
                                void* stream) {
    if (kind < 1 || kind > 3) return static_cast<int>(cudaErrorInvalidValue);
    if (n > 0) {
        env_radiance_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                              static_cast<cudaStream_t>(stream)>>>(
            d, n, kind, reinterpret_cast<const float4*>(img), h, w, rot,
            reinterpret_cast<const float4*>(const_rad), reinterpret_cast<float4*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_env_sample(const float* u3, int n, const float* pdf_flat,
                              const float* alias_prob, const int* alias_idx, int res,
                              const float* rot, float* d_out, float* pdf_out, void* stream) {
    if (n > 0) {
        env_sample_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            u3, n, pdf_flat, alias_prob, alias_idx, res, rot, d_out, pdf_out);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_env_pdf(const float* d, int n, const float* pdf_table, int res,
                           const float* rot, float* out, void* stream) {
    if (n > 0) {
        env_pdf_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            d, n, pdf_table, res, rot, out);
    }
    return static_cast<int>(cudaGetLastError());
}
