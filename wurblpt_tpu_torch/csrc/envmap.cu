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
// The per-lane arithmetic (lookups, one sample, one pdf) lives in
// envmap_common.cuh, which K4's env shade (wavefront.cu) includes as well;
// it follows the plain PyTorch version (wurblpt_tpu_torch/render/envmap.py)
// in the same order, and the library is built with -fmad=false and without
// --use_fast_math.
#include <cuda_runtime.h>

#include "envmap_common.cuh"

namespace {

constexpr int BLOCK = 128;

using wpt_env::cube_lookup;
using wpt_env::equirect_lookup;
using wpt_env::to_map;

__device__ __forceinline__ float3 load3(const float* __restrict__ d, int i) {
    return make_float3(d[3 * i + 0], d[3 * i + 1], d[3 * i + 2]);
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
    const float3 dm = to_map(rot, load3(d, i));
    out[i] = kind == 2 ? cube_lookup(img, h, w, dm) : equirect_lookup(img, h, w, dm);
}

__global__ void __launch_bounds__(BLOCK)
env_sample_kernel(const float* __restrict__ u3, int n, const float* __restrict__ pdf_flat,
                  const float* __restrict__ alias_prob, const int* __restrict__ alias_idx, int res,
                  const float* __restrict__ rot, float* __restrict__ d_out,
                  float* __restrict__ pdf_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float3 dw;
    pdf_out[i] = wpt_env::sample(u3[3 * i + 0], u3[3 * i + 1], u3[3 * i + 2], pdf_flat,
                                 alias_prob, alias_idx, res, rot, &dw);
    d_out[3 * i + 0] = dw.x;
    d_out[3 * i + 1] = dw.y;
    d_out[3 * i + 2] = dw.z;
}

__global__ void __launch_bounds__(BLOCK)
env_pdf_kernel(const float* __restrict__ d, int n, const float* __restrict__ pdf_table, int res,
               const float* __restrict__ rot, float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = wpt_env::pdf(load3(d, i), pdf_table, res, rot);
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
