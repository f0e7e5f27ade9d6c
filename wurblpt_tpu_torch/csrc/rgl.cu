// K7: the measured RGL BRDF (powitacq Marginal2D warps) — eval and sample.
//
// Replaces wurblpt_tpu/materials/rgl.py rgl_eval (:633) and rgl_sample
// (:650), with _prepare, _param_weights, _Warp2.eval/invert/sample, _eval0
// and _rgb_eval. The TPU version fetched whole table rows with one
// descriptor-priced gather each and picked values out of them with one-hot
// sums; here one thread per lane reads the few table entries it needs
// straight from global memory (the city's tables are a few KB and stay in
// L1/L2; staging them in shared memory is a later step).
//
// Bound on the card: a few hundred dependent scalar loads and a few hundred
// flops per lane (two parameter searches, the marginal and conditional row
// searches, 2-4 corner fetches per table value, atan2f/asinf/sinf/cosf), so
// memory latency, not bandwidth or arithmetic.
//
// Row searches count over a row masked by the material's actual width, as
// the JAX package's _search_row does (never a bisection), so kernel, plain
// version and JAX take the same interval on every input, flat CDF runs
// included. Every expression follows the plain PyTorch version
// (wurblpt_tpu_torch/materials/rgl.py) in the same order, and the library is
// built with -fmad=false and without --use_fast_math, so the two agree bit
// for bit. The lane arithmetic lives in rgl_common.cuh, which K4's lit shade
// (wavefront.cu) includes too.
#include <cuda_runtime.h>

#include "rgl_common.cuh"

namespace {

using namespace wpt_rgl;

constexpr int BLOCK = 128;

__device__ __forceinline__ Vec3 load3(const float* p, int i) {
    return {p[3 * i + 0], p[3 * i + 1], p[3 * i + 2]};
}

__global__ void __launch_bounds__(BLOCK)
rgl_eval_kernel(RglTables t, const int* __restrict__ mids, const float* __restrict__ wi_p,
                const float* __restrict__ wo_p, int n, float* __restrict__ fcos_out,
                float* __restrict__ pdf_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int mid = clampi(mids[i], 0, t.M - 1);
    float f[4];
    const float pdf = eval_lane(t, mid, load3(wi_p, i), load3(wo_p, i), f);
    for (int c = 0; c < 4; ++c) fcos_out[4 * i + c] = f[c];
    pdf_out[i] = pdf;
}

__global__ void __launch_bounds__(BLOCK)
rgl_sample_kernel(RglTables t, const int* __restrict__ mids, const float* __restrict__ wi_p,
                  const float* __restrict__ u2_p, int n, float* __restrict__ wo_out,
                  float* __restrict__ fcos_out, float* __restrict__ pdf_out,
                  bool* __restrict__ ok_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int mid = clampi(mids[i], 0, t.M - 1);
    Vec3 wo;
    float f[4], pdf;
    const bool ok = sample_lane(t, mid, load3(wi_p, i), u2_p[2 * i + 0], u2_p[2 * i + 1], &wo, f,
                                &pdf);
    wo_out[3 * i + 0] = wo.x;
    wo_out[3 * i + 1] = wo.y;
    wo_out[3 * i + 2] = wo.z;
    for (int c = 0; c < 4; ++c) fcos_out[4 * i + c] = f[c];
    pdf_out[i] = pdf;
    ok_out[i] = ok;
}

}  // namespace

extern "C" int wpt_rgl_eval(const RglTables* t, const int* mid, const float* wi, const float* wo,
                            int n, float* fcos, float* pdf, void* stream) {
    if (n > 0) {
        rgl_eval_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            *t, mid, wi, wo, n, fcos, pdf);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_rgl_sample(const RglTables* t, const int* mid, const float* wi,
                              const float* u2, int n, float* wo, float* fcos, float* pdf,
                              bool* ok, void* stream) {
    if (n > 0) {
        rgl_sample_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            *t, mid, wi, u2, n, wo, fcos, pdf, ok);
    }
    return static_cast<int>(cudaGetLastError());
}
