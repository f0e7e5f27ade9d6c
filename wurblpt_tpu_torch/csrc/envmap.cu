// K8: environment maps — radiance lookup (equirect, cube, constant),
// importance sample, pdf.
//
// Replaces wurblpt_tpu/render/envmap.py env_radiance (the equirect branch with
// _equirect_uv and _bilinear_wrap, the cube branch _cube_lookup, the constant
// branch), env_sample and env_pdf. The TPU version read the four bilinear
// taps from a 16-channel "patch image" so that one descriptor-priced row
// gather served them, and packed the alias tables into one row per cell; here
// a thread reads the four texels (float4 each) and the table entries
// directly.
//
// One kernel, env_lanes_kernel<SAMPLE>, serves every entry point, a thread a
// lane. SAMPLE false: given directions, their radiance and, where `pdf_out`
// is given, their pdf (render/wavefront.py env_miss's pair; env_radiance and
// env_pdf alone). SAMPLE true: a sample from the uniforms and, where
// `rad_out` is given, the radiance of its direction, kept in registers
// (env_nee's pair; env_sample alone). The generic bounce once launched one
// kernel per output, each over every lane of the bounce, where about nine
// tenths of the lanes' results went unread (a hit lane's miss radiance, a
// lane without env NEE's sample): an `active` mask [N] now marks the lanes
// whose results are read. A lane outside it does no lookup and writes fixed
// values: radiance 0, pdf 0, and as a sample's direction the map's +z axis
// in the world (where the lookup's backward has no pole, whatever the
// map's rotation: the lane's zero cotangent stays finite). The map's
// kind takes a branch per launch (every lane of a launch takes the same).
//
// Bound on the card: memory latency of the gathers and the IEEE atan2f /
// acosf / sinf / cosf calls; the 64x128 equirect image (128 KB), the six
// 32x32 cube faces (96 KB) and the tables sit in L1/L2.
//
// The per-lane arithmetic (lookups, one sample, one pdf) lives in
// envmap_common.cuh, which K4's env shade (wavefront.cu) includes as well;
// it follows the plain PyTorch version (wurblpt_tpu_torch/render/envmap.py)
// in the same order, and the library is built with -fmad=false and without
// --use_fast_math. The sampled direction's radiance is looked up from the
// world direction, as a lookup of the sample's output would be: the pair
// keeps the bits of the two entry points in turn.
#include <cuda_runtime.h>

#include "envmap_common.cuh"

namespace {

constexpr int BLOCK = 128;

using wpt_env::cube_lookup;
using wpt_env::equirect_lookup;
using wpt_env::to_map;

// kind: 1 equirect [h, w] image, 2 cube [6, h, w] faces, 3 constant radiance;
// the importance tables (pdf, alias_prob, alias_idx) res x res, or none.
struct EnvLanesMap {
    int kind;
    const float4* img;
    int h, w;
    const float* rot;
    const float4* const_rad;
    const float* pdf;
    const float* alias_prob;
    const int* alias_idx;
    int res;
};

__device__ __forceinline__ float4 radiance(const EnvLanesMap& m, float3 d) {
    if (m.kind == 3) return __ldg(m.const_rad);
    const float3 dm = to_map(m.rot, d);
    return m.kind == 2 ? cube_lookup(m.img, m.h, m.w, dm) : equirect_lookup(m.img, m.h, m.w, dm);
}

// x: directions [n, 3] (SAMPLE false) or uniforms [n, 3] (SAMPLE true);
// active: [n] or null (every lane); d_out [n, 3] (SAMPLE: the sampled
// directions), pdf_out [n] and rad_out [n, 4], each null where not wanted.
template <bool SAMPLE>
__global__ void __launch_bounds__(BLOCK)
env_lanes_kernel(EnvLanesMap m, const float* __restrict__ x, const bool* __restrict__ active,
                 int n, float* __restrict__ d_out, float* __restrict__ pdf_out,
                 float4* __restrict__ rad_out) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= n) return;
    if (active != nullptr && !active[i]) {
        if (SAMPLE) {   // the map's +z axis, where every lookup's backward is regular
            const float3 z = wpt_env::quat_rotate(m.rot[0], m.rot[1], m.rot[2], m.rot[3],
                                                  make_float3(0.f, 0.f, 1.f));
            d_out[3 * i + 0] = z.x;
            d_out[3 * i + 1] = z.y;
            d_out[3 * i + 2] = z.z;
        }
        if (pdf_out != nullptr) pdf_out[i] = 0.f;
        if (rad_out != nullptr) rad_out[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        return;
    }
    float3 d;
    if (SAMPLE) {
        const float pdf = wpt_env::sample(x[3 * i + 0], x[3 * i + 1], x[3 * i + 2], m.pdf,
                                          m.alias_prob, m.alias_idx, m.res, m.rot, &d);
        d_out[3 * i + 0] = d.x;
        d_out[3 * i + 1] = d.y;
        d_out[3 * i + 2] = d.z;
        if (pdf_out != nullptr) pdf_out[i] = pdf;
    } else {
        d = make_float3(x[3 * i + 0], x[3 * i + 1], x[3 * i + 2]);
        if (pdf_out != nullptr) pdf_out[i] = wpt_env::pdf(d, m.pdf, m.res, m.rot);
    }
    if (rad_out != nullptr) rad_out[i] = radiance(m, d);
}

}  // namespace

// K8 over n lanes: sample 0 reads directions x [n, 3] and writes the
// radiance (rad_out [n, 4]) and the pdf (pdf_out [n]) where given; sample 1
// reads uniforms x [n, 3] and writes the sampled directions (d_out [n, 3]),
// their pdf and radiance where given. active: a bool per lane, or null for
// every lane. The importance tables may be null where no pdf or sample is
// asked for; the image, where the sky is constant.
extern "C" int wpt_env_lanes(int sample, const float* x, const bool* active, int n, int kind,
                             const float* img, int h, int w, const float* rot,
                             const float* const_rad, const float* pdf, const float* alias_prob,
                             const int* alias_idx, int res, float* d_out, float* pdf_out,
                             float* rad_out, void* stream) {
    if (kind < 1 || kind > 3 || (sample && d_out == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n > 0) {
        const EnvLanesMap m{kind, reinterpret_cast<const float4*>(img), h, w, rot,
                            reinterpret_cast<const float4*>(const_rad), pdf, alias_prob,
                            alias_idx, res};
        const int grid = (n + BLOCK - 1) / BLOCK;
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        float4* rad = reinterpret_cast<float4*>(rad_out);
        if (sample)
            env_lanes_kernel<true><<<grid, BLOCK, 0, s>>>(m, x, active, n, d_out, pdf_out, rad);
        else
            env_lanes_kernel<false><<<grid, BLOCK, 0, s>>>(m, x, active, n, d_out, pdf_out, rad);
    }
    return static_cast<int>(cudaGetLastError());
}
