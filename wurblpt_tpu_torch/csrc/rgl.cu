// K7: the measured RGL BRDF (powitacq Marginal2D warps) — eval and sample.
//
// Replaces wurblpt_tpu/materials/rgl.py rgl_eval (:633) and rgl_sample
// (:650), with _prepare, _param_weights, _Warp2.eval/invert/sample, _eval0
// and _rgb_eval. The TPU version fetched whole table rows with one
// descriptor-priced gather each and picked values out of them with one-hot
// sums; here a thread takes a lane and reads the few table entries it needs
// straight from global memory (the tables are a few KB to a few MB and stay
// in L1/L2).
//
// A lane whose material id is negative carries no RGL material: no caller
// reads it, and it gets zeros (eval: f*cos and pdf; sample: wo, f*cos, pdf
// and ok false). A thread takes a lane; one without a material writes its
// zeros and is done. A render hands K7 every lane of a bounce, those of the
// other materials with id -1, so on a scene where few lanes are RGL the
// launch costs little more than reading the ids and writing the zeros.
// (On an H100 at 700 W, tools/k7_turns.py: queuing a warp's or a block's
// RGL lanes in shared memory first ran 2-5x faster where 1 lane in 4 or 1
// in 20 was RGL, but within a microsecond of this on material_comparison's
// bounces, where almost none is, and 20-25 % slower where every lane is, as
// on the city's and the RGL quad's first bounce; no scene of the repo sends
// the mixed lanes.)
//
// Bound on the card: the ids read and the outputs written for every lane
// (bytes); on the RGL lanes a few hundred dependent scalar loads and a few
// hundred flops each (two parameter searches, the warps' row searches, 2-4
// corner fetches per table value, atan2f/asinf/sinf/cosf), so memory
// latency. The sample's row searches are counts over a lane's row. On a
// stack whose padded rows are at least WARP_COUNT_FROM wide
// (rgl_common.cuh) the sample runs its warp form: the warp counts each of
// its RGL lanes' rows in turn, its 32 threads blending 32 entries of the
// row at once and a ballot counting them (warp_row_count), where a lane
// alone takes 2-4 scattered loads per entry in turn; a thread without an
// RGL lane then runs a stand-in lane of material 0 and drops its results,
// so that the whole warp reaches every vote. Narrower rows are counted by
// the lane.
//
// Row searches count over a row masked by the material's actual width, as
// the JAX package's _search_row does (never a bisection), so kernel, plain
// version and JAX take the same interval on every input, flat CDF runs and
// rows that are not monotone included. Every expression follows the plain
// PyTorch version (wurblpt_tpu_torch/materials/rgl.py) in the same order,
// and the library is built with -fmad=false and without --use_fast_math,
// so the two agree bit for bit. The lane arithmetic lives in
// rgl_common.cuh, which K4's lit shade (wavefront.cu) includes too.
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
    const int mid = mids[i];
    float f[4] = {0.f, 0.f, 0.f, 0.f}, pdf = 0.f;
    if (mid >= 0) pdf = eval_lane(t, min(mid, t.M - 1), load3(wi_p, i), load3(wo_p, i), f);
    for (int c = 0; c < 4; ++c) fcos_out[4 * i + c] = f[c];
    pdf_out[i] = pdf;
}

// WARP: the warp form (a stack's padded rows at least WARP_COUNT_FROM wide).
template <bool WARP>
__global__ void __launch_bounds__(BLOCK)
rgl_sample_kernel(RglTables t, const int* __restrict__ mids, const float* __restrict__ wi_p,
                  const float* __restrict__ u2_p, int n, float* __restrict__ wo_out,
                  float* __restrict__ fcos_out, float* __restrict__ pdf_out,
                  bool* __restrict__ ok_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in = i < n;
    const bool mine = in && mids[i] >= 0;
    Vec3 wo = {0.f, 0.f, 0.f};
    float f[4] = {0.f, 0.f, 0.f, 0.f}, pdf = 0.f;
    bool ok = false;
    if constexpr (WARP) {
        const unsigned live = __ballot_sync(FULL_MASK, mine);
        if (live != 0u) {   // a thread without an RGL lane: a stand-in of material 0
            Vec3 w;
            float g[4], p;
            const bool good = sample_lane<true>(
                t, mine ? min(mids[i], t.M - 1) : 0, mine ? load3(wi_p, i) : Vec3{0.f, 0.f, 1.f},
                mine ? u2_p[2 * i + 0] : 0.5f, mine ? u2_p[2 * i + 1] : 0.5f, &w, g, &p, live);
            if (mine) {
                wo = w;
                for (int c = 0; c < 4; ++c) f[c] = g[c];
                pdf = p;
                ok = good;
            }
        }
    } else if (mine) {
        ok = sample_lane(t, min(mids[i], t.M - 1), load3(wi_p, i), u2_p[2 * i + 0],
                         u2_p[2 * i + 1], &wo, f, &pdf);
    }
    if (!in) return;
    wo_out[3 * i + 0] = wo.x;
    wo_out[3 * i + 1] = wo.y;
    wo_out[3 * i + 2] = wo.z;
    for (int c = 0; c < 4; ++c) fcos_out[4 * i + c] = f[c];
    pdf_out[i] = pdf;
    ok_out[i] = ok;
}

// The sample's form for tables t: the warp's where any padded row is at
// least WARP_COUNT_FROM wide.
bool warp_form(const RglTables& t) {
    return max(max(t.Hv, t.Wv), max(t.Hl, t.Wl)) >= WARP_COUNT_FROM;
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
        const dim3 grid((n + BLOCK - 1) / BLOCK);
        const auto s = static_cast<cudaStream_t>(stream);
        if (warp_form(*t))
            rgl_sample_kernel<true><<<grid, BLOCK, 0, s>>>(*t, mid, wi, u2, n, wo, fcos, pdf, ok);
        else
            rgl_sample_kernel<false><<<grid, BLOCK, 0, s>>>(*t, mid, wi, u2, n, wo, fcos, pdf, ok);
    }
    return static_cast<int>(cudaGetLastError());
}
