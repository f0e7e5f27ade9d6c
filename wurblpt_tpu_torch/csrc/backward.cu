// Backward kernels of a differentiable render (render/backward.py):
//
// P0T, wpt_row_scatter: grad_table[clamp(idx[i]), c] += grad_out[i, c], the
//   transpose of P0's row gather (tools/probe_pallas_gather.py:20 and the
//   packed-row gathers of the render path), which JAX's autodiff makes of
//   every gather. A table that fits in shared memory (the material rows:
//   a few rows of 23 words) is summed per block there first, each block
//   then adding its nonzero sums to the global table: few global atomics
//   where every lane of a frame lands on a handful of rows. A larger table
//   takes a global atomicAdd per element.
// K3T, wpt_assemble_hit_bwd: the backward of K3's full form
//   (intersect.py:489-632) and of the winner's intersection
//   (intersect_mxu.py:164-257, the cast's t, u, v as the hit equations
//   give them); one thread per lane, the winner's rows scatter-added with
//   atomicAdd (backward_common.cuh assemble_hit_bwd_lane).
// K3aT, wpt_assemble_hit_anim_bwd: the same for K3a, the animated branch
//   (intersect.py:505-530, :605-620): the winner's hit recomputed in its
//   animation's object space from the lane's frame row, the world
//   normals' and tangent's cotangents taken back through their
//   normalizations and the normal and forward maps, and the cotangent of
//   the winner's 30-float frame row: added atomically into the [A, 30]
//   rows of one instant (a handful of rows: heavy contention, held like
//   K3T's tables to a tolerance) or stored to the lane's own row of [N, A,
//   30] per-ray rows.
// K8T, wpt_env_radiance_bwd: the backward of K8's radiance lookup
//   (envmap.py:118-201): equirect and cube lanes one thread each, the four
//   taps' texels scatter-added; a constant sky's radiance cotangent is the
//   sum of the lanes', reduced per warp by shuffles before one atomicAdd
//   per warp and channel.
// K7T, wpt_rgl_bwd: the backward of K7's eval or sample (materials/rgl.py
//   rgl_eval :633, rgl_sample :650 of the JAX package, through its autodiff)
//   into the tables of the reflectance tail: rgb (param- and
//   spatial-bilinear cells), ndf and sigma (bilinear cells). One thread per
//   lane recomputes its forward up to the warp positions
//   (backward_common.cuh rgl_bwd_lane) and adds each term with atomicAdd;
//   a material's few 8 x 8 rgb cells are contended, as K3T's rows are.
//
// Bound on the card: bytes (each lane's inputs and cotangents read once,
// its ray cotangents written once) for K3T and K8T, the atomics' traffic
// for P0T. Built with the other kernels: -fmad=false, no fast math. Float
// atomics make the sums' order vary from run to run: the checks
// (utils/grad_check.py) hold the kernels to their plain versions relative
// to the sum of the terms' magnitudes.
#include <cuda_runtime.h>

#include "backward_common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int SMEM_WORDS = 12288;   // 48 KB: the largest table summed in shared memory

template <bool SHARED>
__global__ void __launch_bounds__(BLOCK)
row_scatter_kernel(const float* __restrict__ g, const int* __restrict__ idx, long long total,
                   int cols, int rows, float* __restrict__ out) {
    extern __shared__ float acc[];
    const int words = rows * cols;
    if (SHARED) {
        for (int k = threadIdx.x; k < words; k += BLOCK) acc[k] = 0.f;
        __syncthreads();
    }
    const long long stride = static_cast<long long>(gridDim.x) * BLOCK;
    for (long long e = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x; e < total;
         e += stride) {
        const long long i = e / cols;
        const int c = static_cast<int>(e - i * cols);
        const float v = __ldg(g + e);
        if (v == 0.f) continue;
        const int r = min(max(__ldg(idx + i), 0), rows - 1);
        atomicAdd((SHARED ? acc : out) + static_cast<long long>(r) * cols + c, v);
    }
    if (SHARED) {
        __syncthreads();
        for (int k = threadIdx.x; k < words; k += BLOCK)
            if (acc[k] != 0.f) atomicAdd(out + k, acc[k]);
    }
}

template <bool ANIM>
__global__ void __launch_bounds__(BLOCK)
assemble_hit_bwd_kernel(wpt_bwd::HitIn in, wpt_bwd::Tables tb, wpt_bwd::Cot c,
                        wpt_bwd::HitOut out, wpt_bwd::AnimIn an) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i < in.n) wpt_bwd::assemble_hit_bwd_lane<ANIM>(i, in, tb, c, out, an);
}

__global__ void __launch_bounds__(BLOCK)
env_radiance_bwd_kernel(const float* __restrict__ d, int n, int kind,
                        const float4* __restrict__ img, int h, int w,
                        const float* __restrict__ rot, const float* __restrict__ g,
                        float* __restrict__ g_d, float* __restrict__ g_img,
                        float* __restrict__ g_const) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (kind != 3) {
        if (i < n) wpt_bwd::env_radiance_bwd_lane(i, d, kind, img, h, w, rot, g, g_d, g_img);
        return;
    }
    // constant sky: g_d = 0, g_const = sum over lanes of g
    float s[4];
    for (int k = 0; k < 4; ++k) s[k] = i < n ? g[4 * i + k] : 0.f;
    if (i < n) wpt_bwd::store3(g_d + 3 * i, {0.f, 0.f, 0.f});
    for (int off = 16; off > 0; off >>= 1)
        for (int k = 0; k < 4; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
    if ((threadIdx.x & 31) == 0)
        for (int k = 0; k < 4; ++k) wpt_bwd::add1(g_const + k, s[k]);
}

template <bool SAMPLE>
__global__ void __launch_bounds__(BLOCK)
rgl_bwd_kernel(RglTables t, const int* __restrict__ mids, const float* __restrict__ wi,
               const float* __restrict__ x, int n, const float* __restrict__ g_f,
               wpt_bwd::RglGrads out) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= n) return;
    const int mid = wpt_rgl::clampi(mids[i], 0, t.M - 1);
    wpt_bwd::rgl_bwd_lane<SAMPLE>(t, mid, {wi[3 * i], wi[3 * i + 1], wi[3 * i + 2]},
                                  x + (SAMPLE ? 2 : 3) * i, g_f + 4 * i, out);
}

inline int blocks(long long n) { return static_cast<int>((n + BLOCK - 1) / BLOCK); }

}  // namespace

extern "C" int wpt_row_scatter(const float* g, const int* idx, int n, int cols, int rows,
                               float* out, void* stream) {
    const long long total = static_cast<long long>(n) * cols;
    if (total > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        if (static_cast<long long>(rows) * cols <= SMEM_WORDS) {
            int dev = 0, sms = 1;
            cudaGetDevice(&dev);
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            const int grid = min(blocks(total), 2 * sms);
            row_scatter_kernel<true><<<grid, BLOCK, rows * cols * sizeof(float), s>>>(
                g, idx, total, cols, rows, out);
        } else {
            row_scatter_kernel<false><<<min(blocks(total), 65535 * 16), BLOCK, 0, s>>>(
                g, idx, total, cols, rows, out);
        }
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_assemble_hit_bwd(const float* o, const float* d, const float* t,
                                    const int* prim, const float* u, const float* v,
                                    const bool* backside, int n, const float* tri_g,
                                    const float* tri_f, const int* tri_i, int n_tris,
                                    const float* sph_f, int n_spheres, const float* g_t,
                                    const float* g_pos, const float* g_nrm, const float* g_gn,
                                    const float* g_tan, const float* g_uv, float* g_o,
                                    float* g_d, float* g_tri_g, float* g_tri_f, float* g_sph_f,
                                    void* stream) {
    if (n > 0)
        assemble_hit_bwd_kernel<false>
            <<<blocks(n), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
                wpt_bwd::HitIn{o, d, t, prim, u, v, backside, n},
                wpt_bwd::Tables{tri_g, tri_f, tri_i, n_tris, sph_f, n_spheres},
                wpt_bwd::Cot{g_t, g_pos, g_nrm, g_gn, g_tan, g_uv},
                wpt_bwd::HitOut{g_o, g_d, g_tri_g, g_tri_f, g_sph_f}, wpt_bwd::AnimIn{});
    return static_cast<int>(cudaGetLastError());
}

// K3aT: wpt_assemble_hit_bwd's arguments, then the winners' animation ids,
// the frame rows ([A, 30] with fstride 0, or [N, A, 30] with fstride A 30)
// and their cotangents (zeroed by the caller).
extern "C" int wpt_assemble_hit_anim_bwd(
    const float* o, const float* d, const float* t, const int* prim, const float* u,
    const float* v, const bool* backside, int n, const float* tri_g, const float* tri_f,
    const int* tri_i, int n_tris, const float* sph_f, int n_spheres, const float* g_t,
    const float* g_pos, const float* g_nrm, const float* g_gn, const float* g_tan,
    const float* g_uv, float* g_o, float* g_d, float* g_tri_g, float* g_tri_f, float* g_sph_f,
    const int* tri_anim, const int* sph_anim, const float* frames, long long fstride,
    float* g_frames, void* stream) {
    if (n > 0)
        assemble_hit_bwd_kernel<true>
            <<<blocks(n), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
                wpt_bwd::HitIn{o, d, t, prim, u, v, backside, n},
                wpt_bwd::Tables{tri_g, tri_f, tri_i, n_tris, sph_f, n_spheres},
                wpt_bwd::Cot{g_t, g_pos, g_nrm, g_gn, g_tan, g_uv},
                wpt_bwd::HitOut{g_o, g_d, g_tri_g, g_tri_f, g_sph_f},
                wpt_bwd::AnimIn{tri_anim, sph_anim, frames, fstride, g_frames});
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_env_radiance_bwd(const float* d, int n, int kind, const float* img, int h,
                                    int w, const float* rot, const float* g, float* g_d,
                                    float* g_img, float* g_const, void* stream) {
    if (n > 0)
        env_radiance_bwd_kernel<<<blocks(n), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            d, n, kind, reinterpret_cast<const float4*>(img), h, w, rot, g, g_d, g_img, g_const);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_rgl_bwd(const RglTables* t, const int* mid, const float* wi, const float* x,
                           int n, int sample, const float* g_f, float* g_rgb, float* g_ndf,
                           float* g_sigma, void* stream) {
    if (n > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const wpt_bwd::RglGrads out{g_rgb, g_ndf, g_sigma};
        if (sample)
            rgl_bwd_kernel<true><<<blocks(n), BLOCK, 0, s>>>(*t, mid, wi, x, n, g_f, out);
        else
            rgl_bwd_kernel<false><<<blocks(n), BLOCK, 0, s>>>(*t, mid, wi, x, n, g_f, out);
    }
    return static_cast<int>(cudaGetLastError());
}
