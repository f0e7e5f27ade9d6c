// Backward kernels of a differentiable render (render/backward.py):
//
// P0T, wpt_row_scatter: grad_table[clamp(idx[i]), c] += grad_out[i, c], the
//   transpose of P0's row gather (tools/probe_pallas_gather.py:20 and the
//   packed-row gathers of the render path), which JAX's autodiff makes of
//   every gather. A frame's lanes land on a handful of rows (the material
//   rows: a few rows of 23 words), so element-wise float adds, into shared
//   memory (compare-and-swap loops on sm_90) or global memory, once
//   serialized on ~100 words. Now a thread takes a lane: the warp's lanes of
//   one row sum their cotangent rows by shuffles (group_sum on the row, 8
//   columns at a time, rows of zeros skipped), and one lane a group adds the
//   sums with plain adds into its warp's own copy of the table in shared
//   memory (no other thread writes it meanwhile; a table of up to 1536
//   words, 8 copies), with shared atomics into the block's copy (up to
//   12288 words) or with global atomics into the table, a row's columns
//   together; a block adds its copies' nonzero sums to the table at its end
//   (row_scatter_lanes<COPIES>, persistent blocks over contiguous chunks of
//   lanes; a lane's group found once, its columns summed 8 at a time).
// K3T, wpt_assemble_hit_bwd: the backward of K3's full form
//   (intersect.py:489-632) and of the winner's intersection
//   (intersect_mxu.py:164-257, the cast's t, u, v as the hit equations
//   give them). A lane's 36 terms (a triangle's tri_f and tri_g rows, a
//   sphere's 4 words) land on a few rows: 131072 Cornell lanes on 36
//   triangles once made ~3600 float atomics per table word, which
//   serialize. So the launch is persistent (as many blocks as fit, each a
//   contiguous chunk of lanes), the warp's lanes with one winner sum their
//   terms by shuffles first (backward_common.cuh group_sum: __match_any_sync
//   on the row), and one lane of each group adds the sums into the block's
//   copy of the tables in shared memory (up to 48 KB of them, every
//   differentiable frame's scene), whose nonzero words the block adds to
//   the tables at its end; larger tables (a mesh) take the same warp sums
//   with global atomics (assemble_hit_bwd_lanes<ANIM, SHARED>).
// K3aT, wpt_assemble_hit_anim_bwd: the same for K3a, the animated branch
//   (intersect.py:505-530, :605-620): the winner's hit recomputed in its
//   animation's object space from the lane's frame row, the world
//   normals' and tangent's cotangents taken back through their
//   normalizations and the normal and forward maps, and the cotangent of
//   the winner's 30-float frame row: summed like the rows into the [A, 30]
//   rows of one instant (warp groups on the animation id, then the block's
//   shared copy beside the tables) or stored to the lane's own row of [N,
//   A, 30] per-ray rows.
// K8T, wpt_env_radiance_bwd: the backward of K8's radiance lookup
//   (envmap.py:118-201), equirect and cube lanes one thread each. A warp's
//   lanes are neighbouring pixels whose four taps fall on a few texels of a
//   small sky, so the taps' float atomics once serialized by the dozen per
//   address (32-40x the kernel's byte bound). Now the launch is
//   persistent, one chunk of lanes a block; the warp's lanes of one lookup
//   cell sum their 16 tap words by shuffles (group_sum on the cell), and one
//   lane a group adds each tap's 4 words to the map's cotangent with one of
//   sm_90's float4 atomics (env_radiance_bwd_lanes<ROT>). A block's copy of
//   the map in shared memory lost to this on the skies the frames render:
//   float adds in shared memory are compare-and-swap loops, which a sky's
//   few texels under a warp contend on. A constant sky's radiance cotangent
//   is the lanes' sum: per thread, then per block (one atomicAdd per block
//   and channel). Where the map's rotation is on the tape, each lane's term
//   of its cotangent (that of dm = R(conj q) d with respect to q) is summed
//   per thread and per block in the same way. Under a lane mask (K8's
//   masked lanes, whose radiance is a constant) a lane outside it carries
//   no cotangent and gets g_d = 0.
// K8T's sample, wpt_env_sample_bwd: the backward of K8's sample
//   (envmap.py:201-234) into the rotation, dir = R(q) d_map with d_map
//   recomputed from the uniforms; the pdf carries none. Each lane's term
//   lands on the same 4 words: a block of 256 lanes once added its sum by
//   4 scalar atomics, ~4096 on one address for a frame's lanes, and every
//   lane recomputed its sample, though a render's NEE directions carry a
//   cotangent on a few per cent of the lanes. Now the launch is persistent
//   (a chunk of lanes a block of 1024 threads), a lane whose cotangent is
//   zero is skipped before its uniforms are read, each block leaves its sum
//   in a partial, and the last block to finish sums the partials in block
//   order (env_sample_bwd_lanes): no atomic on the output, which needs no
//   zeroing launch, and the same sum in every run.
// K7T, wpt_rgl_bwd: the backward of K7's eval or sample (materials/rgl.py
//   rgl_eval :633, rgl_sample :650 of the JAX package, through its autodiff).
//   A thread per lane (rgl_bwd_kernel<SAMPLE, FULL, SHARED>,
//   backward_common.cuh rgl_bwd_lanes). Its tail form (FULL false), where
//   only the reflectance tail's tables are on the tape: rgb (param- and
//   spatial-bilinear cells), ndf and sigma (bilinear cells); the lane
//   recomputes its forward up to the warp positions. Its full form (FULL
//   true), where a warp table, a parameter grid or a lane direction is on
//   the tape: the lane runs reverse mode by hand through the whole forward
//   (the parameter weights, both warps' inversion or sampling and density,
//   the tail's terms shared with the tail form, the jacobian, the half
//   vector or the sampled direction), and writes its wi (and eval's wo)
//   cotangents. Each lane's table terms land on a few cells of tiny tables
//   (a synthetic material's rgb 8 x 8 cells a slice, 16 x 16 warps): one
//   float atomic a term once serialized by the thousand per word. Now the
//   lane leaves its terms per cell (rgl_bwd_lane's RglTerms), the warp's
//   lanes of one corner slice and cell sum them by shuffles (group_sum),
//   and one lane a group adds the sums into the block's copy of the form's
//   tables in shared memory where they fit 48 KB (two synthetic materials'
//   every table: 33.5 KB), its nonzero words added to the tables at the
//   block's end; larger tables (a measured dataset's 128 x 128 warps) take
//   the warps' sums with global atomics. Persistent blocks over contiguous
//   chunks of lanes, so every warp reaches every vote.
//
// Bound on the card: bytes (each lane's inputs and cotangents read once,
// its ray cotangents written once, the tables read and written once) for
// K3T and K8T, the atomics' traffic for P0T. Built with the other kernels:
// -fmad=false, no fast math. Float atomics make the sums' order vary from
// run to run: the checks
// (utils/grad_check.py) hold the kernels to their plain versions relative
// to the sum of the terms' magnitudes.
#include <cuda_runtime.h>

#include "backward_common.cuh"

namespace {

template <int COPIES>
__global__ void __launch_bounds__(wpt_bwd::SCATTER_BLOCK)
row_scatter_kernel(const float* __restrict__ g, const int* __restrict__ idx, int n, int cols,
                   int rows, float* __restrict__ out, int chunk) {
    extern __shared__ float acc[];
    wpt_bwd::row_scatter_lanes<COPIES>(g, idx, n, cols, rows, out, chunk, acc);
}

template <bool ANIM, bool SHARED>
__global__ void __launch_bounds__(wpt_bwd::HIT_BLOCK)
assemble_hit_bwd_kernel(wpt_bwd::HitIn in, wpt_bwd::Tables tb, wpt_bwd::Cot c,
                        wpt_bwd::HitOut out, wpt_bwd::AnimIn an, int n_anims, int chunk) {
    extern __shared__ float acc[];
    wpt_bwd::assemble_hit_bwd_lanes<ANIM, SHARED>(in, tb, c, out, an, n_anims, chunk, acc);
}

template <bool ROT>
__global__ void __launch_bounds__(wpt_bwd::SKY_BLOCK)
env_radiance_bwd_kernel(const float* __restrict__ d, int n, int kind,
                        const float4* __restrict__ img, int h, int w,
                        const float* __restrict__ rot, const float* __restrict__ g,
                        const bool* __restrict__ active, float* __restrict__ g_d,
                        float* __restrict__ g_img, float* __restrict__ g_const,
                        float* __restrict__ g_rot, int chunk) {
    wpt_bwd::env_radiance_bwd_lanes<ROT>(d, n, kind, img, h, w, rot, g, active, g_d, g_img,
                                         g_const, g_rot, chunk);
}

__global__ void __launch_bounds__(wpt_bwd::SAMPLE_BLOCK)
env_sample_bwd_kernel(const float* __restrict__ u3, int n, const float* __restrict__ pdf,
                      const float* __restrict__ alias_prob, const int* __restrict__ alias_idx,
                      int res, const float* __restrict__ rot, const float* __restrict__ g_dir,
                      const bool* __restrict__ active, float4* __restrict__ partial,
                      unsigned* __restrict__ done, float* __restrict__ g_rot, int chunk) {
    wpt_bwd::env_sample_bwd_lanes(u3, n, pdf, alias_prob, alias_idx, res, rot, g_dir, active,
                                  partial, done, g_rot, chunk);
}

template <bool SAMPLE, bool FULL, bool SHARED>
__global__ void __launch_bounds__(wpt_bwd::RGL_BLOCK)
rgl_bwd_kernel(RglTables t, RglOut out, const int* __restrict__ mids,
               const float* __restrict__ wi, const float* __restrict__ x, int n,
               const float* __restrict__ g_f, const float* __restrict__ g_pdf,
               const float* __restrict__ g_wo, int chunk) {
    extern __shared__ float acc[];
    wpt_bwd::rgl_bwd_lanes<SAMPLE, FULL, SHARED>(t, out, mids, wi, x, n, g_f, g_pdf, g_wo, chunk,
                                                 acc);
}

// The blocks of `kernel` (`threads` each, `smem` bytes of dynamic shared
// memory, at most 48 KB) resident on the device at once: a persistent
// launch's grid. Cached per kernel, dynamic shared memory and device, so
// that only a kernel's first launch queries the occupancy.
template <class K>
int resident_blocks(K kernel, int threads, long long smem) {
    constexpr int SLOTS = 64;
    struct Slot {
        const void* kernel;
        long long smem;
        int dev, blocks;
    };
    static Slot slots[SLOTS];
    static int used = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    const void* key = reinterpret_cast<const void*>(kernel);
    for (int k = 0; k < used; ++k)
        if (slots[k].kernel == key && slots[k].smem == smem && slots[k].dev == dev)
            return slots[k].blocks;
    int sms = 1, per = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads,
                                                  static_cast<size_t>(smem));
    const int blocks = max(per, 1) * sms;   // none fit: the launch fails and reports it
    if (per > 0 && used < SLOTS) slots[used++] = Slot{key, smem, dev, blocks};
    return blocks;
}

// K3T (K3aT with ANIM): its tables (and K3aT's rows of one instant) summed
// in shared memory where they fit HIT_SMEM_WORDS, else with global atomics.
template <bool ANIM>
int launch_assemble_hit_bwd(const wpt_bwd::HitIn& in, const wpt_bwd::Tables& tb,
                            const wpt_bwd::Cot& c, const wpt_bwd::HitOut& out,
                            const wpt_bwd::AnimIn& an, int n_anims, cudaStream_t s) {
    const int rows = ANIM && an.stride == 0 ? n_anims : 0;
    constexpr int T = wpt_bwd::HIT_BLOCK;
    int chunk = 0;
    if (wpt_bwd::hit_takes_shared(tb.n_tris, tb.n_spheres, rows, wpt_bwd::HIT_SMEM_WORDS)) {
        const long long smem = wpt_bwd::hit_table_words(tb.n_tris, tb.n_spheres, rows) * 4;
        const int grid = wpt_bwd::chunked_grid(
            in.n, resident_blocks(assemble_hit_bwd_kernel<ANIM, true>, T, smem), T, &chunk);
        assemble_hit_bwd_kernel<ANIM, true>
            <<<grid, T, smem, s>>>(in, tb, c, out, an, n_anims, chunk);
    } else {
        const int grid = wpt_bwd::chunked_grid(
            in.n, resident_blocks(assemble_hit_bwd_kernel<ANIM, false>, T, 0), T, &chunk);
        assemble_hit_bwd_kernel<ANIM, false>
            <<<grid, T, 0, s>>>(in, tb, c, out, an, n_anims, chunk);
    }
    return static_cast<int>(cudaGetLastError());
}

template <bool ROT>
void launch_env_radiance_bwd(const float* d, int n, int kind, const float4* img, int h, int w,
                             const float* rot, const float* g, const bool* active, float* g_d,
                             float* g_img, float* g_const, float* g_rot, cudaStream_t s) {
    constexpr int T = wpt_bwd::SKY_BLOCK;
    int chunk = 0;
    const int grid = wpt_bwd::chunked_grid(
        n, resident_blocks(env_radiance_bwd_kernel<ROT>, T, 0), T, &chunk);
    env_radiance_bwd_kernel<ROT><<<grid, T, 0, s>>>(d, n, kind, img, h, w, rot, g, active, g_d,
                                                    g_img, g_const, g_rot, chunk);
}

template <int COPIES>
void launch_row_scatter(const float* g, const int* idx, int n, int cols, int rows, float* out,
                        cudaStream_t s) {
    constexpr int T = wpt_bwd::SCATTER_BLOCK;
    const long long smem = static_cast<long long>(rows) * cols * COPIES * 4;
    int chunk = 0;
    const int grid = wpt_bwd::chunked_grid(
        n, resident_blocks(row_scatter_kernel<COPIES>, T, smem), T, &chunk);
    row_scatter_kernel<COPIES><<<grid, T, smem, s>>>(g, idx, n, cols, rows, out, chunk);
}

// K7T: the form's tables summed in shared memory where they fit
// RGL_SMEM_WORDS, else with global atomics.
template <bool SAMPLE, bool FULL>
void launch_rgl_bwd(const RglTables& t, const RglOut& out, const int* mid, const float* wi,
                    const float* x, int n, const float* g_f, const float* g_pdf,
                    const float* g_wo, cudaStream_t s) {
    constexpr int T = wpt_bwd::RGL_BLOCK;
    int chunk = 0;
    if (wpt_bwd::rgl_takes_shared(t, FULL, wpt_bwd::RGL_SMEM_WORDS)) {
        long long words[wpt_bwd::RGL_TABLES];
        const long long smem = wpt_bwd::rgl_table_words(t, FULL, words) * 4;
        // the copy beside the kernel's static queue: up to 48 KB of it
        cudaFuncSetAttribute(rgl_bwd_kernel<SAMPLE, FULL, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        const int grid = wpt_bwd::chunked_grid(
            n, resident_blocks(rgl_bwd_kernel<SAMPLE, FULL, true>, T, smem), T, &chunk);
        rgl_bwd_kernel<SAMPLE, FULL, true>
            <<<grid, T, smem, s>>>(t, out, mid, wi, x, n, g_f, g_pdf, g_wo, chunk);
    } else {
        const int grid = wpt_bwd::chunked_grid(
            n, resident_blocks(rgl_bwd_kernel<SAMPLE, FULL, false>, T, 0), T, &chunk);
        rgl_bwd_kernel<SAMPLE, FULL, false>
            <<<grid, T, 0, s>>>(t, out, mid, wi, x, n, g_f, g_pdf, g_wo, chunk);
    }
}

}  // namespace

// P0T: out [rows, cols] (zeroed by the caller) += the rows of g [n, cols]
// at clamp(idx).
extern "C" int wpt_row_scatter(const float* g, const int* idx, int n, int cols, int rows,
                               float* out, void* stream) {
    if (n > 0 && cols > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        switch (wpt_bwd::scatter_copies(rows, cols, wpt_bwd::SCATTER_SMEM_WORDS)) {
        case wpt_bwd::SCATTER_WARPS:
            launch_row_scatter<wpt_bwd::SCATTER_WARPS>(g, idx, n, cols, rows, out, s);
            break;
        case 1: launch_row_scatter<1>(g, idx, n, cols, rows, out, s); break;
        default: launch_row_scatter<0>(g, idx, n, cols, rows, out, s);
        }
    }
    return static_cast<int>(cudaGetLastError());
}

// The tables' cotangents are zeroed by the caller.
extern "C" int wpt_assemble_hit_bwd(const float* o, const float* d, const float* t,
                                    const int* prim, const float* u, const float* v,
                                    const bool* backside, int n, const float* tri_g,
                                    const float* tri_f, const int* tri_i, int n_tris,
                                    const float* sph_f, int n_spheres, const float* g_t,
                                    const float* g_pos, const float* g_nrm, const float* g_gn,
                                    const float* g_tan, const float* g_uv, float* g_o,
                                    float* g_d, float* g_tri_g, float* g_tri_f, float* g_sph_f,
                                    void* stream) {
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    return launch_assemble_hit_bwd<false>(
        wpt_bwd::HitIn{o, d, t, prim, u, v, backside, n},
        wpt_bwd::Tables{tri_g, tri_f, tri_i, n_tris, sph_f, n_spheres},
        wpt_bwd::Cot{g_t, g_pos, g_nrm, g_gn, g_tan, g_uv},
        wpt_bwd::HitOut{g_o, g_d, g_tri_g, g_tri_f, g_sph_f}, wpt_bwd::AnimIn{}, 0,
        static_cast<cudaStream_t>(stream));
}

// K3aT: wpt_assemble_hit_bwd's arguments, then the winners' animation ids,
// the frame rows ([A, 30] with fstride 0, or [N, A, 30] with fstride A 30),
// A and the rows' cotangents (zeroed by the caller).
extern "C" int wpt_assemble_hit_anim_bwd(
    const float* o, const float* d, const float* t, const int* prim, const float* u,
    const float* v, const bool* backside, int n, const float* tri_g, const float* tri_f,
    const int* tri_i, int n_tris, const float* sph_f, int n_spheres, const float* g_t,
    const float* g_pos, const float* g_nrm, const float* g_gn, const float* g_tan,
    const float* g_uv, float* g_o, float* g_d, float* g_tri_g, float* g_tri_f, float* g_sph_f,
    const int* tri_anim, const int* sph_anim, const float* frames, long long fstride,
    int n_anims, float* g_frames, void* stream) {
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    return launch_assemble_hit_bwd<true>(
        wpt_bwd::HitIn{o, d, t, prim, u, v, backside, n},
        wpt_bwd::Tables{tri_g, tri_f, tri_i, n_tris, sph_f, n_spheres},
        wpt_bwd::Cot{g_t, g_pos, g_nrm, g_gn, g_tan, g_uv},
        wpt_bwd::HitOut{g_o, g_d, g_tri_g, g_tri_f, g_sph_f},
        wpt_bwd::AnimIn{tri_anim, sph_anim, frames, fstride, g_frames}, n_anims,
        static_cast<cudaStream_t>(stream));
}

// g_img and g_const are zeroed by the caller; g_rot: the rotation's
// cotangent [4] (zeroed by the caller), or null where the rotation carries
// none: then the launch skips the rotation's term and its reduction.
// active: a bool per lane (a lane outside it carries no cotangent and gets
// g_d = 0), or null for every lane.
extern "C" int wpt_env_radiance_bwd(const float* d, int n, int kind, const float* img, int h,
                                    int w, const float* rot, const float* g, const bool* active,
                                    float* g_d, float* g_img, float* g_const, float* g_rot,
                                    void* stream) {
    if (n > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const float4* im = reinterpret_cast<const float4*>(img);
        if (g_rot != nullptr && kind != 3)
            launch_env_radiance_bwd<true>(d, n, kind, im, h, w, rot, g, active, g_d, g_img,
                                          g_const, g_rot, s);
        else
            launch_env_radiance_bwd<false>(d, n, kind, im, h, w, rot, g, active, g_d, g_img,
                                           g_const, g_rot, s);
    }
    return static_cast<int>(cudaGetLastError());
}

// The sample's backward: the rotation's cotangent g_rot [4] (written; 0
// for n = 0) from that of the sampled directions g_dir [N, 3] on the lanes
// of `active` (a bool per lane, or null for every lane). partial: room for
// `blocks` per-block sums (16 B each); done: a counter that is 0 at the
// call and 0 again after it (one per stream).
extern "C" int wpt_env_sample_bwd(const float* u3, int n, const float* pdf,
                                  const float* alias_prob, const int* alias_idx, int res,
                                  const float* rot, const float* g_dir, const bool* active,
                                  float* partial, int blocks, unsigned* done, float* g_rot,
                                  void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= 0) return static_cast<int>(cudaMemsetAsync(g_rot, 0, 4 * sizeof(float), s));
    constexpr int T = wpt_bwd::SAMPLE_BLOCK;
    int chunk = 0;
    const int grid =
        wpt_bwd::chunked_grid(n, resident_blocks(env_sample_bwd_kernel, T, 0), T, &chunk);
    if (grid > blocks) return static_cast<int>(cudaErrorInvalidValue);
    env_sample_bwd_kernel<<<grid, T, 0, s>>>(u3, n, pdf, alias_prob, alias_idx, res, rot, g_dir,
                                             active, reinterpret_cast<float4*>(partial), done,
                                             g_rot, chunk);
    return static_cast<int>(cudaGetLastError());
}

// K7T: the tail form (full 0: rgb, ndf and sigma from g_f alone; g_pdf and
// g_wo unread) or the full form (full 1: every table of RglOut, the lanes'
// wi and eval's wo cotangents, from g_f, g_pdf and sample's g_wo).
extern "C" int wpt_rgl_bwd(const RglTables* t, const RglOut* out, const int* mid, const float* wi,
                           const float* x, int n, int sample, int full, const float* g_f,
                           const float* g_pdf, const float* g_wo, void* stream) {
    if (n > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        if (full && sample) launch_rgl_bwd<true, true>(*t, *out, mid, wi, x, n, g_f, g_pdf, g_wo, s);
        else if (full) launch_rgl_bwd<false, true>(*t, *out, mid, wi, x, n, g_f, g_pdf, g_wo, s);
        else if (sample) launch_rgl_bwd<true, false>(*t, *out, mid, wi, x, n, g_f, g_pdf, g_wo, s);
        else launch_rgl_bwd<false, false>(*t, *out, mid, wi, x, n, g_f, g_pdf, g_wo, s);
    }
    return static_cast<int>(cudaGetLastError());
}
