// K3T's, K3aT's, K8T's, K7T's and P0T's device code
// (csrc/backward_common.cuh) on the CPU through cuda_runtime.h, with the
// entry points' own arguments but the stream (csrc/backward.cu). K3T,
// K3aT, K8T, K7T and P0T run as their kernels do: the launch's blocks one
// after another, each as its threads, over the chunks of a persistent grid
// of 2 resident blocks (cuda_runtime.h's one SM), each block's dynamic
// shared memory a fresh array; K3T, K3aT, K7T and P0T choose their path by
// the kernels' own rule (hit_takes_shared, rgl_takes_shared,
// scatter_copies) under the limit in words given in place of the card's
// (below 0: the card's; 0 forces the global path, a large one the shared
// one). K8T's sample backward runs as its kernel does too: persistent
// blocks, the lanes of zero cotangent skipped, the last block summing the
// blocks' partials.
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "backward_common.cuh"

thread_local dim3 threadIdx, blockIdx;
dim3 gridDim, blockDim;
WarpSync* g_warps;
BlockSync* g_block;

constexpr int RESIDENT = 2;

// The launch's blocks in turn, each with `smem_words` floats of dynamic
// shared memory, filled with NaN (the kernel zeroes it), handed to body(acc).
template <class Body>
static void run_blocks(int grid, int block, long long smem_words, Body body) {
    gridDim = {static_cast<unsigned>(grid), 1, 1};
    blockDim = {static_cast<unsigned>(block), 1, 1};
    for (int b = 0; b < grid; ++b) {
        std::vector<float4> smem((smem_words + 3) / 4 + 1);
        float* acc = reinterpret_cast<float*>(smem.data());
        for (long long k = 0; k < smem_words; ++k) acc[k] = std::nanf("");   // the kernel zeroes it
        std::vector<WarpSync> warps(block / 32);
        g_warps = warps.data();
        BlockSync sync(block);
        g_block = &sync;
        std::vector<std::thread> threads;
        for (int i = 0; i < block; ++i)
            threads.emplace_back([&, b, i] {
                threadIdx = {static_cast<unsigned>(i), 0, 0};
                blockIdx = {static_cast<unsigned>(b), 0, 0};
                body(acc);
            });
        for (auto& th : threads) th.join();
    }
}

template <bool ANIM>
static int hit_bwd(const wpt_bwd::HitIn& in, const wpt_bwd::Tables& tb, const wpt_bwd::Cot& c,
                   const wpt_bwd::HitOut& out, const wpt_bwd::AnimIn& an, int n_anims,
                   long long limit_words) {
    if (in.n <= 0) return 0;
    const int rows = ANIM && an.stride == 0 ? n_anims : 0;
    const long long words = wpt_bwd::hit_table_words(tb.n_tris, tb.n_spheres, rows);
    const bool shared = wpt_bwd::hit_takes_shared(
        tb.n_tris, tb.n_spheres, rows, limit_words < 0 ? wpt_bwd::HIT_SMEM_WORDS : limit_words);
    int chunk = 0;
    const int grid = wpt_bwd::chunked_grid(in.n, RESIDENT, wpt_bwd::HIT_BLOCK, &chunk);
    run_blocks(grid, wpt_bwd::HIT_BLOCK, shared ? words : 0, [&](float* acc) {
        if (shared)
            wpt_bwd::assemble_hit_bwd_lanes<ANIM, true>(in, tb, c, out, an, n_anims, chunk, acc);
        else
            wpt_bwd::assemble_hit_bwd_lanes<ANIM, false>(in, tb, c, out, an, n_anims, chunk, acc);
    });
    return shared;
}

// wpt_assemble_hit_bwd's arguments but the stream, then the shared path's
// limit in words (below 0: the card's); returns 1 where the tables were
// summed in shared memory, 0 where with global atomics.
extern "C" int host_assemble_hit_bwd(const float* o, const float* d, const float* t,
                                     const int* prim, const float* u, const float* v,
                                     const bool* backside, int n, const float* tri_g,
                                     const float* tri_f, const int* tri_i, int n_tris,
                                     const float* sph_f, int n_spheres, const float* g_t,
                                     const float* g_pos, const float* g_nrm, const float* g_gn,
                                     const float* g_tan, const float* g_uv, float* g_o,
                                     float* g_d, float* g_tri_g, float* g_tri_f,
                                     float* g_sph_f, long long limit_words) {
    return hit_bwd<false>(wpt_bwd::HitIn{o, d, t, prim, u, v, backside, n},
                          wpt_bwd::Tables{tri_g, tri_f, tri_i, n_tris, sph_f, n_spheres},
                          wpt_bwd::Cot{g_t, g_pos, g_nrm, g_gn, g_tan, g_uv},
                          wpt_bwd::HitOut{g_o, g_d, g_tri_g, g_tri_f, g_sph_f},
                          wpt_bwd::AnimIn{}, 0, limit_words);
}

// K3aT: wpt_assemble_hit_anim_bwd's arguments but the stream, then the limit.
extern "C" int host_assemble_hit_anim_bwd(
    const float* o, const float* d, const float* t, const int* prim, const float* u,
    const float* v, const bool* backside, int n, const float* tri_g, const float* tri_f,
    const int* tri_i, int n_tris, const float* sph_f, int n_spheres, const float* g_t,
    const float* g_pos, const float* g_nrm, const float* g_gn, const float* g_tan,
    const float* g_uv, float* g_o, float* g_d, float* g_tri_g, float* g_tri_f, float* g_sph_f,
    const int* tri_anim, const int* sph_anim, const float* frames, long long fstride,
    int n_anims, float* g_frames, long long limit_words) {
    return hit_bwd<true>(wpt_bwd::HitIn{o, d, t, prim, u, v, backside, n},
                         wpt_bwd::Tables{tri_g, tri_f, tri_i, n_tris, sph_f, n_spheres},
                         wpt_bwd::Cot{g_t, g_pos, g_nrm, g_gn, g_tan, g_uv},
                         wpt_bwd::HitOut{g_o, g_d, g_tri_g, g_tri_f, g_sph_f},
                         wpt_bwd::AnimIn{tri_anim, sph_anim, frames, fstride, g_frames}, n_anims,
                         limit_words);
}

// wpt_env_radiance_bwd's arguments but the stream; active and g_rot may be
// null.
extern "C" int host_env_radiance_bwd(const float* d, int n, int kind, const float* img, int h,
                                     int w, const float* rot, const float* g, const bool* active,
                                     float* g_d, float* g_img, float* g_const, float* g_rot) {
    if (n <= 0) return 0;
    const float4* im = reinterpret_cast<const float4*>(img);
    int chunk = 0;
    const int grid = wpt_bwd::chunked_grid(n, RESIDENT, wpt_bwd::SKY_BLOCK, &chunk);
    run_blocks(grid, wpt_bwd::SKY_BLOCK, 0, [&](float*) {
        if (g_rot != nullptr && kind != 3)
            wpt_bwd::env_radiance_bwd_lanes<true>(d, n, kind, im, h, w, rot, g, active, g_d,
                                                  g_img, g_const, g_rot, chunk);
        else
            wpt_bwd::env_radiance_bwd_lanes<false>(d, n, kind, im, h, w, rot, g, active, g_d,
                                                   g_img, g_const, g_rot, chunk);
    });
    return 0;
}

// wpt_env_sample_bwd's arguments but the stream.
extern "C" int host_env_sample_bwd(const float* u3, int n, const float* pdf,
                                   const float* alias_prob, const int* alias_idx, int res,
                                   const float* rot, const float* g_dir, const bool* active,
                                   float* partial, int blocks, unsigned* done, float* g_rot) {
    if (n <= 0) {
        for (int k = 0; k < 4; ++k) g_rot[k] = 0.f;
        return 0;
    }
    int chunk = 0;
    const int grid = wpt_bwd::chunked_grid(n, RESIDENT, wpt_bwd::SAMPLE_BLOCK, &chunk);
    if (grid > blocks) return -1;
    run_blocks(grid, wpt_bwd::SAMPLE_BLOCK, 0, [&](float*) {
        wpt_bwd::env_sample_bwd_lanes(u3, n, pdf, alias_prob, alias_idx, res, rot, g_dir, active,
                                      reinterpret_cast<float4*>(partial), done, g_rot, chunk);
    });
    return 0;
}

// wpt_rgl_bwd's arguments but the stream, then the shared path's limit in
// words (below 0: the card's, RGL_SMEM_WORDS); returns 1 where the tables
// were summed in shared memory, 0 where with global atomics.
extern "C" int host_rgl_bwd(const RglTables* t, const RglOut* out, const int* mid, const float* wi,
                            const float* x, int n, int sample, int full, const float* g_f,
                            const float* g_pdf, const float* g_wo, long long limit_words) {
    if (n <= 0) return 0;
    long long words[wpt_bwd::RGL_TABLES];
    const long long total = wpt_bwd::rgl_table_words(*t, full != 0, words);
    const bool shared = wpt_bwd::rgl_takes_shared(
        *t, full != 0, limit_words < 0 ? wpt_bwd::RGL_SMEM_WORDS : limit_words);
    int chunk = 0;
    const int grid = wpt_bwd::chunked_grid(n, RESIDENT, wpt_bwd::RGL_BLOCK, &chunk);
    run_blocks(grid, wpt_bwd::RGL_BLOCK, shared ? total : 0, [&](float* acc) {
#define WPT_HOST_RGL(S, F)                                                                      \
    (shared ? wpt_bwd::rgl_bwd_lanes<S, F, true>(*t, *out, mid, wi, x, n, g_f, g_pdf, g_wo,  \
                                                  chunk, acc)                                \
            : wpt_bwd::rgl_bwd_lanes<S, F, false>(*t, *out, mid, wi, x, n, g_f, g_pdf, g_wo, \
                                                   chunk, acc))
        if (full && sample) WPT_HOST_RGL(true, true);
        else if (full) WPT_HOST_RGL(false, true);
        else if (sample) WPT_HOST_RGL(true, false);
        else WPT_HOST_RGL(false, false);
#undef WPT_HOST_RGL
    });
    return shared;
}

// wpt_row_scatter's arguments but the stream, then the shared path's limit
// in words (below 0: the card's, SCATTER_SMEM_WORDS); returns the copies
// summed in shared memory (SCATTER_WARPS, 1, or 0: global atomics).
extern "C" int host_row_scatter(const float* g, const int* idx, int n, int cols, int rows,
                                float* out, long long limit_words) {
    const int copies = wpt_bwd::scatter_copies(
        rows, cols, limit_words < 0 ? wpt_bwd::SCATTER_SMEM_WORDS : limit_words);
    if (n <= 0 || cols <= 0) return copies;
    int chunk = 0;
    const int grid = wpt_bwd::chunked_grid(n, RESIDENT, wpt_bwd::SCATTER_BLOCK, &chunk);
    const long long smem = static_cast<long long>(rows) * cols * copies;
    run_blocks(grid, wpt_bwd::SCATTER_BLOCK, smem, [&](float* acc) {
        if (copies == wpt_bwd::SCATTER_WARPS)
            wpt_bwd::row_scatter_lanes<wpt_bwd::SCATTER_WARPS>(g, idx, n, cols, rows, out, chunk,
                                                               acc);
        else if (copies == 1)
            wpt_bwd::row_scatter_lanes<1>(g, idx, n, cols, rows, out, chunk, acc);
        else
            wpt_bwd::row_scatter_lanes<0>(g, idx, n, cols, rows, out, chunk, acc);
    });
    return copies;
}
