// The sweeps KS1/KS2 (csrc/sweep_closest.cu, csrc/sweep_any.cu) and the hit
// assembly K3/K3a (csrc/assemble_hit.cu) on the CPU through cuda_runtime.h:
// each launch's blocks one after another, each as its threads, the sweeps
// with the layout and grid their C entry points pick (cuda_runtime.h's 2
// resident blocks: blocks loop over tiles). The *_device.cuh files are the
// sources up to their C entry points (the test cuts them there and gives the
// sweeps' dynamic shared memory a static array); assemble_hit.cu (its full
// form and its K4 form) has names of its own, so it is built apart (K3A
// defined).
#include <thread>
#include <vector>

#include "cuda_runtime.h"

#ifdef K3A
#include "assemble_hit_device.cuh"
#else
#include "sweep_any_device.cuh"
#include "sweep_closest_device.cuh"
#endif

thread_local dim3 threadIdx, blockIdx;
dim3 gridDim, blockDim;
WarpSync* g_warps;
BlockSync* g_block;

template <class Body>
static void run_blocks(int grid, int block, Body body) {
    gridDim = {static_cast<unsigned>(grid), 1, 1};
    blockDim = {static_cast<unsigned>(block), 1, 1};
    for (int b = 0; b < grid; ++b) {
        std::vector<WarpSync> warps(block / 32);
        g_warps = warps.data();
        BlockSync sync(block);
        g_block = &sync;
        std::vector<std::thread> threads;
        for (int i = 0; i < block; ++i)
            threads.emplace_back([&, b, i] {
                threadIdx = {static_cast<unsigned>(i), 0, 0};
                blockIdx = {static_cast<unsigned>(b), 0, 0};
                body();
            });
        for (auto& th : threads) th.join();
    }
}

#ifdef K3A
// wpt_assemble_hit_anim's arguments but the stream; frames null: K3.
extern "C" void host_assemble_hit_anim(const float* o, const float* d, const float* t,
                                       const int* prim, const float* u, const float* v, int n,
                                       const float* tri_f, const int* tri_i, int n_tris,
                                       const float* sph_f, const int* sph_mat, int n_spheres,
                                       const int* tri_anim, const int* sph_anim,
                                       const float* frames, long long fstride, float* pos,
                                       float* nrm, float* gn, float* tan, float* uv, int* mat,
                                       bool* backside) {
    const Tables tb{tri_f, tri_i, n_tris, sph_f, sph_mat, n_spheres};
    const Record out{pos, nrm, gn, tan, uv, mat, backside};
    run_blocks((n + BLOCK - 1) / BLOCK, BLOCK, [&] {
        if (frames == nullptr)
            assemble_hit_kernel<false>(o, d, t, prim, u, v, n, tb, Anim{}, out);
        else
            assemble_hit_kernel<true>(o, d, t, prim, u, v, n, tb,
                                      Anim{tri_anim, sph_anim, frames, fstride}, out);
    });
}

// The K4 form with the grid and tile of its C entry.
template <bool ANIM, int F>
static void k4_on_host(const float* o, const float* d, const float* t, const int* prim,
                       const float* u, const float* v, int n, const Tables& tb, const Anim& anim,
                       const Record& out) {
    if (n <= 0) return;
    const Launch l = k4_launch<ANIM, F>(n);
    run_blocks(l.grid, QBLOCK, [&] {
        assemble_hit_k4_kernel<ANIM, F>(o, d, t, prim, u, v, n, l.tile, tb, anim, out);
    });
}

template <int F>
static void k4_on_host(bool animated, const float* o, const float* d, const float* t,
                       const int* prim, const float* u, const float* v, int n, const Tables& tb,
                       const Anim& anim, const Record& out) {
    if (animated)
        k4_on_host<true, F>(o, d, t, prim, u, v, n, tb, anim, out);
    else
        k4_on_host<false, F>(o, d, t, prim, u, v, n, tb, anim, out);
}

// wpt_assemble_hit_k4's arguments but the stream; returns 1 (and runs
// nothing) for a field set the entry point refuses.
extern "C" int host_assemble_hit_k4(const float* o, const float* d, const float* t,
                                    const int* prim, const float* u, const float* v, int n,
                                    const float* tri_f, const int* tri_i, int n_tris,
                                    const float* sph_f, const int* sph_mat, int n_spheres,
                                    const int* tri_anim, const int* sph_anim,
                                    const float* frames, int fields, float* pos, float* nrm,
                                    float* gn, float* tan, int* mat, bool* backside) {
    const Tables tb{tri_f, tri_i, n_tris, sph_f, sph_mat, n_spheres};
    const Anim anim{tri_anim, sph_anim, frames};
    const Record out{pos, nrm, gn, tan, nullptr, mat, backside};
    const bool animated = frames != nullptr;
    switch (fields) {
        case F_DIFFUSE: k4_on_host<F_DIFFUSE>(animated, o, d, t, prim, u, v, n, tb, anim, out); break;
        case F_ENV: k4_on_host<F_ENV>(animated, o, d, t, prim, u, v, n, tb, anim, out); break;
        case F_LIT: k4_on_host<F_LIT>(animated, o, d, t, prim, u, v, n, tb, anim, out); break;
        default: return 1;
    }
    return 0;
}
#else
// wpt_sweep_closest's and wpt_sweep_any's arguments but the stream, launched
// with the layout and grid of their C entry points; each returns whether the
// table was staged whole.
extern "C" int host_sweep_closest(const float* o, const float* d, const float* tmin,
                                  const float* tmax, int n, const float* tri,
                                  const int* tri_anim, int n_tris, const float* sph,
                                  const int* sph_anim, int n_spheres, const float* frames,
                                  long long fstride, float* t, int* prim, float* u, float* v) {
    const bool whole = staged_whole(n_tris, n_spheres);
    const int blocks = resident_blocks(n_tris, n_spheres);
    const int tile = wpt_queue::tile_lanes(n, blocks);
    const auto* tri4 = reinterpret_cast<const float4*>(tri);
    const auto* sph4 = reinterpret_cast<const float4*>(sph);
    run_blocks(min(blocks, (n + tile - 1) / tile), wpt_queue::QBLOCK, [&] {
        if (whole)
            sweep_closest_kernel<true>(o, d, tmin, tmax, n, tile, tri4, tri_anim, n_tris, sph4,
                                       sph_anim, n_spheres, frames, fstride, t, prim, u, v);
        else
            sweep_closest_kernel<false>(o, d, tmin, tmax, n, tile, tri4, tri_anim, n_tris, sph4,
                                        sph_anim, n_spheres, frames, fstride, t, prim, u, v);
    });
    return whole;
}

extern "C" int host_sweep_any(const float* o, const float* d, const float* tmin,
                              const float* tmax, int n, const float* tri, const int* tri_anim,
                              int n_tris, const float* sph, const int* sph_anim, int n_spheres,
                              const float* frames, long long fstride, bool* occ) {
    const bool whole = staged_whole(n_tris, n_spheres);
    const int blocks = any_resident_blocks(n_tris, n_spheres);
    const int tile = wpt_queue::tile_lanes(n, blocks);
    const auto* tri4 = reinterpret_cast<const float4*>(tri);
    const auto* sph4 = reinterpret_cast<const float4*>(sph);
    run_blocks(min(blocks, (n + tile - 1) / tile), wpt_queue::QBLOCK, [&] {
        if (whole)
            sweep_any_kernel<true>(o, d, tmin, tmax, n, tile, tri4, tri_anim, n_tris, sph4,
                                   sph_anim, n_spheres, frames, fstride, occ);
        else
            sweep_any_kernel<false>(o, d, tmin, tmax, n, tile, tri4, tri_anim, n_tris, sph4,
                                    sph_anim, n_spheres, frames, fstride, occ);
    });
    return whole;
}
#endif
