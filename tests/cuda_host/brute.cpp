// K1 (csrc/closest_hit.cu), K2 (csrc/any_hit.cu) and P0 (csrc/row_gather.cu)
// on the CPU through cuda_runtime.h: each launch's blocks one after another,
// each as its threads, with the grid the C entry points pick (here the
// resident count is cuda_runtime.h's 2 blocks of one SM, so blocks loop over
// tiles; P0 runs 2 blocks of its grid-stride loop). The *_device.cuh files
// are the sources up to their C entry points (the test cuts them there and
// gives K1's and K2's dynamic shared memory a static array); K2 (K2 defined)
// and P0 (P0 defined) are built apart: the sources name helpers alike.
#include <thread>
#include <vector>

#include "cuda_runtime.h"

#if defined(P0)
#include "row_gather_device.cuh"
#elif defined(K2)
#include "any_hit_device.cuh"
#else
#include "closest_hit_device.cuh"
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

#if defined(P0)
// wpt_row_gather's arguments but the stream; its launches, each of 2 blocks.
extern "C" int host_row_gather(const int* table, int rows, int cols, const int* idx, int n,
                               int* out) {
    const int step = rows_per_launch(cols);
    if (step == 0) return 1;
    const Divider by_cols = divider_of(cols);
    for (long long r0 = 0; r0 < n; r0 += step) {
        const int m = static_cast<int>(n - r0 < step ? n - r0 : step);
        run_blocks(2, BLOCK, [&] {
            row_gather_kernel(table, rows, cols, by_cols, idx + r0, m * cols, out + r0 * cols);
        });
    }
    return 0;
}
#elif defined(K2)
// wpt_any_hit's arguments but the stream; returns 2 where a small table takes
// a thread per lane, else whether the table was staged whole.
extern "C" int host_any_hit(const float* o, const float* d, const float* tmin, const float* tmax,
                            int n, const float* tri, int n_tris, const float* sph, int n_spheres,
                            float cx, float cy, float cz, bool* occluded) {
    const auto* tri4 = reinterpret_cast<const float4*>(tri);
    const auto* sph4 = reinterpret_cast<const float4*>(sph);
    if (direct(n_tris, n_spheres)) {
        run_blocks((n + DIRECT_BLOCK - 1) / DIRECT_BLOCK, DIRECT_BLOCK, [&] {
            any_hit_small_kernel(o, d, tmin, tmax, n, tri4, n_tris, sph4, n_spheres, cx, cy, cz,
                           occluded);
        });
        return 2;
    }
    const bool whole = staged_whole(n_tris, n_spheres);
    const int blocks = resident_blocks(n_tris, n_spheres);
    const int tile = wpt_queue::tile_lanes(n, blocks);
    run_blocks(min(blocks, (n + tile - 1) / tile), QBLOCK, [&] {
        if (whole)
            any_hit_kernel<true>(o, d, tmin, tmax, n, tile, tri4, n_tris, sph4, n_spheres, cx, cy,
                                 cz, occluded);
        else
            any_hit_kernel<false>(o, d, tmin, tmax, n, tile, tri4, n_tris, sph4, n_spheres, cx,
                                  cy, cz, occluded);
    });
    return whole;
}
#else
// wpt_closest_hit's arguments but the stream; returns whether the table was
// staged whole.
extern "C" int host_closest_hit(const float* o, const float* d, const float* tmin,
                                const float* tmax, int n, const float* tri, int n_tris,
                                const float* sph, int n_spheres, float cx, float cy, float cz,
                                float* t, int* prim, float* u, float* v) {
    const bool whole = staged_whole(n_tris, n_spheres);
    const int blocks = resident_blocks(n_tris, n_spheres);
    const int tile = wpt_queue::tile_lanes(n, blocks);
    const auto* tri4 = reinterpret_cast<const float4*>(tri);
    const auto* sph4 = reinterpret_cast<const float4*>(sph);
    run_blocks(min(blocks, (n + tile - 1) / tile), K1_BLOCK, [&] {
        if (whole)
            closest_hit_kernel<true>(o, d, tmin, tmax, n, tile, tri4, n_tris, sph4, n_spheres,
                                     cx, cy, cz, t, prim, u, v);
        else
            closest_hit_kernel<false>(o, d, tmin, tmax, n, tile, tri4, n_tris, sph4, n_spheres,
                                      cx, cy, cz, t, prim, u, v);
    });
    return whole;
}
#endif
