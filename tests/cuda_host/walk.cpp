// The walk of K5/K6 (csrc/bvh_common.cuh) on the CPU through cuda_runtime.h:
// `grid` blocks one after another, each as BLOCK threads, sharing one lane
// counter as a launch does; `variant` picks the instantiation as the
// kernels' entry points do (bit 0 sphere rows, bit 1 object-space rays).
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "bvh_common.cuh"

thread_local dim3 threadIdx, blockIdx;
dim3 gridDim;
WarpSync* g_warps;

using namespace wpt_bvh;

template <bool ANY, bool SPHERES, bool ANIMATED>
static void launch(const float* o, const float* d, const float* tmin, const float* tmax, int n,
                   const float* nodes, const float* rows, int n_tris, const float* frames,
                   int* spill, int grid, float* t, int* prim, float* u, float* v, bool* occ) {
    int counter = 0;
    gridDim = {static_cast<unsigned>(grid), 1, 1};
    for (int b = 0; b < grid; ++b) {
        std::vector<WarpSync> warps(BLOCK / 32);
        g_warps = warps.data();
        std::vector<std::thread> threads;
        for (int i = 0; i < BLOCK; ++i)
            threads.emplace_back([&, b, i] {
                threadIdx = {static_cast<unsigned>(i), 0, 0};
                blockIdx = {static_cast<unsigned>(b), 0, 0};
                walk_lanes<ANY, SPHERES, ANIMATED>(
                    o, d, tmin, tmax, n, reinterpret_cast<const float4*>(nodes),
                    reinterpret_cast<const float4*>(rows), n_tris, frames, &counter,
                    reinterpret_cast<int2*>(spill), t, prim, u, v, occ);
            });
        for (auto& th : threads) th.join();
    }
}

template <bool ANY>
static void dispatch(int variant, const float* o, const float* d, const float* tmin,
                     const float* tmax, int n, const float* nodes, const float* rows, int n_tris,
                     const float* frames, int* spill, int grid, float* t, int* prim, float* u,
                     float* v, bool* occ) {
    switch (variant) {
        case 1:
            return launch<ANY, true, false>(o, d, tmin, tmax, n, nodes, rows, n_tris, frames,
                                            spill, grid, t, prim, u, v, occ);
        case 2:
            return launch<ANY, false, true>(o, d, tmin, tmax, n, nodes, rows, n_tris, frames,
                                            spill, grid, t, prim, u, v, occ);
        case 3:
            return launch<ANY, true, true>(o, d, tmin, tmax, n, nodes, rows, n_tris, frames,
                                           spill, grid, t, prim, u, v, occ);
        default:
            return launch<ANY, false, false>(o, d, tmin, tmax, n, nodes, rows, n_tris, frames,
                                             spill, grid, t, prim, u, v, occ);
    }
}

extern "C" void host_closest_hit(int variant, const float* o, const float* d, const float* tmin,
                                 const float* tmax, int n, const float* nodes, const float* rows,
                                 int n_tris, const float* frames, int* spill, int grid, float* t,
                                 int* prim, float* u, float* v) {
    dispatch<false>(variant, o, d, tmin, tmax, n, nodes, rows, n_tris, frames, spill, grid, t,
                    prim, u, v, nullptr);
}

extern "C" void host_any_hit(int variant, const float* o, const float* d, const float* tmin,
                             const float* tmax, int n, const float* nodes, const float* rows,
                             int n_tris, const float* frames, int* spill, int grid, bool* occ) {
    dispatch<true>(variant, o, d, tmin, tmax, n, nodes, rows, n_tris, frames, spill, grid,
                   nullptr, nullptr, nullptr, nullptr, occ);
}
