// The walk of K5/K6 (csrc/bvh_common.cuh) on the CPU through cuda_runtime.h:
// `grid` blocks one after another, each as BLOCK threads, sharing one lane
// counter as a launch does.
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "bvh_common.cuh"

thread_local dim3 threadIdx, blockIdx;
dim3 gridDim;
WarpSync* g_warps;

using namespace wpt_bvh;

template <bool ANY>
static void launch(const float* o, const float* d, const float* tmin, const float* tmax, int n,
                   const float* nodes, const float* tri_v, int* spill, int grid, float* t,
                   int* prim, float* u, float* v, bool* occ) {
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
                walk_lanes<ANY>(o, d, tmin, tmax, n, reinterpret_cast<const float4*>(nodes),
                                reinterpret_cast<const float4*>(tri_v), &counter,
                                reinterpret_cast<int2*>(spill), t, prim, u, v, occ);
            });
        for (auto& th : threads) th.join();
    }
}

extern "C" void host_closest_hit(const float* o, const float* d, const float* tmin,
                                 const float* tmax, int n, const float* nodes, const float* tri_v,
                                 int* spill, int grid, float* t, int* prim, float* u, float* v) {
    launch<false>(o, d, tmin, tmax, n, nodes, tri_v, spill, grid, t, prim, u, v, nullptr);
}

extern "C" void host_any_hit(const float* o, const float* d, const float* tmin,
                             const float* tmax, int n, const float* nodes, const float* tri_v,
                             int* spill, int grid, bool* occ) {
    launch<true>(o, d, tmin, tmax, n, nodes, tri_v, spill, grid, nullptr, nullptr, nullptr,
                 nullptr, occ);
}
