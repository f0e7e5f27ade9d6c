// The walk of K5/K6 (csrc/bvh_common.cuh) on the CPU through cuda_runtime.h:
// the launch's blocks one after another, each as BLOCK threads, sharing one
// lane counter as a launch does; `variant` picks the instantiation as the
// kernels' entry points do (bit 0 sphere rows, bit 1 object-space rays, bit
// 2 the tree staged in shared memory), and the grid is theirs for
// `resident` blocks on the card. The test gives the walk's dynamic shared
// memory a static array (wpt_bvh_smem).
#include <thread>
#include <vector>

#include "cuda_runtime.h"
#include "bvh_common.cuh"

thread_local dim3 threadIdx, blockIdx;
dim3 gridDim, blockDim;
WarpSync* g_warps;
BlockSync* g_block;

using namespace wpt_bvh;

template <bool ANY, bool SPHERES, bool ANIMATED, bool STAGED>
static void launch(const Rays& rays, const Tree& tree, int* spill, int resident, const Out& out) {
    const int grid = std::min(resident, (rays.n + BLOCK - 1) / BLOCK);
    // A launch of one wave must not read its counter: poison it.
    int counter = rays.n > grid * BLOCK ? 0 : 1 << 30;
    gridDim = {static_cast<unsigned>(grid), 1, 1};
    blockDim = {static_cast<unsigned>(BLOCK), 1, 1};
    for (int b = 0; b < grid; ++b) {
        std::vector<WarpSync> warps(BLOCK / 32);
        g_warps = warps.data();
        BlockSync sync(BLOCK);
        g_block = &sync;
        std::vector<std::thread> threads;
        for (int i = 0; i < BLOCK; ++i)
            threads.emplace_back([&, b, i] {
                threadIdx = {static_cast<unsigned>(i), 0, 0};
                blockIdx = {static_cast<unsigned>(b), 0, 0};
                walk_lanes<ANY, SPHERES, ANIMATED, STAGED>(rays, tree, &counter,
                                                           reinterpret_cast<int2*>(spill), out);
            });
        for (auto& th : threads) th.join();
    }
}

template <bool ANY>
static void dispatch(int variant, const Rays& rays, const Tree& tree, int* spill, int resident,
                     const Out& out) {
    switch (variant & 7) {
        case 1: return launch<ANY, true, false, false>(rays, tree, spill, resident, out);
        case 2: return launch<ANY, false, true, false>(rays, tree, spill, resident, out);
        case 3: return launch<ANY, true, true, false>(rays, tree, spill, resident, out);
        case 4: return launch<ANY, false, false, true>(rays, tree, spill, resident, out);
        case 5: return launch<ANY, true, false, true>(rays, tree, spill, resident, out);
        case 6: return launch<ANY, false, true, true>(rays, tree, spill, resident, out);
        case 7: return launch<ANY, true, true, true>(rays, tree, spill, resident, out);
        default: return launch<ANY, false, false, false>(rays, tree, spill, resident, out);
    }
}

static Tree tree_of(const float* nodes, int n_nodes, const float* rows, int n_rows, int n_tris,
                    const float* frames, int n_anims, int depth) {
    return Tree{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(rows),
                frames, n_nodes, n_rows, n_tris, n_anims, depth};
}

extern "C" void host_closest_hit(int variant, const float* o, const float* d, const float* tmin,
                                 const float* tmax, int n, const float* nodes, int n_nodes,
                                 const float* rows, int n_rows, int n_tris, const float* frames,
                                 int n_anims, int depth, int* spill, int resident, float* t,
                                 int* prim, float* u, float* v) {
    dispatch<false>(variant, Rays{o, d, tmin, tmax, n},
                    tree_of(nodes, n_nodes, rows, n_rows, n_tris, frames, n_anims, depth), spill,
                    resident, Out{t, prim, u, v, nullptr});
}

extern "C" void host_any_hit(int variant, const float* o, const float* d, const float* tmin,
                             const float* tmax, int n, const float* nodes, int n_nodes,
                             const float* rows, int n_rows, int n_tris, const float* frames,
                             int n_anims, int depth, int* spill, int resident, bool* occ) {
    dispatch<true>(variant, Rays{o, d, tmin, tmax, n},
                   tree_of(nodes, n_nodes, rows, n_rows, n_tris, frames, n_anims, depth), spill,
                   resident, Out{nullptr, nullptr, nullptr, nullptr, occ});
}

// The bytes of bvh_common.cuh's Layout, for the wrapper's mirror.
extern "C" int host_layout_bytes(int staged, int animated, int n_nodes, int n_rows, int n_tris,
                                 int n_anims, int depth) {
    return layout(staged, animated, n_nodes, n_rows, n_tris, n_anims, depth).bytes;
}
