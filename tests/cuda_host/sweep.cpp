// The sweeps KS1/KS2 (csrc/sweep_closest.cu, csrc/sweep_any.cu) and the hit
// assembly K3/K3a (csrc/assemble_hit.cu) on the CPU through cuda_runtime.h:
// each launch's blocks one after another, each as its threads. The
// *_device.cuh files are the sources up to their C entry points (the test
// cuts them there); assemble_hit.cu has names of its own, so it is built
// apart (K3A defined).
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
                                       const float* frames, float* pos, float* nrm, float* gn,
                                       float* tan, float* uv, int* mat, bool* backside) {
    const Anim anim{tri_anim, sph_anim, frames};
    run_blocks((n + BLOCK - 1) / BLOCK, BLOCK, [&] {
        if (frames == nullptr)
            assemble_hit_kernel<false>(o, d, t, prim, u, v, n, tri_f, tri_i, n_tris, sph_f,
                                       sph_mat, n_spheres, Anim{}, pos, nrm, gn, tan, uv, mat,
                                       backside);
        else
            assemble_hit_kernel<true>(o, d, t, prim, u, v, n, tri_f, tri_i, n_tris, sph_f,
                                      sph_mat, n_spheres, anim, pos, nrm, gn, tan, uv, mat,
                                      backside);
    });
}
#else
using wpt_sweep::BLOCK;

// wpt_sweep_closest's and wpt_sweep_any's arguments but the stream.
extern "C" void host_sweep_closest(const float* o, const float* d, const float* tmin,
                                   const float* tmax, int n, const float* tri,
                                   const int* tri_anim, int n_tris, const float* sph,
                                   const int* sph_anim, int n_spheres, const float* frames,
                                   float* t, int* prim, float* u, float* v) {
    run_blocks((n + BLOCK - 1) / BLOCK, BLOCK, [&] {
        sweep_closest_kernel(o, d, tmin, tmax, n, reinterpret_cast<const float4*>(tri), tri_anim,
                             n_tris, reinterpret_cast<const float4*>(sph), sph_anim, n_spheres,
                             frames, t, prim, u, v);
    });
}

extern "C" void host_sweep_any(const float* o, const float* d, const float* tmin,
                               const float* tmax, int n, const float* tri, const int* tri_anim,
                               int n_tris, const float* sph, const int* sph_anim, int n_spheres,
                               const float* frames, bool* occ) {
    run_blocks((n + BLOCK - 1) / BLOCK, BLOCK, [&] {
        sweep_any_kernel(o, d, tmin, tmax, n, reinterpret_cast<const float4*>(tri), tri_anim,
                         n_tris, reinterpret_cast<const float4*>(sph), sph_anim, n_spheres,
                         frames, occ);
    });
}
#endif
