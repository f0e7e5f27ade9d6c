// K8 (csrc/envmap.cu: env_lanes_kernel<SAMPLE>, a thread a lane, the lanes
// outside the mask writing fixed values) on the CPU through cuda_runtime.h:
// the launch's blocks one after another, each as its threads.
// envmap_device.cuh is envmap.cu up to its C entry point (the test cuts it
// there).
#include <thread>
#include <vector>

#include "cuda_runtime.h"

#include "envmap_device.cuh"

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

// wpt_env_lanes's arguments but the stream; returns 0, or -1 where the C
// entry refuses them.
extern "C" int host_env_lanes(int sample, const float* x, const bool* active, int n, int kind,
                              const float* img, int h, int w, const float* rot,
                              const float* const_rad, const float* pdf, const float* alias_prob,
                              const int* alias_idx, int res, float* d_out, float* pdf_out,
                              float* rad_out) {
    if (kind < 1 || kind > 3 || (sample && d_out == nullptr)) return -1;
    if (n <= 0) return 0;
    const EnvLanesMap m{kind, reinterpret_cast<const float4*>(img), h, w, rot,
                        reinterpret_cast<const float4*>(const_rad), pdf, alias_prob, alias_idx,
                        res};
    float4* rad = reinterpret_cast<float4*>(rad_out);
    run_blocks((n + BLOCK - 1) / BLOCK, BLOCK, [&] {
        if (sample)
            env_lanes_kernel<true>(m, x, active, n, d_out, pdf_out, rad);
        else
            env_lanes_kernel<false>(m, x, active, n, d_out, pdf_out, rad);
    });
    return 0;
}
