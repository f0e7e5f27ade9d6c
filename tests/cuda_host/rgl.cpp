// K7 (csrc/rgl.cu: eval and sample, a thread a lane, the sample's warp form
// counting the CDF rows of its RGL lanes by the warp) on the CPU through
// cuda_runtime.h: the launch's blocks one after another, each as its
// threads. rgl_device.cuh is rgl.cu up to its C entry points (the test cuts
// it there).
#include <thread>
#include <vector>

#include "cuda_runtime.h"

#include "rgl_device.cuh"

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

// wpt_rgl_eval's arguments but the stream.
extern "C" void host_rgl_eval(const RglTables* t, const int* mid, const float* wi,
                              const float* wo, int n, float* fcos, float* pdf) {
    if (n <= 0) return;
    run_blocks((n + BLOCK - 1) / BLOCK, BLOCK,
               [&] { rgl_eval_kernel(*t, mid, wi, wo, n, fcos, pdf); });
}

// wpt_rgl_sample's arguments but the stream.
extern "C" void host_rgl_sample(const RglTables* t, const int* mid, const float* wi,
                                const float* u2, int n, float* wo, float* fcos, float* pdf,
                                bool* ok) {
    if (n <= 0) return;
    const bool warp = warp_form(*t);
    run_blocks((n + BLOCK - 1) / BLOCK, BLOCK, [&] {
        if (warp)
            rgl_sample_kernel<true>(*t, mid, wi, u2, n, wo, fcos, pdf, ok);
        else
            rgl_sample_kernel<false>(*t, mid, wi, u2, n, wo, fcos, pdf, ok);
    });
}

// 1 where wpt_rgl_sample runs the warp form on tables t.
extern "C" int host_rgl_warp_form(const RglTables* t) { return warp_form(*t) ? 1 : 0; }

// The lane functions one lane after another, each row counted by its own
// lane (eval_lane, sample_lane<false>, as K4's lit shade runs them), with
// the same contract for a negative id: the reference the kernels are held
// to bit for bit (the same libm). `x` is wo (eval) or u2 (sample); wo and
// ok unused for eval.
extern "C" void host_rgl_lanes(const RglTables* t, const int* mid, const float* wi,
                               const float* x, int n, int sample, float* wo, float* fcos,
                               float* pdf, bool* ok) {
    for (int i = 0; i < n; ++i) {
        float f[4] = {0.f, 0.f, 0.f, 0.f}, p = 0.f;
        Vec3 w = {0.f, 0.f, 0.f};
        bool good = false;
        if (mid[i] >= 0) {
            const int m = min(mid[i], t->M - 1);
            if (sample)
                good = sample_lane(*t, m, load3(wi, i), x[2 * i], x[2 * i + 1], &w, f, &p);
            else
                p = eval_lane(*t, m, load3(wi, i), load3(x, i), f);
        }
        for (int c = 0; c < 4; ++c) fcos[4 * i + c] = f[c];
        pdf[i] = p;
        if (sample) {
            wo[3 * i] = w.x;
            wo[3 * i + 1] = w.y;
            wo[3 * i + 2] = w.z;
            ok[i] = good;
        }
    }
}
