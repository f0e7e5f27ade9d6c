// K4's in-place kernels of csrc/wavefront.cu on the CPU through
// cuda_runtime.h: the lit shade as its persistent launch (`grid` blocks one
// after another, each as LIT_BLOCK threads, sharing one lane counter), the
// diffuse and env shades as their tiled launch (one SM holding two blocks
// here, so a block takes several tiles) and the regenerations, set up as
// the C entry points of wavefront.cu set them up. wavefront_device.cuh is
// wavefront.cu up to its launches (the test cuts it there and closes its
// namespace).
#include <thread>
#include <vector>

#include "cuda_runtime.h"

#include "wavefront_device.cuh"

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

// wpt_shade_lit's arguments up to its pending deposits, `grid` blocks;
// returns 0, or -1 for a sky or sensor this build leaves out.
extern "C" int host_shade_lit(
    const WaveState* st, long long* stats, int n, const long long* pixel, const float* t,
    const int* prim, const float* pos, const float* nrm, const float* gnrm, const float* tng,
    const bool* backside, const int* mat_hit, const float* mat, int n_mat,
    const float* pick_area, int n_pick, const float* light_tri, const int* light_mat,
    const float* light_w, const float* alias_prob, const int* alias_idx, int n_lights, int sky,
    const float* img, int h, int w, const float* pdf, const float* env_alias_prob,
    const int* env_alias_idx, int res, const float* rot, const RglTables* rgl, int sensor,
    const float* sensor_params, int max_depth, int rr_start, float rr_threshold,
    float shadow_scale, float min_hit, float* shadow_o, float* shadow_d, float* shadow_tmax,
    float* pending, int grid) {
    if (sky != SKY_EQUIRECT || sensor < 0 || sensor > 1) return -1;
    SensorParams sp;
    for (int k = 0; k < 8; ++k) sp.v[k] = sensor_params[k];
    const ShadeStep step{pixel, t, prim, pos, nrm, gnrm, tng, backside, mat_hit, shadow_o,
                       shadow_d, shadow_tmax, pending, n, max_depth, rr_start, rr_threshold,
                       shadow_scale, min_hit};
    const ShadeTables tab{mat, n_mat,
                        Lights{pick_area, n_pick, light_tri, light_mat, light_w, alias_prob,
                               alias_idx, n_lights},
                        rgl != nullptr ? *rgl : RglTables{}};
    const EnvMap env{reinterpret_cast<const float4*>(img), h, w, nullptr, pdf, env_alias_prob,
                     env_alias_idx, res, rot};
    int counter = 0;
    unsigned long long* cnt = reinterpret_cast<unsigned long long*>(stats);
    const WaveState s = *st;
    auto launch = [&](auto kernel) {
        run_blocks(grid, LIT_BLOCK, [&] { kernel(s, step, tab, env, sp, &counter, cnt); });
    };
    if (sensor == SENSOR_RGB) {
        if (rgl != nullptr) launch(shade_lit_kernel<SENSOR_RGB, SKY_EQUIRECT, true>);
        else launch(shade_lit_kernel<SENSOR_RGB, SKY_EQUIRECT, false>);
    } else {
        if (rgl != nullptr) launch(shade_lit_kernel<SENSOR_TOF, SKY_EQUIRECT, true>);
        else launch(shade_lit_kernel<SENSOR_TOF, SKY_EQUIRECT, false>);
    }
    return 0;
}

// A queued shade's launch as wpt_shade_diffuse and wpt_shade_env make it
// (launch_queued): the tile and grid from the resident blocks.
template <class Kernel, class... Args>
static void launch_queued_here(Kernel kernel, int n, unsigned long long* stats,
                               const Args&... args) {
    const int blocks = resident_blocks(kernel, SH_BLOCK);
    const int tile = shade_tile(n, blocks);
    run_blocks(std::min(blocks, (n + tile - 1) / tile), SH_BLOCK,
               [&] { kernel(args..., tile, stats); });
}

// wpt_shade_diffuse's arguments (the stream left out); returns its code.
extern "C" int host_shade_diffuse(
    const WaveState* st, long long* stats, int n, const long long* pixel, const float* t,
    const int* prim, const float* pos, const float* nrm, const float* gnrm, const bool* backside,
    const int* mat_hit, const float* mat, int n_mat, const float* pick_area, int n_pick,
    const float* light_tri, const int* light_mat, const float* light_w, const float* alias_prob,
    const int* alias_idx, int n_lights, int per_light, int sensor, const float* sensor_params,
    int max_depth, int rr_start, float rr_threshold, float shadow_scale, float min_hit,
    float* shadow_d, float* shadow_tmax, float* pending) {
    if (n_lights < 1 || n_pick < 1 || sensor < 0 || sensor > 1) return -1;
    SensorParams sp;
    for (int k = 0; k < 8; ++k) sp.v[k] = sensor_params[k];
    const ShadeStep step{pixel, t, prim, pos, nrm, gnrm, nullptr, backside, mat_hit, nullptr,
                         shadow_d, shadow_tmax, pending, n, max_depth, rr_start, rr_threshold,
                         shadow_scale, min_hit};
    const ShadeTables tab{mat, n_mat,
                          Lights{pick_area, n_pick, light_tri, light_mat, light_w, alias_prob,
                                 alias_idx, n_lights},
                          RglTables{}};
    auto* cnt = reinterpret_cast<unsigned long long*>(stats);
    const WaveState s = *st;
    if (sensor == SENSOR_RGB) {
        if (per_light) launch_queued_here(shade_kernel<SENSOR_RGB, true>, n, cnt, s, step, tab, sp);
        else launch_queued_here(shade_kernel<SENSOR_RGB, false>, n, cnt, s, step, tab, sp);
    } else {
        if (per_light) launch_queued_here(shade_kernel<SENSOR_TOF, true>, n, cnt, s, step, tab, sp);
        else launch_queued_here(shade_kernel<SENSOR_TOF, false>, n, cnt, s, step, tab, sp);
    }
    return 0;
}

// wpt_shade_env's arguments (the stream left out); returns 0, or -1 for a
// sky, sensor and glass this build leaves out: it holds the mesh's
// (equirect with importance tables, no glass), envmap's (cube with them,
// glass) and rtiow's (constant, glass) with either sensor.
extern "C" int host_shade_env(
    const WaveState* st, long long* stats, int n, const long long* pixel, const float* t,
    const int* prim, const float* pos, const float* nrm, const float* tng, const bool* backside,
    const int* mat_hit, const float* mat, int n_mat, int has_glass, int sky, const float* img,
    int h, int w, const float* const_rad, const float* pdf, const float* alias_prob,
    const int* alias_idx, int res, const float* rot, int sensor, const float* sensor_params,
    int max_depth, int rr_start, float rr_threshold, float* shadow_d, float* shadow_tmax,
    float* pending) {
    if (sensor < 0 || sensor > 1) return -1;
    SensorParams sp;
    for (int k = 0; k < 8; ++k) sp.v[k] = sensor_params[k];
    const EnvMap env{reinterpret_cast<const float4*>(img), h, w,
                     reinterpret_cast<const float4*>(const_rad), pdf, alias_prob, alias_idx, res,
                     rot};
    const ShadeStep step{pixel, t, prim, pos, nrm, nullptr, tng, backside, mat_hit, nullptr,
                         shadow_d, shadow_tmax, pending, n, max_depth, rr_start, rr_threshold,
                         0.f, 0.f};
    const ShadeTables tab{mat, n_mat, Lights{}, RglTables{}};
    auto* cnt = reinterpret_cast<unsigned long long*>(stats);
    const WaveState s = *st;
    auto launch = [&](auto kernel) { launch_queued_here(kernel, n, cnt, s, step, tab, env, sp); };
    const bool tof = sensor == SENSOR_TOF;
    if (sky == SKY_EQUIRECT && res > 0 && !has_glass) {
        if (tof) launch(shade_env_kernel<SENSOR_TOF, SKY_EQUIRECT, true, false>);
        else launch(shade_env_kernel<SENSOR_RGB, SKY_EQUIRECT, true, false>);
    } else if (sky == SKY_CUBE && res > 0 && has_glass) {
        if (tof) launch(shade_env_kernel<SENSOR_TOF, SKY_CUBE, true, true>);
        else launch(shade_env_kernel<SENSOR_RGB, SKY_CUBE, true, true>);
    } else if (sky == SKY_CONSTANT && res == 0 && has_glass) {
        if (tof) launch(shade_env_kernel<SENSOR_TOF, SKY_CONSTANT, false, true>);
        else launch(shade_env_kernel<SENSOR_RGB, SKY_CONSTANT, false, true>);
    } else {
        return -1;
    }
    return 0;
}

template <int CAMERA>
static void regen(const WaveState* st, float* t_max, int n, const Camera& cam, long long blk,
                  int B, int m, long long P, long long n_pix, int width, int height, int ssqrt,
                  int randomize, const Pending& pend, int* work) {
    const WaveState s = *st;
    *work = 0;   // the C entry point's memset
    run_blocks((n + 255) / 256, 256, [&] {
        regen_kernel<CAMERA>(s, t_max, n, cam, blk, B, m, P, n_pix, width, height, ssqrt,
                             randomize, pend, work);
    });
}

// wpt_regen_pinhole's and wpt_regen_surround's arguments (the stream left
// out); each returns its entry point's code.
extern "C" int host_regen_pinhole(const WaveState* st, float* t_max, int n, const float* centre,
                                  const float* focal, const float* translation,
                                  const float* rotation, const float* dist_k,
                                  const float* dist_p, int lens, int iters, const float* scale,
                                  const float* focus, const float* aperture, int dof,
                                  long long blk, int B, int m, long long P, long long n_pix,
                                  int width, int height, int ssqrt, int randomize,
                                  const float* pending, const bool* occluded, int n_pend,
                                  int n_acc, int* work) {
    if (!pending_ok(pending, occluded, n_pend)) return -1;
    const Camera cam{centre, focal, translation, rotation, dist_k, dist_p, lens, iters,
                     scale, nullptr, 0.f, 0.f, 0.f, 0, focus, aperture, dof};
    regen<CAM_PINHOLE>(st, t_max, n, cam, blk, B, m, P, n_pix, width, height, ssqrt, randomize,
                       Pending{pending, occluded, n_pend, n_acc}, work);
    return 0;
}

extern "C" int host_regen_surround(const WaveState* st, float* t_max, int n,
                                   const float* translation, const float* rotation,
                                   const float* scale, const float* eye_distance, float span,
                                   float inv_width, float inv_eff_height, int stereo,
                                   long long blk, int B, int m, long long P, long long n_pix,
                                   int width, int height, int ssqrt, int randomize,
                                   const float* pending, const bool* occluded, int n_pend,
                                   int n_acc, int* work) {
    if (!pending_ok(pending, occluded, n_pend)) return -1;
    const Camera cam{nullptr, nullptr, translation, rotation, nullptr, nullptr, LENS_NONE, 0,
                     scale, eye_distance, span, inv_width, inv_eff_height, stereo,
                     nullptr, nullptr, 0};
    regen<CAM_SURROUND>(st, t_max, n, cam, blk, B, m, P, n_pix, width, height, ssqrt, randomize,
                        Pending{pending, occluded, n_pend, n_acc}, work);
    return 0;
}
