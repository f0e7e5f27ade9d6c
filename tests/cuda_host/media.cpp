// KM (csrc/media.cu: media_kernel, a thread a lane) on the CPU through
// cuda_runtime.h: the launch's blocks and threads one after another (the
// kernel has no barrier and no warp intrinsic). media_device.cuh is media.cu
// up to its C entry point (the test cuts it there).
#include "cuda_runtime.h"

#include "media_device.cuh"

thread_local dim3 threadIdx, blockIdx;
dim3 gridDim, blockDim;

// wpt_apply_media's arguments but the stream.
extern "C" int host_apply_media(const float* o, const float* d, const float* t_min,
                                const float* t_solid, const int* prim_solid,
                                const float* u_solid, const float* v_solid,
                                const long long* pixel, const long long* sample,
                                const long long* bounce, int salt_base, int n,
                                const float* tri_p0, const float* tri_e1, const float* tri_e2,
                                const int* tri_off, const float* sph_c, const float* sph_r,
                                const int* sph_off, const float* density, const int* phase_mat,
                                int n_media, int n_solid, float* t_out, int* prim_out,
                                float* u_out, float* v_out, bool* mask_out, int* mat_out) {
    if (n <= 0) return 0;
    const Media md{tri_p0, tri_e1, tri_e2, tri_off, sph_c, sph_r, sph_off, density, phase_mat,
                   n_media};
    const int grid = (n + BLOCK - 1) / BLOCK;
    gridDim = {static_cast<unsigned>(grid), 1, 1};
    blockDim = {static_cast<unsigned>(BLOCK), 1, 1};
    for (int b = 0; b < grid; ++b)
        for (int i = 0; i < BLOCK; ++i) {
            blockIdx = {static_cast<unsigned>(b), 0, 0};
            threadIdx = {static_cast<unsigned>(i), 0, 0};
            media_kernel(md, o, d, t_min, t_solid, prim_solid, u_solid, v_solid, pixel, sample,
                         bounce, static_cast<uint32_t>(salt_base), n_solid, n, t_out, prim_out,
                         u_out, v_out, mask_out, mat_out);
        }
    return 0;
}
