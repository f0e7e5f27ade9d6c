// K3T's, K3aT's, K8T's and K7T's per-lane device code (csrc/backward_common.cuh)
// on the CPU through cuda_runtime.h: one lane after another, with the entry
// points' own arguments but the stream (csrc/backward.cu
// wpt_assemble_hit_bwd, wpt_assemble_hit_anim_bwd, wpt_env_radiance_bwd for the equirect and cube
// maps, wpt_rgl_bwd; the constant sky's warp sum is the kernel's own and
// runs on the card only).
#include "cuda_runtime.h"
#include "backward_common.cuh"

thread_local dim3 threadIdx, blockIdx;
dim3 gridDim, blockDim;
WarpSync* g_warps;
BlockSync* g_block;

extern "C" int host_assemble_hit_bwd(const float* o, const float* d, const float* t,
                                     const int* prim, const float* u, const float* v,
                                     const bool* backside, int n, const float* tri_g,
                                     const float* tri_f, const int* tri_i, int n_tris,
                                     const float* sph_f, int n_spheres, const float* g_t,
                                     const float* g_pos, const float* g_nrm, const float* g_gn,
                                     const float* g_tan, const float* g_uv, float* g_o,
                                     float* g_d, float* g_tri_g, float* g_tri_f,
                                     float* g_sph_f) {
    const wpt_bwd::HitIn in{o, d, t, prim, u, v, backside, n};
    const wpt_bwd::Tables tb{tri_g, tri_f, tri_i, n_tris, sph_f, n_spheres};
    const wpt_bwd::Cot c{g_t, g_pos, g_nrm, g_gn, g_tan, g_uv};
    const wpt_bwd::HitOut out{g_o, g_d, g_tri_g, g_tri_f, g_sph_f};
    for (int i = 0; i < n; ++i) wpt_bwd::assemble_hit_bwd_lane<false>(i, in, tb, c, out, {});
    return 0;
}

// K3aT: wpt_assemble_hit_anim_bwd's arguments but the stream.
extern "C" int host_assemble_hit_anim_bwd(
    const float* o, const float* d, const float* t, const int* prim, const float* u,
    const float* v, const bool* backside, int n, const float* tri_g, const float* tri_f,
    const int* tri_i, int n_tris, const float* sph_f, int n_spheres, const float* g_t,
    const float* g_pos, const float* g_nrm, const float* g_gn, const float* g_tan,
    const float* g_uv, float* g_o, float* g_d, float* g_tri_g, float* g_tri_f, float* g_sph_f,
    const int* tri_anim, const int* sph_anim, const float* frames, long long fstride,
    float* g_frames) {
    const wpt_bwd::HitIn in{o, d, t, prim, u, v, backside, n};
    const wpt_bwd::Tables tb{tri_g, tri_f, tri_i, n_tris, sph_f, n_spheres};
    const wpt_bwd::Cot c{g_t, g_pos, g_nrm, g_gn, g_tan, g_uv};
    const wpt_bwd::HitOut out{g_o, g_d, g_tri_g, g_tri_f, g_sph_f};
    const wpt_bwd::AnimIn an{tri_anim, sph_anim, frames, fstride, g_frames};
    for (int i = 0; i < n; ++i) wpt_bwd::assemble_hit_bwd_lane<true>(i, in, tb, c, out, an);
    return 0;
}

extern "C" int host_env_radiance_bwd(const float* d, int n, int kind, const float* img, int h,
                                     int w, const float* rot, const float* g, float* g_d,
                                     float* g_img, float* g_const) {
    if (kind != 1 && kind != 2) return 1;
    (void)g_const;
    for (int i = 0; i < n; ++i)
        wpt_bwd::env_radiance_bwd_lane(i, d, kind, reinterpret_cast<const float4*>(img), h, w,
                                       rot, g, g_d, g_img);
    return 0;
}

extern "C" int host_rgl_bwd(const RglTables* t, const int* mid, const float* wi, const float* x,
                            int n, int sample, const float* g_f, float* g_rgb, float* g_ndf,
                            float* g_sigma) {
    const wpt_bwd::RglGrads out{g_rgb, g_ndf, g_sigma};
    for (int i = 0; i < n; ++i) {
        const int m = wpt_rgl::clampi(mid[i], 0, t->M - 1);
        const wpt_rgl::Vec3 w{wi[3 * i], wi[3 * i + 1], wi[3 * i + 2]};
        if (sample)
            wpt_bwd::rgl_bwd_lane<true>(*t, m, w, x + 2 * i, g_f + 4 * i, out);
        else
            wpt_bwd::rgl_bwd_lane<false>(*t, m, w, x + 3 * i, g_f + 4 * i, out);
    }
    return 0;
}
