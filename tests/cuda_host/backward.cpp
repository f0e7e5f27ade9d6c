// K3T's, K3aT's, K8T's and K7T's per-lane device code (csrc/backward_common.cuh)
// on the CPU through cuda_runtime.h: one lane after another, with the entry
// points' own arguments but the stream (csrc/backward.cu
// wpt_assemble_hit_bwd, wpt_assemble_hit_anim_bwd, wpt_env_radiance_bwd for the equirect and cube
// maps, wpt_env_sample_bwd, wpt_rgl_bwd's tail and full forms; the constant
// sky's warp sum and the rotation's block sums are the kernels' own and
// run on the card only: here the lanes' terms are summed in lane order).
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

// wpt_env_radiance_bwd's arguments but the stream; g_rot (the rotation's
// cotangent, the lanes' terms summed in lane order) may be null.
extern "C" int host_env_radiance_bwd(const float* d, int n, int kind, const float* img, int h,
                                     int w, const float* rot, const float* g, float* g_d,
                                     float* g_img, float* g_const, float* g_rot) {
    if (kind != 1 && kind != 2) return 1;
    (void)g_const;
    for (int i = 0; i < n; ++i) {
        const float4* im = reinterpret_cast<const float4*>(img);
        if (g_rot == nullptr) {
            wpt_bwd::env_radiance_bwd_lane<false>(i, d, kind, im, h, w, rot, g, g_d, g_img);
            continue;
        }
        const float4 q = wpt_bwd::env_radiance_bwd_lane<true>(i, d, kind, im, h, w, rot, g, g_d,
                                                              g_img);
        g_rot[0] += q.x;
        g_rot[1] += q.y;
        g_rot[2] += q.z;
        g_rot[3] += q.w;
    }
    return 0;
}

extern "C" int host_env_sample_bwd(const float* u3, int n, const float* pdf,
                                   const float* alias_prob, const int* alias_idx, int res,
                                   const float* rot, const float* g_dir, float* g_rot) {
    for (int i = 0; i < n; ++i) {
        const float4 q =
            wpt_bwd::env_sample_bwd_lane(i, u3, pdf, alias_prob, alias_idx, res, rot, g_dir);
        g_rot[0] += q.x;
        g_rot[1] += q.y;
        g_rot[2] += q.z;
        g_rot[3] += q.w;
    }
    return 0;
}

// wpt_rgl_bwd's arguments but the stream.
extern "C" int host_rgl_bwd(const RglTables* t, const RglOut* out, const int* mid, const float* wi,
                            const float* x, int n, int sample, int full, const float* g_f,
                            const float* g_pdf, const float* g_wo) {
    for (int i = 0; i < n; ++i) {
        const int m = wpt_rgl::clampi(mid[i], 0, t->M - 1);
        const wpt_rgl::Vec3 w{wi[3 * i], wi[3 * i + 1], wi[3 * i + 2]};
        if (full && sample)
            wpt_bwd::rgl_bwd_lane<true, true>(*t, *out, i, m, w, x + 2 * i, g_f + 4 * i,
                                              g_pdf[i], g_wo + 3 * i);
        else if (full)
            wpt_bwd::rgl_bwd_lane<false, true>(*t, *out, i, m, w, x + 3 * i, g_f + 4 * i,
                                               g_pdf[i], nullptr);
        else if (sample)
            wpt_bwd::rgl_bwd_lane<true, false>(*t, *out, i, m, w, x + 2 * i, g_f + 4 * i, 0.f,
                                               nullptr);
        else
            wpt_bwd::rgl_bwd_lane<false, false>(*t, *out, i, m, w, x + 3 * i, g_f + 4 * i, 0.f,
                                                nullptr);
    }
    return 0;
}
