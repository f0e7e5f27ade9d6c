// K3: hit-record assembly for the winners of a closest-hit cast.
//
// Replaces wurblpt_tpu/render/intersect_mxu.py mxu_tri_attrs and the
// static-scene body of intersect.py assemble_hit (:489-632). On the TPU the
// attribute fetch was a one-hot [N,T] x [T,29] matrix product, because row
// gathers were priced per descriptor there. Here one thread per lane reads
// the winner's packed row directly and does the arithmetic of
// intersect.py:535-632: position, interpolated shading normal, uv and
// Gram-Schmidt tangent (ONB fallback when the tangent degenerates), the
// geometric normal, the material, the sphere branch (normal, lat/long uv,
// pole-safe tangent), and the front-face flip with the backside flag.
//
// Bound on the card: memory. Per lane ~40 bytes in and ~60 bytes out, plus
// one ~116-byte table row that stays in L1/L2 (the table is tiny). At
// N = 131072 that is ~13 MB of traffic, a few microseconds at 3.35 TB/s.
//
// Left for later: fusing this into K1's epilogue so t/prim/u/v never leave
// registers. It stays a separate kernel now so each kernel is tested alone.
//
// K3a, the animated branch (ANIM = true, wpt_assemble_hit_anim), replaces
// intersect.py:510-530 and :605-620: the winner's animation id (its
// triangle's or sphere's), the ray in that animation's object space (the
// frame rows of scene/animation.py anim_frames: r_inv, t_inv), the sphere's
// normal, uv and tangent from the hit point there (a triangle's attributes
// are object-space already), then the normals back to world by the normal
// matrix R diag(1/s) and the tangent by the forward map R diag(s), each
// normalized, before the front-face flip against the world ray. The same
// memory bound, plus the 120-byte frame row of the winner's animation (the
// frame's few rows stay in L1). Under motion blur each lane reads its own
// rows (scene/animation.py anim_frames_per_ray: a lane stride of A FRAME
// floats), the winner's row at lane i A + aid; the K4 form takes the
// frame's one instant only (a stride of 0), since a frame over a shutter
// takes the pass renderer.
//
// The K4 form (wpt_assemble_hit_k4, `assemble_hit_k4_kernel<ANIM, FIELDS>`):
// the record one K4 shade reads, on hit lanes only. No kernel after K3 on a
// K4 step reads a miss lane's record (the shades read it on hit lanes, the
// lit shade's bins test prim >= 0 first, the any-hit casts read the
// position as a shadow origin only on rows with t_max > 0), and no shade
// reads uv, the diffuse shade no tangent, the env shade no geometric
// normal. So each block reads the prims of its tile of lanes (the tiles
// and launch of live_queue.cuh); a hit lane's thread also reads o, d and t,
// and u and v for a triangle winner, while the block counts its bins (a
// ballot/__popc prefix per warp, live_queue.cuh hit_slot), and queues them
// in shared memory, triangle winners and sphere winners in bins of their
// own; its warps then assemble queued lanes only: the winner's rows and
// the fields of the set FIELDS, computed and stored; a field outside it is
// neither. A miss or dead lane reads its prim and writes nothing. Each
// field a lane gets is the full form's to the bit (one lane function,
// `assemble_lane`, serves both).
//
// Bound of the K4 form: memory, prim on every lane, the rest on hit lanes
// only (kernel_check.assemble_hit_work with a field set).
//
// Evaluation order matches intersect.assemble_hit_plain term by term; the
// library is built with -fmad=false, so both agree to the bit except where
// atan2f/asinf differ from PyTorch's (sphere uv only). The object-space ray
// is the sweeps' own (sweep_common.cuh object_ray), so a winner's hit point
// there is formed from the ray its test took.
#include <cuda_runtime.h>

#include "live_queue.cuh"
#include "sweep_common.cuh"

namespace {

using wpt_queue::QBLOCK;
using wpt_queue::QWARPS;
using wpt_sweep::dot3;
using wpt_sweep::FRAME;   // r_inv | t_inv | m_fwd | m_nrm
using wpt_sweep::load3;
using wpt_sweep::matvec;
using wpt_sweep::object_ray;
using wpt_sweep::V3;

constexpr int BLOCK = 128;
constexpr int TRI_F = 27;  // n0 n1 n2 | uv0 uv1 uv2 | tan0 tan1 tan2 | gn

// The record's fields as bits of a field set (the K4 form's FIELDS, the
// `fields` of wpt_assemble_hit_k4; render/intersect.py K4_FIELDS).
constexpr int F_POS = 1, F_NRM = 2, F_GN = 4, F_TAN = 8, F_UV = 16, F_MAT = 32, F_BACK = 64;
constexpr int F_ALL = 127;                                        // the full form
constexpr int F_DIFFUSE = F_POS | F_NRM | F_GN | F_BACK | F_MAT;  // 103
constexpr int F_ENV = F_POS | F_NRM | F_TAN | F_BACK | F_MAT;     // 107
constexpr int F_LIT = F_ALL & ~F_UV;                              // 111

__device__ __forceinline__ V3 scale3(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }

__device__ __forceinline__ V3 normalize3(V3 a) {
    const float inv = 1.f / sqrtf(fmaxf(dot3(a, a), 1e-20f));
    return scale3(a, inv);
}

// w * a + u * b + v * c, left to right.
__device__ __forceinline__ V3 interp3(float w, float u, float v, V3 a, V3 b, V3 c) {
    return {w * a.x + u * b.x + v * c.x, w * a.y + u * b.y + v * c.y, w * a.z + u * b.z + v * c.z};
}

__device__ __forceinline__ void store3(float* p, V3 a) {
    p[0] = a.x;
    p[1] = a.y;
    p[2] = a.z;
}

// The winners' rows (render/intersect.py HitTables).
struct Tables {
    const float* tri_f;
    const int* tri_i;     // material, flags
    int n_tris;
    const float* sph_f;   // centre, radius
    const int* sph_mat;
    int n_spheres;
};

// The animation rows of a K3a launch (all null for K3).
struct Anim {
    const int* tri_anim;
    const int* sph_anim;
    const float* frames;   // [A, FRAME] at the frame's instant, or [N, A, FRAME] per ray
    long long stride;      // floats per lane: 0, or A FRAME per ray
};

// The record's output rows; null outside the launch's field set.
struct Record {
    float *pos, *nrm, *gn, *tan, *uv;
    int* mat;
    bool* backside;
};

// Lane i's record from its winner p (`hit`: p >= 0), its ray (ro, rd), the
// hit's t and its barycentrics u, v (read for a triangle winner only), the
// fields of F computed and stored. A miss lane (the full form's only)
// assembles as if its prim were 0 at t = 1 and writes mat 0 and backside
// false, as intersect.assemble_hit_plain does.
template <bool ANIM, int F>
__device__ __forceinline__ void assemble_lane(int i, int p, bool hit, V3 ro, V3 rd, float t_hit,
                                              float u, float v, const Tables& tb,
                                              const Anim& anim, const Record& out) {
    const int ps = hit ? p : 0;
    const bool is_tri = hit && ps < tb.n_tris;
    const float tp = hit ? t_hit : 1.f;
    const V3 pos = {ro.x + tp * rd.x, ro.y + tp * rd.y, ro.z + tp * rd.z};
    V3 pos_local = pos;
    const float* frow = nullptr;
    if (ANIM) {
        const int aid =
            is_tri ? __ldg(anim.tri_anim + ps)
                   : (tb.n_spheres > 0
                          ? __ldg(anim.sph_anim + min(max(ps - tb.n_tris, 0), tb.n_spheres - 1))
                          : 0);
        frow = anim.frames + i * anim.stride + aid * FRAME;
        V3 oa, da;
        object_ray(frow, ro, rd, oa, da);
        pos_local = {oa.x + tp * da.x, oa.y + tp * da.y, oa.z + tp * da.z};
    }

    V3 nrm = {0.f, 0.f, 0.f}, gn = {0.f, 0.f, 0.f}, tan = {0.f, 0.f, 0.f};
    float uv0 = 0.f, uv1 = 0.f;
    int mat = 0;
    if (is_tri) {
        const float* row = tb.tri_f + static_cast<long>(ps) * TRI_F;
        const float w = 1.f - u - v;
        nrm = normalize3(interp3(w, u, v, load3(row + 0), load3(row + 3), load3(row + 6)));
        if (F & F_UV) {
            uv0 = w * __ldg(row + 9) + u * __ldg(row + 11) + v * __ldg(row + 13);
            uv1 = w * __ldg(row + 10) + u * __ldg(row + 12) + v * __ldg(row + 14);
        }
        gn = load3(row + 24);
        mat = __ldg(tb.tri_i + 2 * ps);
        if (F & F_TAN) {
            const V3 traw = interp3(w, u, v, load3(row + 15), load3(row + 18), load3(row + 21));
            const bool has_tan = (__ldg(tb.tri_i + 2 * ps + 1) & 2) > 0;
            const float tdn = dot3(traw, nrm);
            const V3 tgs = {traw.x - tdn * nrm.x, traw.y - tdn * nrm.y, traw.z - tdn * nrm.z};
            const float tlen = sqrtf(fmaxf(dot3(tgs, tgs), 1e-20f));
            if (has_tan && tlen > 1e-8f) {
                const float l = fmaxf(tlen, 1e-20f);
                tan = {tgs.x / l, tgs.y / l, tgs.z / l};
            } else {  // onb_from_normal(nrm) tangent
                const float sign = nrm.z >= 0.f ? 1.f : -1.f;
                const float a = -1.f / (sign + nrm.z);
                const float b = nrm.x * nrm.y * a;
                tan = {1.f + sign * nrm.x * nrm.x * a, sign * b, -sign * nrm.x};
            }
        }
    } else if (tb.n_spheres > 0) {
        const int si = min(max(ps - tb.n_tris, 0), tb.n_spheres - 1);
        const float* row = tb.sph_f + 4 * si;
        const float r = fmaxf(__ldg(row + 3), 1e-20f);
        const V3 c = load3(row);
        const V3 local = {(pos_local.x - c.x) / r, (pos_local.y - c.y) / r,
                          (pos_local.z - c.z) / r};
        nrm = normalize3(local);
        gn = nrm;
        if (F & F_UV) {
            uv0 = 0.5f + atan2f(nrm.x, nrm.z) * 0.15915494309189535f;       // 1 / (2 pi)
            uv1 = 0.5f + asinf(fminf(fmaxf(nrm.y, -1.f), 1.f)) * 0.3183098861837907f;  // 1 / pi
        }
        if (F & F_TAN) {
            const V3 tr = {nrm.z, 0.f, -nrm.x};
            const float ln = sqrtf(fmaxf(dot3(tr, tr), 1e-20f));
            if (ln < 1e-6f) {
                tan = {1.f, 0.f, 0.f};
            } else {
                const float l = fmaxf(ln, 1e-20f);
                tan = {tr.x / l, tr.y / l, tr.z / l};
            }
        }
        mat = __ldg(tb.sph_mat + si);
    }
    if (ANIM) {
        nrm = normalize3(matvec(frow + 21, nrm));
        gn = normalize3(matvec(frow + 21, gn));
        if (F & F_TAN) tan = normalize3(matvec(frow + 12, tan));
    }
    const bool backside = dot3(rd, gn) > 0.f;
    const float flip = backside ? -1.f : 1.f;
    if (F & F_POS) store3(out.pos + 3 * i, pos);
    if (F & F_NRM) store3(out.nrm + 3 * i, scale3(nrm, flip));
    if (F & F_GN) store3(out.gn + 3 * i, scale3(gn, flip));
    if (F & F_TAN) store3(out.tan + 3 * i, tan);
    if (F & F_UV) {
        out.uv[2 * i + 0] = uv0;
        out.uv[2 * i + 1] = uv1;
    }
    if (F & F_MAT) out.mat[i] = hit ? mat : 0;
    if (F & F_BACK) out.backside[i] = backside && hit;
}

// The full form: one thread per lane, every field of every lane.
template <bool ANIM>
__global__ void __launch_bounds__(BLOCK)
assemble_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t, const int* __restrict__ prim,
                    const float* __restrict__ u, const float* __restrict__ v, int n, Tables tb,
                    Anim anim, Record out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int p = prim[i];
    assemble_lane<ANIM, F_ALL>(i, p, p >= 0, load3(o + 3 * i), load3(d + 3 * i), t[i], u[i], v[i],
                               tb, anim, out);
}

// The K4 form: each block's tiles of `tile` lanes (live_queue.cuh). A hit
// lane's thread reads its ray, t and (a triangle winner's) u and v while the
// block counts its bins, and queues them in shared memory by winner kind;
// then each thread assembles one queued lane, the fields of F only.
template <bool ANIM, int F>
__global__ void __launch_bounds__(QBLOCK)
assemble_hit_k4_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ t, const int* __restrict__ prim,
                       const float* __restrict__ u, const float* __restrict__ v, int n, int tile,
                       Tables tb, Anim anim, Record out) {
    __shared__ float s_ray[6 * QBLOCK], s_tuv[3 * QBLOCK];
    __shared__ int s_lane[QBLOCK], s_prim[QBLOCK], s_count[2 * QWARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tiles = (n + tile - 1) / tile;
    for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
        const int i = tl * tile + threadIdx.x;
        const bool mine = static_cast<int>(threadIdx.x) < tile && i < n;
        const int p = mine ? prim[i] : -1;
        const bool tri = p >= 0 && p < tb.n_tris;
        const bool sph = p >= 0 && p >= tb.n_tris;
        float ray[6] = {}, tuv[3] = {};
        if (tri || sph) {
            for (int c = 0; c < 3; ++c) {
                ray[c] = o[3 * i + c];
                ray[3 + c] = d[3 * i + c];
            }
            tuv[0] = t[i];
            if (tri) {
                tuv[1] = u[i];
                tuv[2] = v[i];
            }
        }
        int total = 0;
        const int slot = wpt_queue::hit_slot(s_count, lane, warp, tri, sph, total);
        if (slot >= 0) {
            for (int c = 0; c < 6; ++c) s_ray[6 * slot + c] = ray[c];
            for (int c = 0; c < 3; ++c) s_tuv[3 * slot + c] = tuv[c];
            s_lane[slot] = i;
            s_prim[slot] = p;
        }
        __syncthreads();   // the queue
        const int q = threadIdx.x;
        if (q < total) {
            const float* r = s_ray + 6 * q;
            const float* w = s_tuv + 3 * q;
            assemble_lane<ANIM, F>(s_lane[q], s_prim[q], true, V3{r[0], r[1], r[2]},
                                   V3{r[3], r[4], r[5]}, w[0], w[1], w[2], tb, anim, out);
        }
    }
}

// The K4 form's launch for n lanes: its tiles spread over the blocks the
// SMs hold at once (asked once per instantiation: six share one signature,
// more than wpt_queue::resident_blocks caches).
struct Launch {
    int grid, tile;
};

template <bool ANIM, int F>
Launch k4_launch(int n) {
    static int blocks = 0;
    if (blocks == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, assemble_hit_k4_kernel<ANIM, F>,
                                                      QBLOCK, 0);
        blocks = sms * (per_sm > 0 ? per_sm : 1);
    }
    const int tile = wpt_queue::tile_lanes(n, blocks);
    return {min(blocks, (n + tile - 1) / tile), tile};
}

}  // namespace

extern "C" int wpt_assemble_hit(const float* o, const float* d, const float* t, const int* prim,
                                const float* u, const float* v, int n, const float* tri_f,
                                const int* tri_i, int n_tris, const float* sph_f,
                                const int* sph_mat, int n_spheres, float* pos, float* nrm,
                                float* gn, float* tan, float* uv, int* mat, bool* backside,
                                void* stream) {
    if (n > 0) {
        const int grid = (n + BLOCK - 1) / BLOCK;
        assemble_hit_kernel<false><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            o, d, t, prim, u, v, n, Tables{tri_f, tri_i, n_tris, sph_f, sph_mat, n_spheres},
            Anim{}, Record{pos, nrm, gn, tan, uv, mat, backside});
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int wpt_assemble_hit_anim(const float* o, const float* d, const float* t,
                                     const int* prim, const float* u, const float* v, int n,
                                     const float* tri_f, const int* tri_i, int n_tris,
                                     const float* sph_f, const int* sph_mat, int n_spheres,
                                     const int* tri_anim, const int* sph_anim,
                                     const float* frames, long long fstride, float* pos,
                                     float* nrm, float* gn, float* tan, float* uv, int* mat,
                                     bool* backside, void* stream) {
    if (n > 0) {
        const int grid = (n + BLOCK - 1) / BLOCK;
        assemble_hit_kernel<true><<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            o, d, t, prim, u, v, n, Tables{tri_f, tri_i, n_tris, sph_f, sph_mat, n_spheres},
            Anim{tri_anim, sph_anim, frames, fstride},
            Record{pos, nrm, gn, tan, uv, mat, backside});
    }
    return static_cast<int>(cudaGetLastError());
}

namespace {

template <bool ANIM, int F>
int launch_k4(const float* o, const float* d, const float* t, const int* prim, const float* u,
              const float* v, int n, const Tables& tb, const Anim& anim, const Record& out,
              cudaStream_t stream) {
    if (n > 0) {
        const Launch l = k4_launch<ANIM, F>(n);
        assemble_hit_k4_kernel<ANIM, F><<<l.grid, QBLOCK, 0, stream>>>(o, d, t, prim, u, v, n,
                                                                      l.tile, tb, anim, out);
    }
    return static_cast<int>(cudaGetLastError());
}

template <int F>
int launch_k4(bool animated, const float* o, const float* d, const float* t, const int* prim,
              const float* u, const float* v, int n, const Tables& tb, const Anim& anim,
              const Record& out, cudaStream_t stream) {
    return animated ? launch_k4<true, F>(o, d, t, prim, u, v, n, tb, anim, out, stream)
                    : launch_k4<false, F>(o, d, t, prim, u, v, n, tb, anim, out, stream);
}

}  // namespace

// The K4 form: `fields` one of the field sets F_DIFFUSE, F_ENV, F_LIT (else
// cudaErrorInvalidValue and nothing launched), the output rows of the
// fields outside it null; `frames` null for K3, the animations' rows for
// K3a.
extern "C" int wpt_assemble_hit_k4(const float* o, const float* d, const float* t,
                                   const int* prim, const float* u, const float* v, int n,
                                   const float* tri_f, const int* tri_i, int n_tris,
                                   const float* sph_f, const int* sph_mat, int n_spheres,
                                   const int* tri_anim, const int* sph_anim, const float* frames,
                                   int fields, float* pos, float* nrm, float* gn, float* tan,
                                   int* mat, bool* backside, void* stream) {
    const Tables tb{tri_f, tri_i, n_tris, sph_f, sph_mat, n_spheres};
    const Anim anim{tri_anim, sph_anim, frames, 0};
    const Record out{pos, nrm, gn, tan, nullptr, mat, backside};
    const bool animated = frames != nullptr;
    const auto s = static_cast<cudaStream_t>(stream);
    switch (fields) {
        case F_DIFFUSE:
            return launch_k4<F_DIFFUSE>(animated, o, d, t, prim, u, v, n, tb, anim, out, s);
        case F_ENV:
            return launch_k4<F_ENV>(animated, o, d, t, prim, u, v, n, tb, anim, out, s);
        case F_LIT:
            return launch_k4<F_LIT>(animated, o, d, t, prim, u, v, n, tb, anim, out, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
