// KS1: the brute-force sweep's closest hit of N rays against every triangle
// and sphere, static or animated.
//
// Replaces wurblpt_tpu/render/intersect.py _closest_tris (:216) and
// _closest_spheres (:271) with ray_tri_tile (:155) and ray_sphere_tile
// (:189): the JAX package's cast for every scene without a BVH that its
// matrix form does not take (an animated scene, or a static one past 8192
// columns). On the TPU a tile of up to 1024 triangles was one [N, tile]
// broadcast, its argmin folded into the running best. With animation
// frames each primitive tests the ray in its animation's object space
// (scene/animation.py), which a thread computes when the animation id
// changes along its walk.
//
// Bound on the card: FP32 CUDA-core arithmetic, N x P pair tests of ~50
// flops (Moller-Trumbore with a division; the sphere quadratic with a
// square root and two divisions), the table read from shared memory as
// broadcasts. On the animated Cornell box (P = 36, N = 131072) the later
// steps leave most lanes dead, so the design casts live rays only:
//   - each block takes tiles of lanes and queues their live rays in shared
//     memory (live_queue.cuh, K1's queue); a dead lane writes its miss at
//     once and reads nothing but t_min and t_max. The table and its
//     animation ids are staged once per block (whole up to STAGE_MAX, else
//     CHUNK primitives at a time per tile).
//   - `split` threads per queued ray on sparse steps (1, 2, 4 or 8), each
//     walking every split-th primitive; the split agrees on the first
//     minimum (smaller t, then lower prim id) through warp shuffles.
// Measured and left out (PERF.md): division-free sign and range
// pre-tests in front of the exact test (a warp's rays pass them unevenly,
// so it pays for both), and each queued ray's object rays computed once
// per launch into shared memory.
//
// Ties go to the first minimum in primitive order (each thread's strict
// `<`, and the lower prim id at equal t across threads), triangles before
// spheres: JAX's argmin within a tile and strict `<` across tiles give the
// same. A lane with tmax <= tmin is a miss and does not walk the table.
#include "live_queue.cuh"
#include "sweep_common.cuh"

namespace {

using namespace wpt_sweep;
using wpt_queue::FULL;
using wpt_queue::QBLOCK;
using wpt_queue::QWARPS;

struct Best {
    float t = BIG, u = 0.f, v = 0.f;
    int prim = -1;
};

// Triangles part, part + split, ... of `cnt` rows (3 float4 each; prim ids
// from `first`), in order: the strict `<` keeps the thread's first minimum.
__device__ __forceinline__ void walk_tris(Lane& r, const float4* rows, const int* aid, int cnt,
                                          int first, int part, int split, Best& b) {
    for (int k = part; k < cnt; k += split) {
        V3 ro, rd;
        r.rays_of(aid[k], ro, rd);
        const float4 p = rows[3 * k], e = rows[3 * k + 1], f = rows[3 * k + 2];
        float t, u, v;
        if (tri_test(ro, rd, {p.x, p.y, p.z}, {e.x, e.y, e.z}, {f.x, f.y, f.z}, r.tmin, r.tmax, t,
                     u, v) &&
            t < b.t) {
            b.t = t;
            b.prim = first + k;
            b.u = u;
            b.v = v;
        }
    }
}

__device__ __forceinline__ void walk_spheres(Lane& r, const float4* rows, const int* aid,
                                             int cnt, int first, int part, int split, Best& b) {
    for (int k = part; k < cnt; k += split) {
        V3 ro, rd;
        r.rays_of(aid[k], ro, rd);
        float ts;
        if (sphere_test(ro, rd, rows[k], r.tmin, r.tmax, ts) && ts < b.t) {
            b.t = ts;
            b.prim = first + k;
            b.u = 0.f;
            b.v = 0.f;
        }
    }
}

// The first minimum over the `split` threads of a ray (neighbouring lanes of
// a warp): the smaller t, at equal t the lower prim id.
__device__ __forceinline__ void combine(Best& b, int split) {
    for (int off = 1; off < split; off <<= 1) {
        const float t = __shfl_xor_sync(FULL, b.t, off);
        const int prim = __shfl_xor_sync(FULL, b.prim, off);
        const float u = __shfl_xor_sync(FULL, b.u, off);
        const float v = __shfl_xor_sync(FULL, b.v, off);
        if (t < b.t || (t == b.t && prim < b.prim)) {
            b.t = t;
            b.prim = prim;
            b.u = u;
            b.v = v;
        }
    }
}

__device__ __forceinline__ void write_hit(int i, const Best& b, float* __restrict__ t_out,
                                          int* __restrict__ prim_out, float* __restrict__ u_out,
                                          float* __restrict__ v_out) {
    t_out[i] = b.t;
    prim_out[i] = b.prim;
    u_out[i] = b.u;
    v_out[i] = b.v;
}

// Dynamic shared memory: the table's rows (triangles' 3 float4, then the
// spheres'), then their animation ids. WHOLE: the whole table for the whole
// launch; otherwise CHUNK primitives at a time for each tile.
template <bool WHOLE>
__global__ void __launch_bounds__(QBLOCK)
sweep_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
                     int tile, const float4* __restrict__ tri, const int* __restrict__ tri_anim,
                     int n_tris, const float4* __restrict__ sph,
                     const int* __restrict__ sph_anim, int n_spheres,
                     const float* __restrict__ frames, long long fstride,
                     float* __restrict__ t_out,
                     int* __restrict__ prim_out, float* __restrict__ u_out,
                     float* __restrict__ v_out) {
    extern __shared__ float4 s_rows[];
    int* s_aid = reinterpret_cast<int*>(s_rows + (WHOLE ? 3 * n_tris + n_spheres : 3 * CHUNK));
    // the queued live lanes' rays and lane ids (live_queue.cuh)
    __shared__ float s_o[3 * QBLOCK], s_d[3 * QBLOCK], s_tmin[QBLOCK], s_tmax[QBLOCK];
    __shared__ int s_lane[QBLOCK];
    __shared__ int s_count[QWARPS];
    const wpt_queue::Queue q{s_o, s_d, s_tmin, s_tmax, s_lane, s_count};
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (WHOLE) {
        for (int j = threadIdx.x; j < 3 * n_tris; j += QBLOCK) s_rows[j] = tri[j];
        for (int j = threadIdx.x; j < n_spheres; j += QBLOCK) s_rows[3 * n_tris + j] = sph[j];
        for (int j = threadIdx.x; j < n_tris; j += QBLOCK) s_aid[j] = tri_anim[j];
        for (int j = threadIdx.x; j < n_spheres; j += QBLOCK) s_aid[n_tris + j] = sph_anim[j];
    }
    const int tiles = (n + tile - 1) / tile;
    for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
        const int total = wpt_queue::queue_live(
            q, lane, warp, tl, tile, n, o, d, tmin, tmax,
            [=](int i) { write_hit(i, Best{}, t_out, prim_out, u_out, v_out); });
        const int split = wpt_queue::split_for(total);
        const int qi = threadIdx.x / split, part = threadIdx.x % split;
        const bool has = qi < total;
        Best b;
        if (WHOLE) {
            if (has) {
                Lane r = load_lane(s_o, s_d, s_tmin, s_tmax,
                                  lane_frames(frames, fstride, s_lane[qi]), qi);
                walk_tris(r, s_rows, s_aid, n_tris, 0, part, split, b);
                walk_spheres(r, s_rows + 3 * n_tris, s_aid + n_tris, n_spheres, n_tris, part,
                             split, b);
            }
        } else if (total > 0) {   // block-uniform: no barrier is skipped by a part of it
            // the ray is taken from the queue again after each barrier: less
            // to keep in registers across them
            for (int base = 0; base < n_tris; base += CHUNK) {
                const int cnt = min(CHUNK, n_tris - base);
                __syncthreads();
                for (int j = threadIdx.x; j < 3 * cnt; j += QBLOCK) s_rows[j] = tri[3 * base + j];
                for (int j = threadIdx.x; j < cnt; j += QBLOCK) s_aid[j] = tri_anim[base + j];
                __syncthreads();
                if (has) {
                    Lane r = load_lane(s_o, s_d, s_tmin, s_tmax,
                                  lane_frames(frames, fstride, s_lane[qi]), qi);
                    walk_tris(r, s_rows, s_aid, cnt, base, part, split, b);
                }
            }
            for (int base = 0; base < n_spheres; base += CHUNK) {
                const int cnt = min(CHUNK, n_spheres - base);
                __syncthreads();
                for (int j = threadIdx.x; j < cnt; j += QBLOCK) {
                    s_rows[j] = sph[base + j];
                    s_aid[j] = sph_anim[base + j];
                }
                __syncthreads();
                if (has) {
                    Lane r = load_lane(s_o, s_d, s_tmin, s_tmax,
                                  lane_frames(frames, fstride, s_lane[qi]), qi);
                    walk_spheres(r, s_rows, s_aid, cnt, n_tris + base, part, split, b);
                }
            }
        }
        combine(b, split);
        if (has && part == 0) write_hit(s_lane[qi], b, t_out, prim_out, u_out, v_out);
    }
}

// Blocks the SMs hold at once with this much shared memory.
int resident_blocks(int n_tris, int n_spheres) {
    const size_t smem = launch_smem(n_tris, n_spheres);
    return staged_whole(n_tris, n_spheres)
               ? wpt_queue::resident_blocks(sweep_closest_kernel<true>, smem, STAGE_MAX)
               : wpt_queue::resident_blocks(sweep_closest_kernel<false>, smem, 0);
}

}  // namespace

extern "C" int wpt_sweep_closest(const float* o, const float* d, const float* tmin,
                                 const float* tmax, int n, const float* tri, const int* tri_anim,
                                 int n_tris, const float* sph, const int* sph_anim, int n_spheres,
                                 const float* frames, long long fstride, float* t_out,
                                 int* prim_out, float* u_out, float* v_out, void* stream) {
    if (n > 0) {
        const int blocks = resident_blocks(n_tris, n_spheres);
        const int tile = wpt_queue::tile_lanes(n, blocks);
        const int grid = min(blocks, (n + tile - 1) / tile);
        const size_t smem = launch_smem(n_tris, n_spheres);
        const auto s = static_cast<cudaStream_t>(stream);
        const auto* tri4 = reinterpret_cast<const float4*>(tri);
        const auto* sph4 = reinterpret_cast<const float4*>(sph);
        if (staged_whole(n_tris, n_spheres))
            sweep_closest_kernel<true><<<grid, QBLOCK, smem, s>>>(
                o, d, tmin, tmax, n, tile, tri4, tri_anim, n_tris, sph4, sph_anim, n_spheres,
                frames, fstride, t_out, prim_out, u_out, v_out);
        else
            sweep_closest_kernel<false><<<grid, QBLOCK, smem, s>>>(
                o, d, tmin, tmax, n, tile, tri4, tri_anim, n_tris, sph4, sph_anim, n_spheres,
                frames, fstride, t_out, prim_out, u_out, v_out);
    }
    return static_cast<int>(cudaGetLastError());
}
