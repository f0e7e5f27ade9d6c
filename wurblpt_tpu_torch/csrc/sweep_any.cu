// KS2: the brute-force sweep's any hit (occlusion) of N shadow rays in
// (tmin, tmax), static or animated.
//
// Replaces wurblpt_tpu/render/intersect.py _any_tris (:397) and
// _any_spheres (:434): the validity-only fold of the tiled sweep, with KS1's
// exact tests (sweep_common.cuh), in each primitive's object space where the
// scene is animated. The result is an OR over the table, which the order of
// the walk cannot change, so any thread may stop at any blocker.
//
// Bound on the card: as KS1, FP32 pair tests from shared memory, with an
// early exit. On the animated Cornell box (P = 36, N = 131072) the NEE
// rays of the later steps are few: most lanes arrive dead (t_max = 0), and
// most live rays are not occluded, so they walk the whole table. The design
// casts live rays only (KS1's and K2's tile queue, live_queue.cuh):
//   - each block takes tiles of lanes and queues their live rays in shared
//     memory; a dead lane (t_max <= t_min, NaN included) writes `false` at
//     once and reads nothing but t_min and t_max. The table and its
//     animation ids are staged once per block for the launch where they fit
//     (STAGE_MAX), else CHUNK primitives at a time, and only while a ray of
//     the tile is unblocked.
//   - a thread per queued ray on dense steps, each stopping at its own first
//     blocker; `split` threads per ray on sparse ones (2, 4 or 8), each
//     testing every split-th primitive in rounds, one primitive each a round,
//     with a ballot after each round that tells every thread whether its ray
//     is blocked: all of a ray's threads stop at once, and a warp stops when
//     all its rays have. Every thread keeps its own cache of the object ray
//     per animation id (Lane::rays_of).
#include "live_queue.cuh"
#include "sweep_common.cuh"

namespace {

using namespace wpt_sweep;
using wpt_queue::FULL;
using wpt_queue::QBLOCK;
using wpt_queue::QWARPS;
using wpt_queue::ray_lanes;

// Whether row k of `rows` (a triangle's 3 float4 or a sphere's float4, its
// animation id aid[k]) blocks the ray in (tmin, tmax).
template <bool SPHERES>
__device__ __forceinline__ bool blocks(Lane& r, const float4* rows, const int* aid, int k) {
    V3 ro, rd;
    r.rays_of(aid[k], ro, rd);
    float t, u, v;
    if constexpr (SPHERES) return sphere_test(ro, rd, rows[k], r.tmin, r.tmax, t);
    const float4 p = rows[3 * k], e = rows[3 * k + 1], f = rows[3 * k + 2];
    return tri_test(ro, rd, {p.x, p.y, p.z}, {e.x, e.y, e.z}, {f.x, f.y, f.z}, r.tmin, r.tmax, t,
                    u, v);
}

// Rows part, part + split, ... of `cnt`, in rounds until the ray is
// blocked; `blocked` comes in true for a thread without a ray. Every thread
// of the warp runs every round (cnt is the block's): the votes need them all.
template <bool SPHERES>
__device__ __forceinline__ bool walk(Lane& r, const float4* rows, const int* aid, int cnt,
                                     int part, int split, unsigned lanes, bool blocked) {
    for (int base = 0; base < cnt; base += split) {
        if (!__any_sync(FULL, !blocked)) break;
        const bool hit =
            !blocked && base + part < cnt && blocks<SPHERES>(r, rows, aid, base + part);
        const unsigned hits = __ballot_sync(FULL, hit);   // outside `||`: every thread votes
        blocked = blocked || (hits & lanes) != 0;
    }
    return blocked;
}

// One thread's ray against rows 0 .. cnt - 1, up to its first blocker.
template <bool SPHERES>
__device__ __forceinline__ bool walk_alone(Lane& r, const float4* rows, const int* aid,
                                           int cnt) {
    for (int k = 0; k < cnt; ++k)
        if (blocks<SPHERES>(r, rows, aid, k)) return true;
    return false;
}

// Dynamic shared memory (sweep_common.cuh): WHOLE, the whole table for the
// whole launch; otherwise CHUNK primitives at a time for each tile. A tile is
// `tile` lanes (a multiple of 32, at most QBLOCK).
template <bool WHOLE>
__global__ void __launch_bounds__(QBLOCK)
sweep_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmin, const float* __restrict__ tmax, int n, int tile,
                 const float4* __restrict__ tri, const int* __restrict__ tri_anim, int n_tris,
                 const float4* __restrict__ sph, const int* __restrict__ sph_anim, int n_spheres,
                 const float* __restrict__ frames, long long fstride,
                 bool* __restrict__ occluded) {
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
            q, lane, warp, tl, tile, n, o, d, tmin, tmax, [=](int i) { occluded[i] = false; });
        const int split = wpt_queue::split_for(total);
        const int qi = threadIdx.x / split, part = threadIdx.x % split;
        const bool has = qi < total;
        const unsigned lanes = ray_lanes(split);
        bool blocked = !has;
        if (WHOLE) {
            Lane r{};
            if (has) r = load_lane(s_o, s_d, s_tmin, s_tmax,
                                  lane_frames(frames, fstride, s_lane[qi]), qi);
            if (split == 1) {
                blocked = blocked || walk_alone<false>(r, s_rows, s_aid, n_tris) ||
                          walk_alone<true>(r, s_rows + 3 * n_tris, s_aid + n_tris, n_spheres);
            } else {
                blocked = walk<false>(r, s_rows, s_aid, n_tris, part, split, lanes, blocked);
                blocked = walk<true>(r, s_rows + 3 * n_tris, s_aid + n_tris, n_spheres, part,
                                     split, lanes, blocked);
            }
        } else {   // block-uniform: no barrier is skipped by a part of it
            // the ray is taken from the queue again after each barrier: less
            // to keep in registers across them
            for (int base = 0; base < n_tris; base += CHUNK) {
                if (!__syncthreads_or(!blocked)) break;
                const int cnt = min(CHUNK, n_tris - base);
                for (int j = threadIdx.x; j < 3 * cnt; j += QBLOCK) s_rows[j] = tri[3 * base + j];
                for (int j = threadIdx.x; j < cnt; j += QBLOCK) s_aid[j] = tri_anim[base + j];
                __syncthreads();
                Lane r{};
                if (has) r = load_lane(s_o, s_d, s_tmin, s_tmax,
                                  lane_frames(frames, fstride, s_lane[qi]), qi);
                blocked = walk<false>(r, s_rows, s_aid, cnt, part, split, lanes, blocked);
            }
            for (int base = 0; base < n_spheres; base += CHUNK) {
                if (!__syncthreads_or(!blocked)) break;
                const int cnt = min(CHUNK, n_spheres - base);
                for (int j = threadIdx.x; j < cnt; j += QBLOCK) {
                    s_rows[j] = sph[base + j];
                    s_aid[j] = sph_anim[base + j];
                }
                __syncthreads();
                Lane r{};
                if (has) r = load_lane(s_o, s_d, s_tmin, s_tmax,
                                  lane_frames(frames, fstride, s_lane[qi]), qi);
                blocked = walk<true>(r, s_rows, s_aid, cnt, part, split, lanes, blocked);
            }
        }
        if (has && part == 0) occluded[s_lane[qi]] = blocked;
    }
}

// Blocks the SMs hold at once with this much shared memory.
int any_resident_blocks(int n_tris, int n_spheres) {
    const size_t smem = launch_smem(n_tris, n_spheres);
    return staged_whole(n_tris, n_spheres)
               ? wpt_queue::resident_blocks(sweep_any_kernel<true>, smem, STAGE_MAX)
               : wpt_queue::resident_blocks(sweep_any_kernel<false>, smem, 0);
}

}  // namespace

extern "C" int wpt_sweep_any(const float* o, const float* d, const float* tmin, const float* tmax,
                             int n, const float* tri, const int* tri_anim, int n_tris,
                             const float* sph, const int* sph_anim, int n_spheres,
                             const float* frames, long long fstride, bool* occluded,
                             void* stream) {
    if (n > 0) {
        const int blocks = any_resident_blocks(n_tris, n_spheres);
        const int tile = wpt_queue::tile_lanes(n, blocks);
        const int grid = min(blocks, (n + tile - 1) / tile);
        const size_t smem = launch_smem(n_tris, n_spheres);
        const auto s = static_cast<cudaStream_t>(stream);
        const auto* tri4 = reinterpret_cast<const float4*>(tri);
        const auto* sph4 = reinterpret_cast<const float4*>(sph);
        if (staged_whole(n_tris, n_spheres))
            sweep_any_kernel<true><<<grid, QBLOCK, smem, s>>>(
                o, d, tmin, tmax, n, tile, tri4, tri_anim, n_tris, sph4, sph_anim, n_spheres,
                frames, fstride, occluded);
        else
            sweep_any_kernel<false><<<grid, QBLOCK, smem, s>>>(
                o, d, tmin, tmax, n, tile, tri4, tri_anim, n_tris, sph4, sph_anim, n_spheres,
                frames, fstride, occluded);
    }
    return static_cast<int>(cudaGetLastError());
}
