// K2: brute-force any-hit (occlusion) of N shadow rays in (tmin, tmax).
//
// Replaces wurblpt_tpu/render/intersect_mxu.py mxu_any_hit / _decode_any
// (and intersect.py _any_tris / _any_spheres for static scenes): the same
// feature matmul as K1 with a pure-OR decode. Here threads cast live rays
// against the primitive table in shared memory and stop at a ray's first
// blocker.
//
// Bound on the card: FP32 CUDA-core arithmetic from shared memory, as K1,
// with an early exit; on the bench frames a third to three quarters of the
// lanes cast no shadow ray (t_max <= t_min), and most rays that do are not
// occluded, so they walk the whole table. The design:
//   - live rays only: each block takes tiles of lanes and queues their live
//     rays in shared memory (live_queue.cuh, K1's queue); a dead lane
//     writes `false` at once and reads nothing but t_min and t_max. The
//     table is staged once per block (whole up to 128 KB, else in chunks).
//   - a thread per queued ray on dense steps, each stopping at its own
//     first blocker; `split` threads per ray on sparse ones (2, 4 or 8),
//     each testing every split-th primitive in rounds, one primitive each a
//     round, with a ballot after each round that tells every thread whether
//     its ray is blocked: all of a ray's threads stop at once, and a warp
//     stops when all its rays have.
//   - the range first: a pair computes det and t_num, and u_num and v_num
//     (12 of its products) only where the plane hit lies in (tmin, tmax),
//     a branch a warp skips when none of its threads takes it (in rounds,
//     by a vote). A shadow segment lies inside the box it is cast in, so
//     the walls' and the light's own rows end there.
//   - a table of at most DIRECT_PRIMS primitives takes a thread per lane
//     and no queue (any_hit_small_kernel): there the queue's barriers and
//     its second trip to memory cost more than they save.
// Exact: the predicate is tri_test's conjunction of the same rounded
// values, evaluated lazily, and the result is an OR over the table, which
// the order of the walk cannot change.
//
// Left for later: sorting the table so likely occluders come first; merging
// this cast with the next bounce's closest cast (the JAX package's
// default-off fused_nee was a measured loss on the TPU).
#include "brute_common.cuh"
#include "live_queue.cuh"

namespace {

using namespace wpt;
using wpt_queue::FULL;
using wpt_queue::QBLOCK;
using wpt_queue::QWARPS;
using wpt_queue::ray_lanes;

// tri_test's verdict on one row, the range first: det and t_num, then, where
// the plane hit lies in (tmin, tmax) for the thread (VOTE: for a thread of
// the warp, which every thread of it reaches), u_num and v_num. False where
// `active` is.
template <bool VOTE>
__device__ __forceinline__ bool tri_blocks(const Ray& r, const float4* __restrict__ row,
                                           bool active) {
    const float4 c0 = row[0];
    const float det = -(r.dx * c0.x + r.dy * c0.y + r.dz * c0.z);
    const float tn = -c0.w + r.ox * c0.x + r.oy * c0.y + r.oz * c0.z;
    const float s = sgn(det), ad = fabsf(det);
    bool hit = active && ad > 1e-12f && tn * s > r.tmin * ad && tn * s < r.tmax * ad;
    if (VOTE ? __any_sync(FULL, hit) : hit) {
        const float4 c1 = row[1], c2 = row[2], c3 = row[3];
        const float un =
            r.dx * c1.x + r.dy * c1.y + r.dz * c1.z + r.xx * c1.w + r.xy * c2.x + r.xz * c2.y;
        const float vn =
            -(r.dx * c2.z + r.dy * c2.w + r.dz * c3.x + r.xx * c3.y + r.xy * c3.z + r.xz * c3.w);
        hit = hit && un * s >= 0.f && vn * s >= 0.f && (un + vn) * s <= ad;
    }
    return hit;
}

// Rows part, part + split, ... of `cnt` (triangle rows of 4 float4, or
// sphere rows), in rounds until the ray is blocked; `blocked` comes in true
// for a thread without a ray. Every thread of the warp runs every round:
// the votes need them all.
template <bool SPHERES>
__device__ __forceinline__ bool walk(const Ray& r, const float4* rows, int cnt, int part,
                                     int split, unsigned lanes, bool blocked) {
    for (int base = 0; base < cnt; base += split) {
        if (!__any_sync(FULL, !blocked)) break;
        const int k = min(base + part, cnt - 1);
        const bool active = !blocked && base + part < cnt;
        bool hit;
        if (SPHERES) {
            float ts;
            hit = active && sphere_test(r, rows[k], ts);
        } else {
            hit = tri_blocks<true>(r, rows + 4 * k, active);
        }
        const unsigned hits = __ballot_sync(FULL, hit);
        blocked = blocked || (hits & lanes) != 0;
    }
    return blocked;
}

// One thread's ray against rows 0 .. cnt - 1, up to its first blocker.
template <bool SPHERES>
__device__ __forceinline__ bool walk_alone(const Ray& r, const float4* rows, int cnt) {
    for (int k = 0; k < cnt; ++k) {
        float ts;
        if (SPHERES ? sphere_test(r, rows[k], ts) : tri_blocks<false>(r, rows + 4 * k, true))
            return true;
    }
    return false;
}

// WHOLE: the table lies in shared memory for the whole launch (its 4 n_tris
// triangle rows, then its n_spheres sphere rows); otherwise it is staged
// CHUNK primitives at a time for each tile, while a ray of the block is
// still unblocked. A tile is `tile` lanes (a multiple of 32, at most QBLOCK).
template <bool WHOLE>
__global__ void __launch_bounds__(QBLOCK)
any_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax, int n, int tile,
               const float4* __restrict__ tri, int n_tris, const float4* __restrict__ sph,
               int n_spheres, float cx, float cy, float cz, bool* __restrict__ occluded) {
    extern __shared__ float4 s_prim[];
    // the queued live lanes' rays and lane ids (live_queue.cuh)
    __shared__ float s_o[3 * QBLOCK], s_d[3 * QBLOCK], s_tmin[QBLOCK], s_tmax[QBLOCK];
    __shared__ int s_lane[QBLOCK];
    __shared__ int s_count[QWARPS];
    const wpt_queue::Queue q{s_o, s_d, s_tmin, s_tmax, s_lane, s_count};
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (WHOLE) {
        for (int j = threadIdx.x; j < 4 * n_tris; j += QBLOCK) s_prim[j] = tri[j];
        for (int j = threadIdx.x; j < n_spheres; j += QBLOCK) s_prim[4 * n_tris + j] = sph[j];
    }
    const int tiles = (n + tile - 1) / tile;
    for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
        const int total = wpt_queue::queue_live(
            q, lane, warp, tl, tile, n, o, d, tmin, tmax, [=](int i) { occluded[i] = false; });
        const int split = wpt_queue::split_for(total);
        const int qi = threadIdx.x / split, part = threadIdx.x % split;
        const bool has = qi < total;
        const unsigned lanes = ray_lanes(split);
        Ray r{};
        if (has) r = load_ray(s_o, s_d, s_tmin, s_tmax, qi, cx, cy, cz);
        bool blocked = !has;
        if (WHOLE && split == 1) {
            blocked = blocked || walk_alone<false>(r, s_prim, n_tris) ||
                      walk_alone<true>(r, s_prim + 4 * n_tris, n_spheres);
        } else if (WHOLE) {
            blocked = walk<false>(r, s_prim, n_tris, part, split, lanes, blocked);
            blocked = walk<true>(r, s_prim + 4 * n_tris, n_spheres, part, split, lanes, blocked);
        } else {   // block-uniform: no barrier is skipped by a part of it
            for (int base = 0; base < n_tris; base += CHUNK) {
                if (!__syncthreads_or(!blocked)) break;
                const int cnt = min(CHUNK, n_tris - base);
                for (int j = threadIdx.x; j < cnt * 4; j += QBLOCK) s_prim[j] = tri[base * 4 + j];
                __syncthreads();
                blocked = walk<false>(r, s_prim, cnt, part, split, lanes, blocked);
            }
            for (int base = 0; base < n_spheres; base += CHUNK) {
                if (!__syncthreads_or(!blocked)) break;
                const int cnt = min(CHUNK, n_spheres - base);
                for (int j = threadIdx.x; j < cnt; j += QBLOCK) s_prim[j] = sph[base + j];
                __syncthreads();
                blocked = walk<true>(r, s_prim, cnt, part, split, lanes, blocked);
            }
        }
        if (has && part == 0) occluded[s_lane[qi]] = blocked;
    }
}

// A table of at most DIRECT_PRIMS primitives: a thread per lane, no queue.
// The queue's two barriers and its second trip to memory (o and d, read for
// live lanes once t_min and t_max are in) cost more than the dead lanes'
// share of so short a walk (the envmap frame's 5 primitives: 3.8 µs a
// launch against 4.5 through the queue on an H100; PERF.md).
constexpr int DIRECT_PRIMS = 16;
constexpr int DIRECT_BLOCK = 128;

__global__ void __launch_bounds__(DIRECT_BLOCK)
any_hit_small_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
               const float4* __restrict__ tri, int n_tris, const float4* __restrict__ sph,
               int n_spheres, float cx, float cy, float cz, bool* __restrict__ occluded) {
    __shared__ float4 s_prim[4 * DIRECT_PRIMS];
    for (int j = threadIdx.x; j < 4 * n_tris; j += DIRECT_BLOCK) s_prim[j] = tri[j];
    for (int j = threadIdx.x; j < n_spheres; j += DIRECT_BLOCK) s_prim[4 * n_tris + j] = sph[j];
    const int i = blockIdx.x * DIRECT_BLOCK + threadIdx.x;
    const bool live = i < n && tmax[i] > tmin[i];
    __syncthreads();
    if (i < n) {
        bool blocked = false;
        if (live) {
            const Ray r = load_ray(o, d, tmin, tmax, i, cx, cy, cz);
            blocked = walk_alone<false>(r, s_prim, n_tris) ||
                      walk_alone<true>(r, s_prim + 4 * n_tris, n_spheres);
        }
        occluded[i] = blocked;
    }
}

inline bool direct(int n_tris, int n_spheres) { return n_tris + n_spheres <= DIRECT_PRIMS; }

// Blocks the SMs hold at once with this much shared memory.
int resident_blocks(int n_tris, int n_spheres) {
    const size_t smem = launch_smem(n_tris, n_spheres);
    return staged_whole(n_tris, n_spheres)
               ? wpt_queue::resident_blocks(any_hit_kernel<true>, smem, STAGE_MAX)
               : wpt_queue::resident_blocks(any_hit_kernel<false>, smem, 0);
}

}  // namespace

extern "C" int wpt_any_hit(const float* o, const float* d, const float* tmin, const float* tmax,
                           int n, const float* tri, int n_tris, const float* sph, int n_spheres,
                           float cx, float cy, float cz, bool* occluded, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* tri4 = reinterpret_cast<const float4*>(tri);
    const auto* sph4 = reinterpret_cast<const float4*>(sph);
    if (n > 0 && direct(n_tris, n_spheres)) {
        any_hit_small_kernel<<<(n + DIRECT_BLOCK - 1) / DIRECT_BLOCK, DIRECT_BLOCK, 0, s>>>(
            o, d, tmin, tmax, n, tri4, n_tris, sph4, n_spheres, cx, cy, cz, occluded);
    } else if (n > 0) {
        const int blocks = resident_blocks(n_tris, n_spheres);
        const int tile = wpt_queue::tile_lanes(n, blocks);
        const int grid = min(blocks, (n + tile - 1) / tile);
        const size_t smem = launch_smem(n_tris, n_spheres);
        if (staged_whole(n_tris, n_spheres))
            any_hit_kernel<true><<<grid, QBLOCK, smem, s>>>(o, d, tmin, tmax, n, tile, tri4,
                                                            n_tris, sph4, n_spheres, cx, cy, cz,
                                                            occluded);
        else
            any_hit_kernel<false><<<grid, QBLOCK, smem, s>>>(o, d, tmin, tmax, n, tile, tri4,
                                                             n_tris, sph4, n_spheres, cx, cy, cz,
                                                             occluded);
    }
    return static_cast<int>(cudaGetLastError());
}
