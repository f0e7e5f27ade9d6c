// K1: brute-force closest hit of N rays against every triangle and sphere.
//
// Replaces wurblpt_tpu/render/intersect_mxu.py mxu_closest_hit /
// _decode_closest (and intersect.py _closest_tris / _closest_spheres for
// static scenes). The TPU version was one [N,12] x [12,4T+2S] matrix product
// at Precision.HIGHEST followed by a min-decode; here threads cast live
// rays against the primitive table in shared memory, each row read as a
// broadcast by the threads that test it.
//
// Bound on the card: FP32 CUDA-core arithmetic, about 40 flops per live
// ray and triangle (20 per sphere), unfused (-fmad=false: the mul/add stream
// issues at half the FMA peak that the bound divides by). On the bench
// frames 24-77 % of the lanes are live (t_max > t_min), scattered over the
// block, and a warp runs as long as its slowest lane; so the design issues
// the walk for live rays only:
//   - each block takes tiles of lanes and queues their live rays in shared
//     memory (the tiles, the split and the launch from live_queue.cuh, with
//     K2 and KS1); a dead lane's miss is written at once. The queue's steps
//     are written out in the kernel, with o and d read beside t_min and
//     t_max (one trip to memory): built through wpt_queue::queue_live, the
//     kernel took 58 registers for closest_hit_kernel<true>, not 60, and
//     the envmap frame's casts ran ~1.5 % slower (PERF.md).
//   - the block's threads then take the queue in order, `split` threads to
//     a ray (1, 2, 4 or 8), each testing every split-th primitive; the split
//     agrees on the first minimum through warp shuffles. Full warps of live
//     rays, and on sparse steps, where few rays are live, walks short
//     enough that their latency does not set the kernel's time. A ray cast
//     by one thread is walked with a constant stride, which the compiler
//     unrolls.
//   - the whole table (at most 64T + 16S = 128 KB at the route's 8192
//     columns, intersect_brute.brute_eligible) is staged once per block in
//     dynamic shared memory; a larger table is walked in chunks of CHUNK
//     primitives per tile.
//
// Ties go to the lowest primitive id (the strict `<` of each thread's walk
// keeps its first minimum, and `combine` the lower id at equal t),
// triangles before spheres, as in _decode_closest. A lane with tmax <= tmin
// (NaN included) is a miss and does not walk the table.
#include "brute_common.cuh"
#include "live_queue.cuh"

namespace {

using namespace wpt;
using wpt_queue::FULL;

constexpr int K1_BLOCK = wpt_queue::QBLOCK;   // threads, and lanes per tile at most
constexpr int K1_WARPS = wpt_queue::QWARPS;

struct Best {
    float t = BIG, det = 1.f, un = 0.f, vn = 0.f;
    int prim = -1;
    bool tri = false;
};

// Primitives part, part + split, ... of `cnt` rows, in order: the strict
// `<` keeps each thread's first minimum. UNIT: split is 1 (a loop with a
// constant stride, which the compiler unrolls).
template <bool UNIT>
__device__ __forceinline__ void walk_tris(const Ray& r, const float4* rows, int cnt, int first,
                                          int part, int split, Best& b) {
    for (int k = UNIT ? 0 : part; k < cnt; k += UNIT ? 1 : split) {
        float det, tn, un, vn;
        if (tri_test(r, rows + 4 * k, det, tn, un, vn)) {
            const float t = tn / det;
            if (t < b.t) {
                b.t = t;
                b.prim = first + k;
                b.det = det;
                b.un = un;
                b.vn = vn;
                b.tri = true;
            }
        }
    }
}

template <bool UNIT>
__device__ __forceinline__ void walk_spheres(const Ray& r, const float4* rows, int cnt, int first,
                                             int part, int split, Best& b) {
    for (int k = UNIT ? 0 : part; k < cnt; k += UNIT ? 1 : split) {
        float ts;
        if (sphere_test(r, rows[k], ts) && ts < b.t) {
            b.t = ts;
            b.prim = first + k;
            b.tri = false;
        }
    }
}

// The first minimum over the `split` threads of a ray (neighbouring lanes of
// a warp, split a power of 2 up to 32): the smaller t, at equal t the lower
// prim id, which is the walk's first minimum over the whole table.
__device__ __forceinline__ void combine(Best& b, int split) {
    for (int off = 1; off < split; off <<= 1) {
        const float t = __shfl_xor_sync(FULL, b.t, off);
        const int prim = __shfl_xor_sync(FULL, b.prim, off);
        const float det = __shfl_xor_sync(FULL, b.det, off);
        const float un = __shfl_xor_sync(FULL, b.un, off);
        const float vn = __shfl_xor_sync(FULL, b.vn, off);
        const bool tri = __shfl_xor_sync(FULL, static_cast<int>(b.tri), off) != 0;
        if (t < b.t || (t == b.t && prim < b.prim)) {
            b.t = t;
            b.prim = prim;
            b.det = det;
            b.un = un;
            b.vn = vn;
            b.tri = tri;
        }
    }
}

__device__ __forceinline__ void write_hit(int i, const Best& b, float* __restrict__ t_out,
                                          int* __restrict__ prim_out, float* __restrict__ u_out,
                                          float* __restrict__ v_out) {
    t_out[i] = b.t;
    prim_out[i] = b.prim;
    const float inv_det = 1.f / b.det;
    u_out[i] = b.tri ? b.un * inv_det : 0.f;
    v_out[i] = b.tri ? b.vn * inv_det : 0.f;
}

// WHOLE: the table lies in shared memory for the whole launch (its 4 n_tris
// triangle rows, then its n_spheres sphere rows); otherwise it is staged
// CHUNK primitives at a time for each tile. A tile is `tile` lanes (a
// multiple of 32, at most K1_BLOCK).
template <bool WHOLE>
__global__ void __launch_bounds__(K1_BLOCK)
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ tmin, const float* __restrict__ tmax, int n,
                   int tile, const float4* __restrict__ tri, int n_tris,
                   const float4* __restrict__ sph, int n_spheres, float cx, float cy, float cz,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
    extern __shared__ float4 s_prim[];
    // the queued live lanes' rays, as load_ray reads them, and lane ids
    // (wpt_queue::queue_live's steps, written out here)
    __shared__ float s_o[3 * K1_BLOCK], s_d[3 * K1_BLOCK], s_tmin[K1_BLOCK], s_tmax[K1_BLOCK];
    __shared__ int s_lane[K1_BLOCK];
    __shared__ int s_count[K1_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (WHOLE) {
        for (int j = threadIdx.x; j < 4 * n_tris; j += K1_BLOCK) s_prim[j] = tri[j];
        for (int j = threadIdx.x; j < n_spheres; j += K1_BLOCK) s_prim[4 * n_tris + j] = sph[j];
    }
    const int tiles = (n + tile - 1) / tile;
    for (int tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
        const int i = tl * tile + threadIdx.x;
        const bool mine = static_cast<int>(threadIdx.x) < tile && i < n;
        float lo = 0.f, hi = 0.f, ray[6];   // o and d read beside t_min and t_max
        if (mine) {
            lo = tmin[i];
            hi = tmax[i];
            for (int c = 0; c < 3; ++c) {
                ray[c] = o[3 * i + c];
                ray[3 + c] = d[3 * i + c];
            }
        }
        const bool live = mine && hi > lo;
        if (mine && !live) write_hit(i, Best{}, t_out, prim_out, u_out, v_out);
        const unsigned mask = __ballot_sync(FULL, live);
        if (lane == 0) s_count[warp] = __popc(mask);
        __syncthreads();   // the counts; the staged table; the last tile's queue read
        int pos = __popc(mask & ((1u << lane) - 1u)), total = 0;
        for (int w = 0; w < K1_WARPS; ++w) {
            const int c = s_count[w];
            pos += w < warp ? c : 0;
            total += c;
        }
        if (live) {
            for (int c = 0; c < 3; ++c) {
                s_o[3 * pos + c] = ray[c];
                s_d[3 * pos + c] = ray[3 + c];
            }
            s_tmin[pos] = lo;
            s_tmax[pos] = hi;
            s_lane[pos] = i;
        }
        __syncthreads();
        // `split` threads per queued ray, as many as the block has threads for
        const int split = wpt_queue::split_for(total);
        const int q = threadIdx.x / split, part = threadIdx.x % split;
        const bool has = q < total;
        Best b;
        if (WHOLE) {
            if (has) {
                const Ray r = load_ray(s_o, s_d, s_tmin, s_tmax, q, cx, cy, cz);
                if (split == 1) {
                    walk_tris<true>(r, s_prim, n_tris, 0, 0, 1, b);
                    walk_spheres<true>(r, s_prim + 4 * n_tris, n_spheres, n_tris, 0, 1, b);
                } else {
                    walk_tris<false>(r, s_prim, n_tris, 0, part, split, b);
                    walk_spheres<false>(r, s_prim + 4 * n_tris, n_spheres, n_tris, part, split, b);
                }
            }
        } else if (total > 0) {   // block-uniform: no barrier is skipped by a part of it
            Ray r{};
            if (has) r = load_ray(s_o, s_d, s_tmin, s_tmax, q, cx, cy, cz);
            for (int base = 0; base < n_tris; base += CHUNK) {
                const int cnt = min(CHUNK, n_tris - base);
                __syncthreads();
                for (int j = threadIdx.x; j < cnt * 4; j += K1_BLOCK)
                    s_prim[j] = tri[base * 4 + j];
                __syncthreads();
                if (has) walk_tris<false>(r, s_prim, cnt, base, part, split, b);
            }
            for (int base = 0; base < n_spheres; base += CHUNK) {
                const int cnt = min(CHUNK, n_spheres - base);
                __syncthreads();
                for (int j = threadIdx.x; j < cnt; j += K1_BLOCK) s_prim[j] = sph[base + j];
                __syncthreads();
                if (has) walk_spheres<false>(r, s_prim, cnt, n_tris + base, part, split, b);
            }
        }
        combine(b, split);
        if (has && part == 0) write_hit(s_lane[q], b, t_out, prim_out, u_out, v_out);
    }
}

// Blocks the SMs hold at once with this much shared memory.
int resident_blocks(int n_tris, int n_spheres) {
    const size_t smem = launch_smem(n_tris, n_spheres);
    return staged_whole(n_tris, n_spheres)
               ? wpt_queue::resident_blocks(closest_hit_kernel<true>, smem, STAGE_MAX)
               : wpt_queue::resident_blocks(closest_hit_kernel<false>, smem, 0);
}

}  // namespace

extern "C" int wpt_closest_hit(const float* o, const float* d, const float* tmin,
                               const float* tmax, int n, const float* tri, int n_tris,
                               const float* sph, int n_spheres, float cx, float cy, float cz,
                               float* t_out, int* prim_out, float* u_out, float* v_out,
                               void* stream) {
    if (n > 0) {
        const int blocks = resident_blocks(n_tris, n_spheres);
        const int tile = wpt_queue::tile_lanes(n, blocks);
        const int grid = min(blocks, (n + tile - 1) / tile);
        const size_t smem = launch_smem(n_tris, n_spheres);
        const auto s = static_cast<cudaStream_t>(stream);
        const auto* tri4 = reinterpret_cast<const float4*>(tri);
        const auto* sph4 = reinterpret_cast<const float4*>(sph);
        if (staged_whole(n_tris, n_spheres))
            closest_hit_kernel<true><<<grid, K1_BLOCK, smem, s>>>(
                o, d, tmin, tmax, n, tile, tri4, n_tris, sph4, n_spheres, cx, cy, cz, t_out,
                prim_out, u_out, v_out);
        else
            closest_hit_kernel<false><<<grid, K1_BLOCK, smem, s>>>(
                o, d, tmin, tmax, n, tile, tri4, n_tris, sph4, n_spheres, cx, cy, cz, t_out,
                prim_out, u_out, v_out);
    }
    return static_cast<int>(cudaGetLastError());
}
