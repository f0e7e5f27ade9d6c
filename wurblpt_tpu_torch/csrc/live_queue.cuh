// The live-lane tile queue of the brute-force casts K2 (any_hit.cu), KS1
// (sweep_closest.cu) and KS2 (sweep_any.cu), and the tiles, the split and
// the launch size of those and of K1 (closest_hit.cu), which writes the
// queue's steps out in its kernel (closest_hit.cu says why); and the
// hit-lane queue of K3's K4 form (assemble_hit.cu, `hit_slot`: the same
// tiles, keyed on the winner's prim instead of the ray's range).
//
// A cast's lanes are cut into tiles, one per block the SMs hold at once (in
// whole warps, at most QBLOCK lanes; beyond that, blocks loop over tiles).
// Each thread reads its lane's t_min and t_max, hands a dead lane (t_max <=
// t_min, NaN included) to the caller at once, and queues a live lane's ray in
// shared memory in lane order (a __ballot_sync / __popc prefix per warp). The
// block's threads then take the queue in order, `split` threads to a ray (1,
// 2, 4 or 8: as many as the block has threads for), so that warps cast live
// rays only, and sparse steps, where few rays are live, walk short shares of
// the table. No lane counter in device memory: it would need a memset before
// each cast on frames whose time is the host's.
#pragma once

#include <cuda_runtime.h>

namespace wpt_queue {

constexpr unsigned FULL = 0xffffffffu;
constexpr int QBLOCK = 512;               // threads of a block, and lanes of a tile at most
constexpr int QWARPS = QBLOCK / 32;
constexpr int MAX_SPLIT = 8;              // threads per live ray, at most

// The queued live lanes' rays as the lanes hold them, their lane ids and
// each warp's count: views of shared arrays that the kernel declares,
//     __shared__ float s_o[3 * QBLOCK], s_d[3 * QBLOCK], s_tmin[QBLOCK], s_tmax[QBLOCK];
//     __shared__ int s_lane[QBLOCK], s_count[QWARPS];
//     const wpt_queue::Queue q{s_o, s_d, s_tmin, s_tmax, s_lane, s_count};
// (in the kernel's own scope, where the compiler treats them as its locals).
struct Queue {
    float *o, *d, *tmin, *tmax;
    int *lane, *count;
};

// Queues the live lanes of tile `tl` (`tile` lanes) and returns how many;
// calls dead(i) for each dead lane i of the tile, which reads nothing but
// its t_min and t_max (o and d are read for live lanes only). `lane` and
// `warp` are the thread's lane in its warp and its warp in the block.
// Every thread of the block calls it: two barriers, the first of which also
// orders the block's earlier writes of shared memory (a staged table) and
// its reads of the last tile's queue before the queue is written.
template <class Dead>
__device__ __forceinline__ int queue_live(const Queue& q, int lane, int warp, int tl, int tile,
                                          int n,
                                          const float* __restrict__ o,
                                          const float* __restrict__ d,
                                          const float* __restrict__ tmin,
                                          const float* __restrict__ tmax, Dead dead) {
    const int i = tl * tile + threadIdx.x;
    const bool mine = static_cast<int>(threadIdx.x) < tile && i < n;
    float lo = 0.f, hi = 0.f, ray[6];
    if (mine) {
        lo = tmin[i];
        hi = tmax[i];
    }
    const bool live = mine && hi > lo;
    if (live)
        for (int c = 0; c < 3; ++c) {
            ray[c] = o[3 * i + c];
            ray[3 + c] = d[3 * i + c];
        }
    if (mine && !live) dead(i);
    const unsigned mask = __ballot_sync(FULL, live);
    if (lane == 0) q.count[warp] = __popc(mask);
    __syncthreads();   // the counts; a staged table; the last tile's queue read
    int pos = __popc(mask & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < QWARPS; ++w) {
        const int c = q.count[w];
        pos += w < warp ? c : 0;
        total += c;
    }
    if (live) {
        for (int c = 0; c < 3; ++c) {
            q.o[3 * pos + c] = ray[c];
            q.d[3 * pos + c] = ray[3 + c];
        }
        q.tmin[pos] = lo;
        q.tmax[pos] = hi;
        q.lane[pos] = i;
    }
    __syncthreads();
    return total;
}

// The queue slot of this thread's lane among the hit lanes of a tile of the
// hit assembly (assemble_hit.cu), or -1: two bins, each in lane order,
// triangle winners (`tri`) from the front, then sphere winners (`sph`);
// `total` gets the queue's length. Every thread of the block calls it,
// after it has issued its lane's loads: one barrier (the bins' per-warp
// counts in `s_count`, 2 * QWARPS), which also orders the block's reads of
// the last tile's queue before the caller writes this one; the caller
// writes its slot and meets a barrier of its own before the queue is read.
__device__ __forceinline__ int hit_slot(int* s_count, int lane, int warp, bool tri, bool sph,
                                        int& total) {
    const unsigned mt = __ballot_sync(FULL, tri);
    const unsigned ms = __ballot_sync(FULL, sph);
    if (lane == 0) {
        s_count[warp] = __popc(mt);
        s_count[QWARPS + warp] = __popc(ms);
    }
    __syncthreads();   // the counts; the last tile's queue read
    const unsigned below = (1u << lane) - 1u;
    int pt = __popc(mt & below), ps = __popc(ms & below), nt = 0, ns = 0;
    for (int w = 0; w < QWARPS; ++w) {
        const int ct = s_count[w], cs = s_count[QWARPS + w];
        pt += w < warp ? ct : 0;
        ps += w < warp ? cs : 0;
        nt += ct;
        ns += cs;
    }
    total = nt + ns;
    return tri ? pt : (sph ? nt + ps : -1);
}

// The bits of the `split` neighbouring lanes of this thread's warp that
// cast its ray (split a power of 2 up to 8).
__device__ __forceinline__ unsigned ray_lanes(int split) {
    return ((1u << split) - 1u) << ((threadIdx.x & 31) & ~(split - 1));
}

// Threads per queued ray: as many as the block has threads for, at most MAX_SPLIT.
__device__ __forceinline__ int split_for(int total) {
    int split = 1;
    while (split < MAX_SPLIT && total * split * 2 <= QBLOCK) split *= 2;
    return split;
}

// Blocks of `kernel` (QBLOCK threads) that the SMs hold at once with `smem`
// bytes of dynamic shared memory, asked once per 16 KB step of it for each
// of up to four kernels of one signature; `max_smem` (above 48 KB: the most
// any launch of the kernel takes) is allowed first.
template <class Kernel>
int resident_blocks(Kernel kernel, size_t smem, int max_smem) {
    constexpr int STEP = 16384, STEPS = 232448 / STEP + 1;
    static Kernel kernels[4] = {};
    static int resident[4][STEPS] = {};
    int k = 0;
    while (k < 3 && kernels[k] != kernel && kernels[k] != nullptr) ++k;
    kernels[k] = kernel;
    const int step = static_cast<int>((smem + STEP - 1) / STEP);
    int& blocks = resident[k][step];
    if (blocks == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (max_smem > 49152)
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, QBLOCK,
                                                      static_cast<size_t>(step) * STEP);
        blocks = sms * (per_sm > 0 ? per_sm : 1);
    }
    return blocks;
}

// Lanes per tile: the lanes spread evenly over the blocks the SMs hold at
// once, in whole warps, at most QBLOCK; beyond that, blocks loop over tiles.
inline int tile_lanes(int n, int blocks) {
    const long long per_block = (static_cast<long long>(n) + blocks - 1) / blocks;
    return static_cast<int>(min(static_cast<long long>(QBLOCK), (per_block + 31) / 32 * 32));
}

}  // namespace wpt_queue
