// Host stand-in for the CUDA pieces that csrc/bvh_common.cuh uses, so that
// the walk of K5/K6 compiles with g++ and runs on the CPU: one block at a
// time, one std::thread per CUDA thread, the warp intrinsics through a
// barrier per warp (every thread of a warp calls them in the same order).
// Arithmetic is the host's IEEE float32 with -ffp-contract=off, as the
// kernels' -fmad=false.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>

#define __device__
#define __global__
#define __forceinline__ inline
#define __shared__ static

struct float3 { float x, y, z; };
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
struct dim3 { unsigned x, y, z; };

inline float3 make_float3(float a, float b, float c) { return {a, b, c}; }
inline int2 make_int2(int a, int b) { return {a, b}; }

extern thread_local dim3 threadIdx, blockIdx;
extern dim3 gridDim;

template <class T> inline T __ldg(const T* p) { return *p; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __fns(unsigned mask, unsigned base, int offset) {   // offset > 0 only
    for (unsigned b = base; b < 32; ++b)
        if (((mask >> b) & 1u) && --offset == 0) return b;
    return 0xffffffffu;
}
using std::min;
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }

struct WarpSync {
    std::barrier<> bar{32};
    unsigned vals[32];
};
extern WarpSync* g_warps;   // one per warp of the running block

inline void exchange(unsigned v, unsigned* all) {
    WarpSync& w = g_warps[threadIdx.x / 32];
    w.vals[threadIdx.x % 32] = v;
    w.bar.arrive_and_wait();
    std::memcpy(all, w.vals, sizeof(w.vals));
    w.bar.arrive_and_wait();
}
inline unsigned __ballot_sync(unsigned, bool p) {
    unsigned all[32], m = 0;
    exchange(p ? 1u : 0u, all);
    for (int i = 0; i < 32; ++i) m |= all[i] ? (1u << i) : 0u;
    return m;
}
inline bool __all_sync(unsigned, bool p) { return __ballot_sync(0xffffffffu, p) == 0xffffffffu; }
inline int __shfl_sync(unsigned, int v, int src) {
    unsigned all[32];
    exchange(static_cast<unsigned>(v), all);
    return static_cast<int>(all[src]);
}
