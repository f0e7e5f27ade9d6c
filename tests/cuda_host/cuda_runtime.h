// Host stand-in for the CUDA pieces that csrc/bvh_common.cuh, the device
// code of csrc/wavefront.cu, of the brute-force casts and sweeps, of the
// row gather and of the backward kernels (backward_common.cuh) use, so
// that these kernels compile with g++ and run on the CPU: one block at a
// time, one std::thread per CUDA thread, the warp intrinsics through a
// barrier per warp (every thread of a warp calls them in the same order),
// __syncthreads through a barrier per block, shared memory as statics of
// the running block.
// Arithmetic is the host's IEEE float32 with -ffp-contract=off, as the
// kernels' -fmad=false; sinf, cosf, powf and the like are the host's libm.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)

struct float3 { float x, y, z; };
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct dim3 { unsigned x, y, z; };

inline float3 make_float3(float a, float b, float c) { return {a, b, c}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }

extern thread_local dim3 threadIdx, blockIdx;
extern dim3 gridDim, blockDim;

template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __fns(unsigned mask, unsigned base, int offset) {   // offset > 0 only
    for (unsigned b = base; b < 32; ++b)
        if (((mask >> b) & 1u) && --offset == 0) return b;
    return 0xffffffffu;
}
using std::isfinite;
using std::max;
using std::min;
// CUDA's min and max of two integer types of different widths
template <class A, class B, class = std::enable_if_t<!std::is_same_v<A, B>>>
inline std::common_type_t<A, B> min(A a, B b) { return a < b ? a : b; }
template <class A, class B, class = std::enable_if_t<!std::is_same_v<A, B>>>
inline std::common_type_t<A, B> max(A a, B b) { return a < b ? b : a; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
    return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
    return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline float atomicAdd(float* p, float v) { return std::atomic_ref<float>(*p).fetch_add(v); }
// sm_90's vector atomic on global memory: each word added atomically
inline float4 atomicAdd(float4* p, float4 v) {
    return {atomicAdd(&p->x, v.x), atomicAdd(&p->y, v.y), atomicAdd(&p->z, v.z),
            atomicAdd(&p->w, v.w)};
}

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
inline bool __any_sync(unsigned, bool p) { return __ballot_sync(0xffffffffu, p) != 0u; }
inline int __shfl_sync(unsigned, int v, int src) {
    unsigned all[32];
    exchange(static_cast<unsigned>(v), all);
    return static_cast<int>(all[src]);
}
inline int __shfl_xor_sync(unsigned, int v, int mask) {
    unsigned all[32];
    exchange(static_cast<unsigned>(v), all);
    return static_cast<int>(all[(threadIdx.x % 32) ^ static_cast<unsigned>(mask)]);
}
inline float __shfl_xor_sync(unsigned m, float v, int mask) {
    return __int_as_float(__shfl_xor_sync(m, __float_as_int(v), mask));
}
inline float __shfl_sync(unsigned m, float v, int src) {
    return __int_as_float(__shfl_sync(m, __float_as_int(v), src));
}
inline unsigned __match_any_sync(unsigned, int key) {
    unsigned all[32], m = 0;
    exchange(static_cast<unsigned>(key), all);
    for (int i = 0; i < 32; ++i) m |= all[i] == static_cast<unsigned>(key) ? (1u << i) : 0u;
    return m;
}
inline int __reduce_max_sync(unsigned, int v) {
    unsigned all[32];
    exchange(static_cast<unsigned>(v), all);
    int most = static_cast<int>(all[0]);
    for (int i = 1; i < 32; ++i) most = std::max(most, static_cast<int>(all[i]));
    return most;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
    unsigned all[32];
    exchange(0u, all);
}
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
    unsigned all[32], sum = 0;
    exchange(v, all);
    for (int i = 0; i < 32; ++i) sum += all[i];
    return sum;
}

// The running block's barrier and the word its votes add into.
struct BlockSync {
    std::barrier<> bar;
    std::atomic<int> votes{0};
    explicit BlockSync(int threads) : bar(threads) {}
};
extern BlockSync* g_block;

inline void __syncthreads() { g_block->bar.arrive_and_wait(); }
inline int __syncthreads_count(bool p) {
    g_block->votes += p ? 1 : 0;
    __syncthreads();
    const int n = g_block->votes;
    __syncthreads();
    if (threadIdx.x == 0) g_block->votes = 0;
    __syncthreads();
    return n;
}
inline bool __syncthreads_or(bool p) { return __syncthreads_count(p) > 0; }

// The launch configuration queries of a persistent launch: one SM here.
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 1; return 0; }
template <class K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, K, int, size_t) {
    *b = 2;
    return 0;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
inline int cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
