// Shared walk of the BVH kernels K5 (bvh_closest.cu) and K6 (bvh_any.cu).
//
// Replaces the wide-BVH lockstep walk of wurblpt_tpu/accel/traverse.py
// (_wide_closest_hit / _wide_any_hit with _wide_walk_to_leaf,
// _wide_children, _stack_push_sorted, _stack_pop, _packed_leaf_tests) and
// intersect.watertight_tri. The TPU walked all rays in lockstep over W=32
// wide rows, kept each ray's stack as one-hot masked [N, D] arrays and
// re-packed the live lanes into ever smaller batches, because its gathers
// are priced per row and its lanes cannot diverge.
//
// Bound on the card: latency and instruction slots, not bytes. A walk is a
// chain of dependent loads (a node row, then the child it picks) over tables
// that stay in the 50 MB L2 (city: 2.4 MB of nodes, 12 MB of triangle rows),
// and its arithmetic is a few percent of the time (PERF.md). The first
// kernels, one thread per lane with a 64-entry stack in local memory, lost
// the time two ways, and the design answers each (measured on an H100,
// PERF.md):
//
// 1. Idle lanes. One thread per lane left dead lanes (t_max <= t_min) and
//    finished rays idle inside their warps; at 1 spp the city's later casts
//    are sparse and incoherent. Here the launch is persistent (as many blocks
//    as the SMs hold), warps take lanes in chunks of 32 from a counter
//    (atomicAdd), write the outputs of the dead ones at once and queue the
//    live ones (__ballot_sync); a thread whose ray has finished takes the next
//    queued lane, so a warp stays full while live rays remain (Aila and
//    Laine's persistent while-while walk: inner nodes until a leaf, then the
//    leaf). The wrapper zeroes the counter with a memset on the stream.
// 2. A stack in local memory. 512 B per thread overflowed L1 at full
//    occupancy. Here a thread's first SHORT entries live in shared memory
//    (entry k at [k][threadIdx]: no bank conflict), and only a walk deeper
//    than that spills to rows of device memory that the wrapper sizes from
//    the tree's depth (the build refuses a tree past STACK_DEPTH). No
//    per-thread array is indexed at run time.
// A leaf triangle is one 48-byte row (three 16-byte loads, the prim id in
// v0's pad) instead of nine scalar loads. A compressed 8-wide tree (Ylitie
// et al. 2017) was measured in place of the binary one and walked slower:
// its decode and ordering of 8 children cost more instruction slots than the
// dependent loads it saves while the tables sit in L2 (PERF.md).
//
// Order and ties: the closest-hit walk descends into the nearer hit child
// (child 0 on a tie) and pushes the other with its entry distance; the
// any-hit walk takes child 0 first, since its result does not depend on the
// order. Both pop the topmost entry nearer than min(t_max, best t), dropping
// those above. The closest hit keeps the first strictly nearer hit in the
// walk's order (a tie keeps the triangle found first); the any-hit walk
// stops at the first hit. The plain version (accel/traverse.py) takes the
// same decisions in the same order, so prim ids agree exactly.
//
// Every expression is evaluated in the order of the plain PyTorch version
// (render/intersect.py watertight_tri for the leaf test) and the library is
// built with -fmad=false, so kernel and plain version round alike. The
// Dekker split of two_prod uses the _rn intrinsics, which are never
// contracted.
//
// Node row (accel/build.py): [child 0 min xyz, max xyz, child 1 min xyz,
// max xyz, link 0, link 1 (int32 bits), pad, pad]. A link >= 0 is an inner
// node, -1 an empty child, any other negative value a leaf holding rows
// [start, start + count) of the triangle table with -1 - link = start * 16
// + count.
#pragma once

#include <cuda_runtime.h>

namespace wpt_bvh {

constexpr float BIG = 3.0e37f;
constexpr int BLOCK = 128;        // threads per block
constexpr int MIN_BLOCKS = 4;     // resident blocks per SM the registers must allow
constexpr int SHORT = 16;         // stack entries per thread in shared memory (SHARED_STACK)
constexpr int EMPTY = -1;         // link of an empty child
constexpr unsigned FULL = 0xffffffffu;

struct Ray {
    float3 o, d, inv;
    int kx, ky, kz;          // watertight axis permutation
    float sx, sy, sz;        // watertight shear
};

__device__ __forceinline__ float sgn(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); }

__device__ __forceinline__ float comp(float3 v, int k) { return k == 0 ? v.x : (k == 1 ? v.y : v.z); }

__device__ __forceinline__ float inv_dir(float d) { return fabsf(d) > 1e-20f ? 1.f / d : BIG; }

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        int i) {
    Ray r;
    r.o = make_float3(o[3 * i + 0], o[3 * i + 1], o[3 * i + 2]);
    r.d = make_float3(d[3 * i + 0], d[3 * i + 1], d[3 * i + 2]);
    r.inv = make_float3(inv_dir(r.d.x), inv_dir(r.d.y), inv_dir(r.d.z));
    // kz = first axis of the largest |d| (argmax); swap kx, ky when d[kz] < 0.
    const float3 ad = make_float3(fabsf(r.d.x), fabsf(r.d.y), fabsf(r.d.z));
    int kz = 0;
    if (ad.y > comp(ad, kz)) kz = 1;
    if (ad.z > comp(ad, kz)) kz = 2;
    int kx = (kz + 1) % 3, ky = (kx + 1) % 3;
    const float dz = comp(r.d, kz);
    if (dz < 0.f) {
        const int tmp = kx;
        kx = ky;
        ky = tmp;
    }
    r.kx = kx;
    r.ky = ky;
    r.kz = kz;
    r.sz = 1.f / dz;
    r.sx = comp(r.d, kx) * r.sz;
    r.sy = comp(r.d, ky) * r.sz;
    return r;
}

__device__ __forceinline__ void two_prod(float a, float b, float& p, float& err) {
    p = __fmul_rn(a, b);
    const float ac = __fmul_rn(a, 4097.f);
    const float ah = __fsub_rn(ac, __fsub_rn(ac, a));
    const float al = __fsub_rn(a, ah);
    const float bc = __fmul_rn(b, 4097.f);
    const float bh = __fsub_rn(bc, __fsub_rn(bc, b));
    const float bl = __fsub_rn(b, bh);
    err = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p), __fmul_rn(ah, bl)),
                              __fmul_rn(al, bh)),
                    __fmul_rn(al, bl));
}

__device__ __forceinline__ float diff_of_products(float a, float b, float c, float d) {
    float p1, e1, p2, e2;
    two_prod(a, b, p1, e1);
    two_prod(c, d, p2, e2);
    return (p1 - p2) + (e1 - e2);
}

__device__ __forceinline__ void shear(const Ray& r, float4 p, float& px, float& py, float& pz) {
    const float3 rel = make_float3(p.x - r.o.x, p.y - r.o.y, p.z - r.o.z);
    pz = comp(rel, r.kz);
    px = comp(rel, r.kx) - r.sx * pz;
    py = comp(rel, r.ky) - r.sy * pz;
}

// Watertight test of the triangle rows a, b, c (v0, v1, v2); true with
// (t, u, v) when it is hit strictly inside (tmin, tmax).
__device__ __forceinline__ bool watertight(const Ray& r, float4 va, float4 vb, float4 vc,
                                           float tmin, float tmax, float& t, float& u, float& v) {
    float ax, ay, az, bx, by, bz, cx, cy, cz;
    shear(r, va, ax, ay, az);
    shear(r, vb, bx, by, bz);
    shear(r, vc, cx, cy, cz);
    float ue = cx * by - cy * bx;
    float ve = ax * cy - ay * cx;
    float we = bx * ay - by * ax;
    const float eps = 1.1e-19f;
    if (fabsf(ue) < eps || fabsf(ve) < eps || fabsf(we) < eps) {
        ue = diff_of_products(cx, by, cy, bx);
        ve = diff_of_products(ax, cy, ay, cx);
        we = diff_of_products(bx, ay, by, ax);
    }
    const bool mixed = (ue < 0.f || ve < 0.f || we < 0.f) && (ue > 0.f || ve > 0.f || we > 0.f);
    const float det = ue + ve + we;
    const float tn = ue * (r.sz * az) + ve * (r.sz * bz) + we * (r.sz * cz);
    const float ds = sgn(det);
    const bool in_range = tn * ds > tmin * det * ds && tn * ds < tmax * det * ds;
    const float inv_det = 1.f / (det == 0.f ? 1.f : det);
    t = tn * inv_det;
    u = ve * inv_det;
    v = we * inv_det;
    return !mixed && det != 0.f && in_range;
}

// A thread's stack of (link, entry distance) pairs: entries below SHORT in
// shared memory at sh[k * BLOCK], the rest in the spill rows at
// spill[(k - SHORT) * stride] (stride = the grid's threads).
struct Stack {
    int2* sh;
    int2* spill;
    int stride;
    int sp;

    __device__ __forceinline__ void put(int k, int link, float t) const {
        const int2 e = make_int2(link, __float_as_int(t));
        if (k < SHORT)
            sh[k * BLOCK] = e;
        else
            spill[(k - SHORT) * stride] = e;
    }

    __device__ __forceinline__ int2 get(int k) const {
        return k < SHORT ? sh[k * BLOCK] : spill[(k - SHORT) * stride];
    }

    // The topmost entry nearer than `bound` into cur, the entries above it
    // dropped; false when none is left.
    __device__ __forceinline__ bool pop(float bound, int& cur) {
        while (sp > 0) {
            --sp;
            const int2 e = get(sp);
            if (__int_as_float(e.y) < bound) {
                cur = e.x;
                return true;
            }
        }
        return false;
    }
};

// Slab test of one child box; true with its entry distance.
__device__ __forceinline__ bool slab(const Ray& r, float mnx, float mny, float mnz, float mxx,
                                     float mxy, float mxz, float tmin, float bound, float& near) {
    const float t0x = (mnx - r.o.x) * r.inv.x, t1x = (mxx - r.o.x) * r.inv.x;
    const float t0y = (mny - r.o.y) * r.inv.y, t1y = (mxy - r.o.y) * r.inv.y;
    const float t0z = (mnz - r.o.z) * r.inv.z, t1z = (mxz - r.o.z) * r.inv.z;
    near = fmaxf(fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z)), tmin);
    const float far = fminf(fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)), bound);
    return near <= far;
}

// Visit node `node`: slab-test both children against (tmin, bound), push the
// second of two hit children and return the first one's link (EMPTY when
// neither is hit). The closest-hit walk (ANY false) takes the nearer first,
// child 0 on a tie; the any-hit walk child 0 first.
template <bool ANY>
__device__ __forceinline__ int visit(const Ray& r, const float4* __restrict__ nodes, int node,
                                     float tmin, float bound, Stack& stk) {
    const float4 a = __ldg(nodes + 4 * node + 0), b = __ldg(nodes + 4 * node + 1);
    const float4 c = __ldg(nodes + 4 * node + 2), e = __ldg(nodes + 4 * node + 3);
    const int l0 = __float_as_int(e.x), l1 = __float_as_int(e.y);
    float n0, n1;
    const bool h0 = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, tmin, bound, n0) && l0 != EMPTY;
    const bool h1 = slab(r, b.z, b.w, c.x, c.y, c.z, c.w, tmin, bound, n1) && l1 != EMPTY;
    if (!(h0 || h1)) return EMPTY;
    const bool first1 = h1 && (!h0 || (!ANY && n1 < n0));
    if (h0 && h1) {
        stk.put(stk.sp, first1 ? l0 : l1, first1 ? n0 : n1);
        ++stk.sp;
    }
    return first1 ? l1 : l0;
}

// The state of one thread's walk; ray < 0 when the thread has no ray.
struct Walk {
    Ray r;
    int ray, cur;
    float tmin, tmax, best_t, best_u, best_v;
    int best_prim;
    bool occluded;
};

template <bool ANY>
__device__ __forceinline__ void write_out(int i, const Walk& w, float* __restrict__ t_out,
                                          int* __restrict__ prim_out, float* __restrict__ u_out,
                                          float* __restrict__ v_out, bool* __restrict__ occ_out) {
    if constexpr (ANY) {
        occ_out[i] = w.occluded;
    } else {
        t_out[i] = w.best_t;
        prim_out[i] = w.best_prim;
        u_out[i] = w.best_u;
        v_out[i] = w.best_v;
    }
}

// The leaf with code `code` (-1 - link = first row * 16 + count) against
// (tmin, bound); ANY: true at the first hit; else the nearest strict
// improvement in row order into w.best_*, false.
template <bool ANY>
__device__ __forceinline__ bool test_leaf(Walk& w, const float4* __restrict__ tris, int code,
                                          float bound) {
    const int start = code >> 4, count = code & 15;
    for (int k = 0; k < count; ++k) {
        const float4* tri = tris + 3 * (start + k);
        const float4 a = __ldg(tri + 0), b = __ldg(tri + 1), c = __ldg(tri + 2);
        float t, u, v;
        if (watertight(w.r, a, b, c, w.tmin, bound, t, u, v)) {
            if (ANY) return true;
            if (t < w.best_t) {
                w.best_t = t;
                w.best_prim = __float_as_int(a.w);
                w.best_u = u;
                w.best_v = v;
            }
        }
    }
    return false;
}

// The persistent walk of K5 (ANY = false) and K6 (ANY = true) over lanes
// [0, n): see the note at the top. *counter must be 0 at the launch; spill
// holds (tree depth - SHORT) rows of gridDim.x * BLOCK entries, or is unused.
template <bool ANY>
__device__ __forceinline__ void walk_lanes(const float* __restrict__ o, const float* __restrict__ d,
                                           const float* __restrict__ tmin,
                                           const float* __restrict__ tmax, int n,
                                           const float4* __restrict__ nodes,
                                           const float4* __restrict__ tris, int* counter,
                                           int2* spill, float* __restrict__ t_out,
                                           int* __restrict__ prim_out, float* __restrict__ u_out,
                                           float* __restrict__ v_out, bool* __restrict__ occ_out) {
    __shared__ int2 stack_sh[SHORT * BLOCK];
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    Stack stk{stack_sh + threadIdx.x, spill + blockIdx.x * BLOCK + threadIdx.x,
              static_cast<int>(gridDim.x) * BLOCK, 0};
    Walk w;
    w.ray = -1;
    unsigned queue = 0;   // live lanes of the warp's chunk not yet taken (warp-uniform)
    int chunk = 0;        // the chunk's first lane
    bool drained = false; // the counter has passed n
    while (true) {
        // Hand queued live lanes to the threads without a ray, fetching
        // chunks of 32 lanes while some are idle and lanes are left.
        unsigned idle = __ballot_sync(FULL, w.ray < 0);
        while (idle != 0) {
            if (queue == 0) {
                if (drained) break;
                int base = 0;
                if (lane == 0) base = atomicAdd(counter, 32);
                base = __shfl_sync(FULL, base, 0);
                if (base >= n) {
                    drained = true;
                    break;
                }
                const int i = base + lane;
                bool live = false;
                if (i < n) {
                    live = tmax[i] > tmin[i];
                    if (!live) {
                        Walk dead;
                        dead.best_t = BIG;
                        dead.best_prim = -1;
                        dead.best_u = dead.best_v = 0.f;
                        dead.occluded = false;
                        write_out<ANY>(i, dead, t_out, prim_out, u_out, v_out, occ_out);
                    }
                }
                queue = __ballot_sync(FULL, live);
                chunk = base;
                continue;
            }
            const int take = min(__popc(queue), __popc(idle));
            const int r = __popc(idle & below);
            if (((idle >> lane) & 1u) && r < take) {
                const int i = chunk + static_cast<int>(__fns(queue, 0, r + 1));
                w.ray = i;
                w.r = load_ray(o, d, i);
                w.tmin = tmin[i];
                w.tmax = tmax[i];
                w.cur = 0;   // the root
                w.best_t = BIG;
                w.best_prim = -1;
                w.best_u = w.best_v = 0.f;
                w.occluded = false;
                stk.sp = 0;
            }
            for (int k = 0; k < take; ++k) {
                queue &= queue - 1u;
                idle &= idle - 1u;
            }
        }
        if (__all_sync(FULL, w.ray < 0)) return;   // drained, and every ray done
        if (w.ray < 0) continue;
        bool done = false;
        // inner nodes until a leaf, or the end of the walk
        while (w.cur >= 0) {
            const int next = visit<ANY>(w.r, nodes, w.cur, w.tmin, fminf(w.tmax, w.best_t), stk);
            if (next != EMPTY) {
                w.cur = next;
            } else if (!stk.pop(fminf(w.tmax, w.best_t), w.cur)) {
                done = true;
                break;
            }
        }
        // one leaf, then the next entry of the stack
        if (!done) {
            if (test_leaf<ANY>(w, tris, -1 - w.cur, fminf(w.tmax, w.best_t))) {
                w.occluded = true;
                done = true;
            } else if (!stk.pop(fminf(w.tmax, w.best_t), w.cur)) {
                done = true;
            }
        }
        if (done) {
            write_out<ANY>(w.ray, w, t_out, prim_out, u_out, v_out, occ_out);
            w.ray = -1;
        }
    }
}

}  // namespace wpt_bvh
