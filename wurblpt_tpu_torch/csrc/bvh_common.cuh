// Shared walk of the BVH kernels K5 (bvh_closest.cu) and K6 (bvh_any.cu).
//
// Replaces the wide-BVH lockstep walk of wurblpt_tpu/accel/traverse.py
// (_wide_closest_hit / _wide_any_hit with _wide_walk_to_leaf,
// _wide_children, _stack_push_sorted, _stack_pop, and the leaf branches
// _packed_leaf_tests, triangle and sphere, and _packed_leaf_rays) and
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
//    as the SMs hold). Each warp first takes its own chunk of 32 lanes
//    (lanes [32 w, 32 w + 32) for the launch's warp w), and past the
//    launch's first wave further chunks from a counter (atomicAdd) that the
//    wrapper zeroes with a memset; a launch whose lanes fit one wave reads
//    and writes no counter. A warp writes the outputs of its dead lanes at
//    once and queues the live ones (__ballot_sync); a thread whose ray has
//    finished takes the next queued lane, so a warp stays full while live
//    rays remain (Aila and Laine's persistent while-while walk: inner nodes
//    until a leaf, then the leaf).
// 2. A stack in local memory. 512 B per thread overflowed L1 at full
//    occupancy. Here a thread's stack lives in shared memory (entry k at
//    [k][threadIdx]: no bank conflict): on the L2 walk its first SHORT
//    entries, and only a walk deeper than that spills to rows of device
//    memory that the wrapper sizes from the tree's depth (the build refuses
//    a tree past STACK_DEPTH); on the staged walk as many entries as the
//    tree is deep. No per-thread array is indexed at run time.
// A leaf primitive is one 48-byte row (16-byte loads, the prim id in v0's
// pad) instead of nine scalar loads. A compressed 8-wide tree (Ylitie
// et al. 2017) was measured in place of the binary one and walked slower:
// its decode and ordering of 8 children cost more instruction slots than the
// dependent loads it saves while the tables sit in L2 (PERF.md).
//
// Small trees (the RTIOW field's 488 spheres, the animated box's 38 rows) are
// walked from shared memory (STAGED): where the node table, the leaf rows
// (32 bytes of a sphere-only tree's rows, all 48 of a tree with triangles),
// the animations' inverse frames (at the frame's one instant; per-ray
// rows, under motion blur, stay in device memory), the stack at the tree's
// depth and the object-ray cache fit the bytes a block may take without costing the SM a
// resident block (`stage_budget`), each block copies the tables once and
// its walks read no node or row from L2. The wrapper picks the branch from
// the tree's size; a larger tree (the mesh and city frames') takes the L2
// walk.
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
// (render/intersect.py watertight_tri for a triangle row; sweep_common.cuh's
// sphere_test for a sphere row, in the BVH's rounding: the fused
// multiply-adds with which XLA evaluates the JAX package's leaf test, whose
// last bits decide self-intersections on the RTIOW ground sphere; its
// object_ray for the ray in an animation's space) and the library is built
// with -fmad=false, so kernel and plain version round alike. The Dekker split of two_prod
// uses the _rn intrinsics, which are never contracted. The quotients of both
// tests (a sphere's square root and two divisions, a triangle's 1/det, t, u
// and v) are taken only after the exact tests that need none of them have
// passed: the plain version computes them on every row, but reads them only
// on a hit, so the bits are the same.
//
// Leaf kinds, as template parameters of the walk: SPHERES, a tree with
// sphere rows (a row whose prim id is >= n_tris is a sphere: the global
// order, triangles first); ANIMATED, object-space rays: each row is tested
// with the ray moved into its animation's object space by that animation's
// frame row, while the slab tests stay on the world ray against the boxes
// swept over the frame's interval. The rows are the animations' at the
// frame's one instant (a lane stride of 0), or each lane's own at its ray's
// instant (motion blur: a lane stride of A FRAME floats, read from device
// memory; the cache below is reset with each ray a thread takes, so a slot
// never holds another lane's object ray). Row 0 is the identity (static
// primitives): its rows are tested with the world ray moved through the
// identity's own arithmetic (`identity`: 1 x + 0 y + 0 z, no load, no
// division), which is the plain version's product with row 0 bit for bit,
// signed zeros included. Every other animation's object ray, with its
// watertight permutation and shear, is computed at most once per ray and
// kept in a per-thread cache in shared memory (SLOTS_MAX slots, direct
// mapped by animation id), so rows that alternate between the identity and
// moving primitives do not recompute it. <false, false> is the static
// triangle walk of the bench paths.
//
// Node row (accel/build.py): [child 0 min xyz, max xyz, child 1 min xyz,
// max xyz, link 0, link 1 (int32 bits), pad, pad]. A link >= 0 is an inner
// node, -1 an empty child, any other negative value a leaf holding rows
// [start, start + count) of the leaf table with -1 - link = start * 16 +
// count. Leaf row: a triangle's [v0 xyz, prim id | v1 xyz, animation id |
// v2 xyz, 0], a sphere's [centre xyz, prim id | radius, 0, 0, animation id |
// 0 x 4], the ids as int32 bits.
#pragma once

#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace wpt_bvh {

constexpr float BIG = 3.0e37f;
constexpr int BLOCK = 128;        // threads per block
constexpr int MIN_BLOCKS = 4;     // resident blocks per SM the registers must allow
constexpr int SHORT = 16;         // stack entries per thread in shared memory on the L2 walk (SHARED_STACK)
constexpr int SLOTS_MAX = 8;      // object-ray cache slots per thread at most
constexpr int SLOT_WORDS = 8;     // a slot: o xyz, d xyz, the shear's 1/d[kz], the animation id
constexpr int STAGED_FRAME = 12;  // floats of an animation's staged frame: r_inv, t_inv
constexpr int EMPTY = -1;         // link of an empty child
constexpr unsigned FULL = 0xffffffffu;

// A block's dynamic shared memory, in bytes from its start (the wrapper's
// traverse.layout_bytes mirrors it): the stack at the tree's depth (STAGED); the
// object-ray cache, `slots` words-major slots per thread, and each thread's
// world o and d (ANIMATED); the node table, the leaf rows at `row_stride`
// float4s and, at one instant (not `per_ray`), the animations' first
// STAGED_FRAME floats (STAGED). The L2 walk keeps its SHORT stack entries
// in static shared memory.
struct Layout {
    int slots, row_stride;
    int cache, world, nodes, rows, frames, bytes;
};

__host__ __device__ inline Layout layout(bool staged, bool animated, int n_nodes, int n_rows,
                                         int n_tris, int n_anims, int depth,
                                         bool per_ray = false) {
    Layout l;
    int at = staged ? depth * BLOCK * 8 : 0;
    const int want = n_anims - 1 < 1 ? 1 : (n_anims - 1 > SLOTS_MAX ? SLOTS_MAX : n_anims - 1);
    l.slots = 1;
    while (l.slots < want) l.slots *= 2;
    if (!animated) l.slots = 0;
    l.cache = at;
    at += l.slots * SLOT_WORDS * BLOCK * 4;
    l.world = at;
    at += animated ? 6 * BLOCK * 4 : 0;
    l.row_stride = staged && n_tris == 0 ? 2 : 3;
    l.nodes = at;
    at += staged ? n_nodes * 64 : 0;
    l.rows = at;
    at += staged ? n_rows * l.row_stride * 16 : 0;
    l.frames = at;
    at += staged && animated && !per_ray ? n_anims * STAGED_FRAME * 4 : 0;
    l.bytes = at;
    return l;
}

// The rays of a launch, its tree and its outputs.
struct Rays {
    const float* __restrict__ o;
    const float* __restrict__ d;
    const float* __restrict__ tmin;
    const float* __restrict__ tmax;
    int n;
};

struct Tree {
    const float4* __restrict__ nodes;
    const float4* __restrict__ rows;
    const float* __restrict__ frames;   // the animations' rows (ANIMATED), or unused
    int n_nodes, n_rows, n_tris, n_anims, depth;
    long long lane_stride;              // floats of frame rows per lane: 0, or A FRAME per ray
};

struct Out {
    float* __restrict__ t;
    int* __restrict__ prim;
    float* __restrict__ u;
    float* __restrict__ v;
    bool* __restrict__ occ;
};

struct Ray {
    float3 o, d, inv;
    int kx, ky, kz;          // watertight axis permutation
    float sx, sy, sz;        // watertight shear
};

__device__ __forceinline__ float sgn(float x) { return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f); }

__device__ __forceinline__ float comp(float3 v, int k) { return k == 0 ? v.x : (k == 1 ? v.y : v.z); }

__device__ __forceinline__ float inv_dir(float d) { return fabsf(d) > 1e-20f ? 1.f / d : BIG; }

// The watertight permutation of r.d, and its shear with sz = 1 / d[kz].
__device__ __forceinline__ void shear_with(Ray& r, float sz) {
    // kz = first axis of the largest |d| (argmax); swap kx, ky when d[kz] < 0.
    const float3 ad = make_float3(fabsf(r.d.x), fabsf(r.d.y), fabsf(r.d.z));
    int kz = 0;
    if (ad.y > comp(ad, kz)) kz = 1;
    if (ad.z > comp(ad, kz)) kz = 2;
    int kx = (kz + 1) % 3, ky = (kx + 1) % 3;
    if (comp(r.d, kz) < 0.f) {
        const int tmp = kx;
        kx = ky;
        ky = tmp;
    }
    r.kx = kx;
    r.ky = ky;
    r.kz = kz;
    r.sz = sz;
    r.sx = comp(r.d, kx) * sz;
    r.sy = comp(r.d, ky) * sz;
}

// The watertight permutation and shear of r.d.
__device__ __forceinline__ void set_shear(Ray& r) {
    const float ax = fabsf(r.d.x), ay = fabsf(r.d.y), az = fabsf(r.d.z);
    const int kz = az > (ay > ax ? ay : ax) ? 2 : (ay > ax ? 1 : 0);
    shear_with(r, 1.f / comp(r.d, kz));
}

// v times the identity, each row summed left to right as object_ray's
// matvec: v where v is not zero, and the product's signed zero where it is.
__device__ __forceinline__ float3 identity(float3 v) {
    return make_float3(1.f * v.x + 0.f * v.y + 0.f * v.z, 0.f * v.x + 1.f * v.y + 0.f * v.z,
                       0.f * v.x + 0.f * v.y + 1.f * v.z);
}

__device__ __forceinline__ wpt_sweep::V3 v3(float3 v) { return {v.x, v.y, v.z}; }

__device__ __forceinline__ float3 f3(wpt_sweep::V3 v) { return make_float3(v.x, v.y, v.z); }

// A table row: from shared memory on the staged walk, else through the
// read-only cache.
template <bool STAGED>
__device__ __forceinline__ float4 ld4(const float4* p) {
    if constexpr (STAGED)
        return *p;
    else
        return __ldg(p);
}

// The object rays of one thread, a slot per animation id ((id - 1) & mask):
// o, d, 1/d[kz] and the id at word k of slot s at [s][k][threadIdx]; the
// world o and d beside them.
struct Cache {
    float* slot;    // this thread's word 0 of slot 0
    float* world;   // this thread's world o.x
    int mask;

    __device__ __forceinline__ void reset(float3 o, float3 d) const {
        world[0] = o.x;
        world[BLOCK] = o.y;
        world[2 * BLOCK] = o.z;
        world[3 * BLOCK] = d.x;
        world[4 * BLOCK] = d.y;
        world[5 * BLOCK] = d.z;
        for (int s = 0; s <= mask; ++s) slot[(s * SLOT_WORDS + 7) * BLOCK] = 0.f;   // id 0: empty
    }

    // r = the ray in animation `id`'s object space (id > 0), computed from
    // its frame row f once per ray.
    __device__ __forceinline__ void load(int id, const float* __restrict__ f, Ray& r) const {
        float* e = slot + ((id - 1) & mask) * SLOT_WORDS * BLOCK;
        if (__float_as_int(e[7 * BLOCK]) == id) {
            r.o = make_float3(e[0], e[BLOCK], e[2 * BLOCK]);
            r.d = make_float3(e[3 * BLOCK], e[4 * BLOCK], e[5 * BLOCK]);
            shear_with(r, e[6 * BLOCK]);
            return;
        }
        wpt_sweep::V3 oa, da;
        wpt_sweep::object_ray(f, {world[0], world[BLOCK], world[2 * BLOCK]},
                              {world[3 * BLOCK], world[4 * BLOCK], world[5 * BLOCK]}, oa, da);
        r.o = f3(oa);
        r.d = f3(da);
        set_shear(r);
        e[0] = r.o.x;
        e[BLOCK] = r.o.y;
        e[2 * BLOCK] = r.o.z;
        e[3 * BLOCK] = r.d.x;
        e[4 * BLOCK] = r.d.y;
        e[5 * BLOCK] = r.d.z;
        e[6 * BLOCK] = r.sz;
        e[7 * BLOCK] = __int_as_float(id);
    }
};

// The ray a thread tests its leaf rows with: the world ray, or (ANIMATED)
// the ray in the row's animation space, kept for the next rows of the same
// animation: the walk's identity ray for animation 0, else the cache's.
template <bool ANIMATED>
struct LeafRay {
    __device__ __forceinline__ void reset() {}
    __device__ __forceinline__ const Ray& get(const Ray& world, const Cache&,
                                              const float* __restrict__, int) {
        return world;
    }
};

template <>
struct LeafRay<true> {
    Ray obj;   // o, d, the permutation and shear; inv is not read
    int aid;   // animation id of obj (-1: none yet)

    __device__ __forceinline__ void reset() { aid = -1; }
    __device__ __forceinline__ const Ray& get(const Ray& identity, const Cache& cache,
                                              const float* __restrict__ f, int id) {
        if (id != aid) {
            if (id == 0) {
                obj.o = identity.o;
                obj.d = identity.d;
                obj.kx = identity.kx;
                obj.ky = identity.ky;
                obj.kz = identity.kz;
                obj.sx = identity.sx;
                obj.sy = identity.sy;
                obj.sz = identity.sz;
            } else {
                cache.load(id, f, obj);
            }
            aid = id;
        }
        return obj;
    }
};

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
// (t, u, v) when it is hit strictly inside (tmin, tmax). The range test
// compares t's numerator with the bounds times det, so 1/det, t, u and v are
// taken only for a hit.
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
    if (mixed || det == 0.f || !in_range) return false;
    const float inv_det = 1.f / det;
    t = tn * inv_det;
    u = ve * inv_det;
    v = we * inv_det;
    return true;
}

// A thread's stack of (link, entry distance) pairs: entry k at sh[k * BLOCK]
// below SHORT (STAGED: every entry), the rest in the spill rows at
// spill[(k - SHORT) * stride] (stride = the grid's threads).
template <bool STAGED>
struct Stack {
    int2* sh;
    int2* spill;
    int stride;
    int sp;

    __device__ __forceinline__ void put(int k, int link, float t) const {
        const int2 e = make_int2(link, __float_as_int(t));
        if (STAGED || k < SHORT)
            sh[k * BLOCK] = e;
        else
            spill[(k - SHORT) * stride] = e;
    }

    __device__ __forceinline__ int2 get(int k) const {
        return STAGED || k < SHORT ? sh[k * BLOCK] : spill[(k - SHORT) * stride];
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
template <bool ANY, bool STAGED>
__device__ __forceinline__ int visit(const Ray& r, const float4* __restrict__ nodes, int node,
                                     float tmin, float bound, Stack<STAGED>& stk) {
    const float4 a = ld4<STAGED>(nodes + 4 * node + 0), b = ld4<STAGED>(nodes + 4 * node + 1);
    const float4 c = ld4<STAGED>(nodes + 4 * node + 2), e = ld4<STAGED>(nodes + 4 * node + 3);
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

// The state of one thread's walk; ray < 0 when the thread has no ray. With
// ANIMATED, r is the world ray moved by the identity (the slab tests'
// decisions do not see its signed zeros, and row 0's leaf tests need them).
template <bool ANIMATED>
struct Walk {
    Ray r;
    LeafRay<ANIMATED> leaf;
    int ray, cur;
    float tmin, tmax, best_t, best_u, best_v;
    int best_prim;
    bool occluded;
};

template <bool ANY, class W>
__device__ __forceinline__ void write_out(int i, const W& w, const Out& out) {
    if constexpr (ANY) {
        out.occ[i] = w.occluded;
    } else {
        out.t[i] = w.best_t;
        out.prim[i] = w.best_prim;
        out.u[i] = w.best_u;
        out.v[i] = w.best_v;
    }
}

// One leaf row against (w.tmin, bound) with ray r; ANY: true at a hit; else
// a strict improvement into w.best_* (u = v = 0 for a sphere), false.
template <bool ANY, bool SPHERES, bool STAGED, class W>
__device__ __forceinline__ bool test_row(W& w, const Ray& r, const float4* row, float4 a,
                                         float4 b, float bound, int n_tris) {
    float t, u, v;
    bool hit;
    if (SPHERES && __float_as_int(a.w) >= n_tris) {
        hit = wpt_sweep::sphere_test<true>(v3(r.o), v3(r.d), make_float4(a.x, a.y, a.z, b.x),
                                           w.tmin, bound, t);
        u = v = 0.f;
    } else {
        hit = watertight(r, a, b, ld4<STAGED>(row + 2), w.tmin, bound, t, u, v);
    }
    if (!hit) return false;
    if (ANY) return true;
    if (t < w.best_t) {
        w.best_t = t;
        w.best_prim = __float_as_int(a.w);
        w.best_u = u;
        w.best_v = v;
    }
    return false;
}

// The leaf with code `code` (-1 - link = first row * 16 + count) against
// (tmin, bound), its rows `stride` float4s apart; ANY: true at the first
// hit; else the nearest strict improvement in row order into w.best_*,
// false.
template <bool ANY, bool SPHERES, bool ANIMATED, bool STAGED>
__device__ __forceinline__ bool test_leaf(Walk<ANIMATED>& w, const float4* __restrict__ rows,
                                          int stride, int code, float bound, int n_tris,
                                          const float* __restrict__ frames, int frame_stride,
                                          const Cache& cache) {
    const int start = code >> 4, count = code & 15;
    for (int k = 0; k < count; ++k) {
        const float4* row = rows + stride * (start + k);
        const float4 a = ld4<STAGED>(row + 0), b = ld4<STAGED>(row + 1);
        const int id = __float_as_int(b.w);
        const Ray& r = w.leaf.get(w.r, cache, frames + id * frame_stride, id);
        if (test_row<ANY, SPHERES, STAGED>(w, r, row, a, b, bound, n_tris)) return true;
    }
    return false;
}

// The dynamic shared memory of a launch (its size: Layout::bytes). The
// tests' host build replaces this line with a static array.
extern __shared__ float4 wpt_bvh_smem[];

// The persistent walk of K5 (ANY = false) and K6 (ANY = true) over lanes
// [0, n): see the note at the top. *counter must be 0 at the launch when n
// exceeds the launch's threads (else it is not read); spill holds (tree
// depth - SHORT) rows of gridDim.x * BLOCK entries on the L2 walk, or is
// unused; the block's dynamic shared memory is `layout`'s bytes.
template <bool ANY, bool SPHERES, bool ANIMATED, bool STAGED>
__device__ __forceinline__ void walk_lanes(const Rays& rays, const Tree& tree, int* counter,
                                           int2* spill, const Out& out) {
    char* dyn = reinterpret_cast<char*>(wpt_bvh_smem);
    const bool per_ray = tree.lane_stride > 0;
    const Layout lay = layout(STAGED, ANIMATED, tree.n_nodes, tree.n_rows, tree.n_tris,
                              tree.n_anims, tree.depth, per_ray);
    const float4* __restrict__ nodes = tree.nodes;
    const float4* __restrict__ rows = tree.rows;
    const float* __restrict__ frames = tree.frames;
    int2* stack_base;
    if constexpr (STAGED) {
        float4* s_nodes = reinterpret_cast<float4*>(dyn + lay.nodes);
        for (int i = threadIdx.x; i < 4 * tree.n_nodes; i += BLOCK) s_nodes[i] = __ldg(nodes + i);
        float4* s_rows = reinterpret_cast<float4*>(dyn + lay.rows);
        for (int i = threadIdx.x; i < lay.row_stride * tree.n_rows; i += BLOCK) {
            const int r = i / lay.row_stride;
            s_rows[i] = __ldg(rows + 3 * r + (i - r * lay.row_stride));
        }
        if (ANIMATED && !per_ray) {
            float* s_frames = reinterpret_cast<float*>(dyn + lay.frames);
            for (int i = threadIdx.x; i < STAGED_FRAME * tree.n_anims; i += BLOCK) {
                const int a = i / STAGED_FRAME;
                s_frames[i] = __ldg(frames + a * wpt_sweep::FRAME + (i - a * STAGED_FRAME));
            }
            frames = s_frames;
        }
        __syncthreads();
        nodes = s_nodes;
        rows = s_rows;
        stack_base = reinterpret_cast<int2*>(dyn);
    } else {
        __shared__ int2 stack_sh[SHORT * BLOCK];
        stack_base = stack_sh;
    }
    const int row_stride = STAGED ? lay.row_stride : 3;
    const int frame_stride = STAGED && !per_ray ? STAGED_FRAME : wpt_sweep::FRAME;
    const Cache cache{reinterpret_cast<float*>(dyn + lay.cache) + threadIdx.x,
                      reinterpret_cast<float*>(dyn + lay.world) + threadIdx.x, lay.slots - 1};
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    const int wave = static_cast<int>(gridDim.x) * BLOCK;   // lanes of the warps' own chunks
    Stack<STAGED> stk{stack_base + threadIdx.x, spill + blockIdx.x * BLOCK + threadIdx.x, wave, 0};
    Walk<ANIMATED> w;
    w.ray = -1;
    unsigned queue = 0;   // live lanes of the warp's chunk not yet taken (warp-uniform)
    int chunk = 0;        // the chunk's first lane
    int own = static_cast<int>(blockIdx.x) * BLOCK + static_cast<int>(threadIdx.x & ~31u);
    bool drained = false; // no lane is left to take
    while (true) {
        // Hand queued live lanes to the threads without a ray, fetching
        // chunks of 32 lanes while some are idle and lanes are left: the
        // warp's own chunk first, then (past one wave) the counter's.
        unsigned idle = __ballot_sync(FULL, w.ray < 0);
        while (idle != 0) {
            if (queue == 0) {
                if (drained) break;
                int base = own;
                if (own < 0) {
                    if (wave >= rays.n) {
                        drained = true;
                        break;
                    }
                    base = 0;
                    if (lane == 0) base = wave + atomicAdd(counter, 32);
                    base = __shfl_sync(FULL, base, 0);
                }
                own = -1;
                if (base >= rays.n) {
                    drained = true;
                    break;
                }
                const int i = base + lane;
                bool live = false;
                if (i < rays.n) {
                    live = rays.tmax[i] > rays.tmin[i];
                    if (!live) {
                        Walk<ANIMATED> dead;
                        dead.best_t = BIG;
                        dead.best_prim = -1;
                        dead.best_u = dead.best_v = 0.f;
                        dead.occluded = false;
                        write_out<ANY>(i, dead, out);
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
                const float3 o = make_float3(rays.o[3 * i + 0], rays.o[3 * i + 1], rays.o[3 * i + 2]);
                const float3 d = make_float3(rays.d[3 * i + 0], rays.d[3 * i + 1], rays.d[3 * i + 2]);
                w.ray = i;
                w.r.inv = make_float3(inv_dir(d.x), inv_dir(d.y), inv_dir(d.z));
                w.leaf.reset();
                if constexpr (ANIMATED) {
                    cache.reset(o, d);
                    w.r.o = identity(o);
                    w.r.d = identity(d);
                } else {
                    w.r.o = o;
                    w.r.d = d;
                }
                set_shear(w.r);
                w.tmin = rays.tmin[i];
                w.tmax = rays.tmax[i];
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
            const int next =
                visit<ANY, STAGED>(w.r, nodes, w.cur, w.tmin, fminf(w.tmax, w.best_t), stk);
            if (next != EMPTY) {
                w.cur = next;
            } else if (!stk.pop(fminf(w.tmax, w.best_t), w.cur)) {
                done = true;
                break;
            }
        }
        // one leaf, then the next entry of the stack
        if (!done) {
            if (test_leaf<ANY, SPHERES, ANIMATED, STAGED>(w, rows, row_stride, -1 - w.cur,
                                                          fminf(w.tmax, w.best_t), tree.n_tris,
                                                          frames + w.ray * tree.lane_stride,
                                                          frame_stride, cache)) {
                w.occluded = true;
                done = true;
            } else if (!stk.pop(fminf(w.tmax, w.best_t), w.cur)) {
                done = true;
            }
        }
        if (done) {
            write_out<ANY>(w.ray, w, out);
            w.ray = -1;
        }
    }
}

#ifdef __CUDACC__
// Host side of a launch, shared by K5's and K6's entry points.

// Resident blocks per SM of `kernel` with `smem` bytes of dynamic shared
// memory per block, which its launches may then take (beside the L2 walk's
// static stack, dynamic shared memory past 32 KB needs the attribute).
template <class K>
int blocks_per_sm(K kernel, int smem) {
    if (smem > 0) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, BLOCK, smem);
    return blocks > 0 ? blocks : 1;
}

// The most dynamic shared memory a block of the staged `kernel` may take
// and still let the SM hold as many blocks as its registers allow.
template <class K>
int stage_budget(K kernel) {
    int dev = 0, sm_bytes = 0, reserved = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    const int blocks = blocks_per_sm(kernel, 0);
    int budget = sm_bytes / blocks - reserved;
    budget = budget < optin ? budget : optin;
    while (budget > 0 && blocks_per_sm(kernel, budget) < blocks) budget -= 16;
    return budget;
}

// Threads of a full persistent launch of `kernel` with `smem` bytes.
template <class K>
int resident_threads(K kernel, int smem) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms * blocks_per_sm(kernel, smem) * BLOCK;
}
#endif

}  // namespace wpt_bvh
