// Shared traversal of the BVH kernels K5 (bvh_closest.cu) and K6 (bvh_any.cu).
//
// Replaces the wide-BVH lockstep walk of wurblpt_tpu/accel/traverse.py
// (_wide_closest_hit / _wide_any_hit with _wide_walk_to_leaf,
// _wide_children, _stack_push_sorted, _stack_pop, _packed_leaf_tests) and
// intersect.watertight_tri. The TPU walked all rays in lockstep over W=32
// wide rows, kept each ray's stack as one-hot masked [N, D] arrays and
// re-packed the live lanes into ever smaller batches, because its gathers
// are priced per row and its lanes cannot diverge. Here one thread owns one
// ray and walks a binary tree with a stack in local memory: a lane that
// finishes early simply retires.
//
// Bound on the card: dependent loads. Each step reads one 64-byte node row
// (both children's boxes and links, four float4 loads through the read-only
// path) and branches on it; a leaf reads 36 bytes per triangle. The 102k-
// triangle tree (~3 MB of nodes, ~3.7 MB of leaf triangles) stays in the 50 MB
// L2, so the walk is latency-bound, not bandwidth-bound; neighbouring camera
// rays take similar paths, which keeps warps coherent at bounce 0.
//
// Every expression is evaluated in the order of the plain PyTorch version
// (wurblpt_tpu_torch/accel/traverse.py, render/intersect.py watertight_tri)
// and the library is built with -fmad=false, so kernel and plain version
// take the same decisions and return the same bits. The Dekker split of
// two_prod uses the _rn intrinsics, which are never contracted into an FMA.
//
// Node row (accel/build.py): [child 0 min xyz, max xyz, child 1 min xyz,
// max xyz, link 0, link 1 (int32 bits), pad, pad]. A link >= 0 is an inner
// node, -1 an empty child, any other negative value a leaf holding triangles
// [start, start + count) of tri_v with -1 - link = start * 16 + count.
#pragma once

#include <cuda_runtime.h>

namespace wpt_bvh {

constexpr float BIG = 3.0e37f;
constexpr int BLOCK = 128;   // rays per block, one thread each
constexpr int STACK = 64;    // STACK_DEPTH in accel/build.py: the build refuses deeper trees
constexpr int EMPTY = -1;

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

__device__ __forceinline__ void shear(const Ray& r, const float* __restrict__ p, float& px,
                                      float& py, float& pz) {
    const float3 rel = make_float3(__ldg(p + 0) - r.o.x, __ldg(p + 1) - r.o.y, __ldg(p + 2) - r.o.z);
    pz = comp(rel, r.kz);
    px = comp(rel, r.kx) - r.sx * pz;
    py = comp(rel, r.ky) - r.sy * pz;
}

// Watertight test of the triangle at tri (9 floats: v0, v1, v2); true with
// (t, u, v) when it is hit strictly inside (tmin, tmax).
__device__ __forceinline__ bool watertight(const Ray& r, const float* __restrict__ tri, float tmin,
                                           float tmax, float& t, float& u, float& v) {
    float ax, ay, az, bx, by, bz, cx, cy, cz;
    shear(r, tri + 0, ax, ay, az);
    shear(r, tri + 3, bx, by, bz);
    shear(r, tri + 6, cx, cy, cz);
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

// Slab test of one child box (6 floats); true with its entry distance.
__device__ __forceinline__ bool slab(const Ray& r, float mnx, float mny, float mnz, float mxx,
                                     float mxy, float mxz, float tmin, float bound, float& near) {
    const float t0x = (mnx - r.o.x) * r.inv.x, t1x = (mxx - r.o.x) * r.inv.x;
    const float t0y = (mny - r.o.y) * r.inv.y, t1y = (mxy - r.o.y) * r.inv.y;
    const float t0z = (mnz - r.o.z) * r.inv.z, t1z = (mxz - r.o.z) * r.inv.z;
    near = fmaxf(fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z)), tmin);
    const float far = fminf(fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z)), bound);
    return near <= far;
}

// The walk shared by K5 (ANY = false: nearest hit into best_*) and K6
// (ANY = true: returns true at the first hit). The caller has checked
// tmax > tmin.
template <bool ANY>
__device__ __forceinline__ bool traverse(const Ray& r, const float4* __restrict__ nodes,
                                         const float* __restrict__ tri_v,
                                         const int* __restrict__ tri_id, float tmin, float tmax,
                                         float& best_t, int& best_prim, float& best_u,
                                         float& best_v) {
    int stack_l[STACK];
    float stack_t[STACK];
    int sp = 0;
    int cur = 0;   // the root
    while (true) {
        const float bound = fminf(tmax, best_t);
        bool pop = false;
        if (cur >= 0) {
            const float4 a = __ldg(nodes + 4 * cur + 0), b = __ldg(nodes + 4 * cur + 1);
            const float4 c = __ldg(nodes + 4 * cur + 2), e = __ldg(nodes + 4 * cur + 3);
            const int l0 = __float_as_int(e.x), l1 = __float_as_int(e.y);
            float n0, n1;
            const bool h0 = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, tmin, bound, n0) && l0 != EMPTY;
            const bool h1 = slab(r, b.z, b.w, c.x, c.y, c.z, c.w, tmin, bound, n1) && l1 != EMPTY;
            if (h0 || h1) {
                const bool first1 = h1 && (!h0 || n1 < n0);
                if (h0 && h1) {
                    stack_l[sp] = first1 ? l0 : l1;
                    stack_t[sp] = first1 ? n0 : n1;
                    ++sp;
                }
                cur = first1 ? l1 : l0;
            } else {
                pop = true;
            }
        }
        if (!pop && cur <= -2) {
            const int code = -1 - cur;
            const int start = code >> 4, count = code & 15;
            for (int k = 0; k < count; ++k) {
                float t, u, v;
                if (watertight(r, tri_v + 9 * (start + k), tmin, bound, t, u, v)) {
                    if (ANY) return true;
                    if (t < best_t) {
                        best_t = t;
                        best_prim = __ldg(tri_id + start + k);
                        best_u = u;
                        best_v = v;
                    }
                }
            }
            pop = true;
        }
        if (pop) {
            const float pb = fminf(tmax, best_t);
            bool found = false;
            while (sp > 0) {
                --sp;
                if (stack_t[sp] < pb) {
                    cur = stack_l[sp];
                    found = true;
                    break;
                }
            }
            if (!found) return false;
        }
    }
}

}  // namespace wpt_bvh
