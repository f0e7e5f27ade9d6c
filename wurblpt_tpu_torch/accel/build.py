"""BVH construction for the K5/K6 kernels (port of ``wurblpt_tpu/accel/build.py``:
`prim_aabbs` and the SAH build, and of ``wurblpt_tpu/scene/flatten.py``:
`_swept_aabbs` and `_host_eval_anim`).

The SAH build is the host builder of ``csrc/host/bvh_builder.cpp`` (binned
SAH, binary tree emitted in DFS pre-order with miss links; a copy of the JAX
package's, the same code), compiled with g++ and called through ctypes
(:func:`wurblpt_tpu_torch.native.load_bvh_builder`). It builds over the
scene's primitives in the global order, triangles then spheres (sphere j
has prim id T + j). Its tree is then packed into the port's own layout,
:class:`~wurblpt_tpu_torch.scene.ir.BVHArrays`: each node row holds the
boxes and links of its two children, so a ray reads one 64-byte row and
tests both; a leaf holds up to `LEAF_SIZE` primitives stored contiguously,
each an aligned 48-byte row of three float4 that a thread reads with
16-byte loads: a triangle's v0, v1, v2 (absolute), a sphere's centre and
radius, with the prim id and the animation id in pad words. The JAX
package's W=32 collapse, octant threading and float-encoded links are TPU
gather tricks and are not ported; a compressed 8-wide collapse (Ylitie et
al. 2017: 8-bit child boxes against a per-node origin and power-of-two
scales) was built and measured against this layout on the H100 and walked
slower under the kernels' bit-equality with their plain versions
(PERF.md), so the tree stays binary.

An animated primitive's row holds its object-space geometry, which the
walk tests with the ray in its animation's object space; its box in the
tree is the world box swept over the build interval [t0, t1], as the JAX
flattener sweeps it (`swept_aabbs`), so the slab tests stay on the world
ray.

The traversal pushes at most one entry per inner level, so a walk holds at
most `depth` stack entries; a tree with more inner nodes on one
root-to-leaf path than `STACK_DEPTH` is refused here, never truncated.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import native
from ..scene.ir import AnimTable, BVHArrays, Spheres, Triangles, anim_ids

LEAF_SIZE = 8        # primitives per leaf at most; a leaf code keeps the count in 4 bits
STACK_DEPTH = 64     # stack entries a walk may need at most (its depth): deeper trees are refused
ROW_WORDS = 12       # 48 bytes per leaf row
EMPTY = -1           # link of a missing child


def prim_aabbs(v0, v1, v2):
    """(min, max, centroid) [T, 3] f32 of each triangle.

    From the absolute vertices, so a box holds exactly the corners the
    watertight test reads (the JAX package boxes p0 + e1, p0 + e2)."""
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    return lo, hi, ((lo + hi) * np.float32(0.5)).astype(np.float32)


def sphere_aabbs(center, radius):
    """(min, max, centroid) [S, 3] f32 of each sphere: centre -+ radius."""
    r = radius[:, None]
    return ((center - r).astype(np.float32), (center + r).astype(np.float32),
            center.astype(np.float32))


def host_eval_anim(anims, aid: int, t: float):
    """Animation `aid` of the keyframe tables at time `t`, in float64 on the
    host: (R [3, 3] with the scale, translation [3]). `anims` holds the
    AnimTable's columns as numpy arrays; the same interpolation as the JAX
    flattener's `_host_eval_anim` (key search, lerp, slerp with its 0.9995
    cut, normalized quaternion)."""
    times, trans, rot, scale, nkeys = anims
    nk = int(nkeys[aid])
    key_t = times[aid, :nk].astype(np.float64)
    k = int(np.clip(np.searchsorted(key_t, t, side="right") - 1, 0, nk - 1))
    k1 = min(k + 1, nk - 1)
    t0k, t1k = key_t[k], key_t[k1]
    alpha = 0.0 if t1k <= t0k else float(np.clip((t - t0k) / (t1k - t0k), 0.0, 1.0))

    def key(table, j):
        return table[aid, j].astype(np.float64)

    tr = key(trans, k) * (1 - alpha) + key(trans, k1) * alpha
    s = key(scale, k) * (1 - alpha) + key(scale, k1) * alpha
    q0, q1 = key(rot, k), key(rot, k1)
    dotq = float(np.dot(q0, q1))
    if dotq < 0:
        q1, dotq = -q1, -dotq
    if dotq > 0.9995:
        q = q0 * (1 - alpha) + q1 * alpha
    else:
        th = np.arccos(np.clip(dotq, -1.0, 1.0))
        q = (np.sin((1 - alpha) * th) * q0 + np.sin(alpha * th) * q1) / np.sin(th)
    q = q / np.linalg.norm(q)
    x, y, z, w = q
    m = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return m * s[None, :], tr


def swept_aabbs(amin, amax, prim_anim, anims: AnimTable, t0: float, t1: float,
                n_samples: int = 16):
    """World boxes of the animated primitives over [t0, t1]: the union of
    each object box's 8 corners moved to 16 sampled instants of the interval
    and to every key time inside it, padded by 1 % of its extent + 1e-6 (the
    JAX flattener's `_swept_aabbs`, operation for operation). Static
    primitives (id 0) keep their boxes."""
    amin, amax = amin.copy(), amax.copy()
    tables = tuple(x.detach().cpu().numpy() for x in anims)
    for aid in np.unique(prim_anim):
        if aid == 0:
            continue
        times = set(np.linspace(t0, t1, n_samples).tolist())
        key_t = tables[0][aid, :int(tables[4][aid])].astype(np.float64)
        times.update(t for t in key_t if t0 <= t <= t1)
        sel = prim_anim == aid
        bmin, bmax = amin[sel], amax[sel]
        corners = np.stack([np.where(np.array(bits)[None, :] > 0, bmax, bmin)
                            for bits in [(i >> 2 & 1, i >> 1 & 1, i & 1) for i in range(8)]],
                           axis=1)   # [P, 8, 3]
        new_min = np.full_like(bmin, np.inf)
        new_max = np.full_like(bmax, -np.inf)
        for t in sorted(times):
            m, tr = host_eval_anim(tables, int(aid), float(t))
            tc = corners @ m.T + tr[None, None, :]
            new_min = np.minimum(new_min, tc.min(axis=1))
            new_max = np.maximum(new_max, tc.max(axis=1))
        pad = 0.01 * (new_max - new_min) + 1e-6
        amin[sel] = (new_min - pad).astype(np.float32)
        amax[sel] = (new_max + pad).astype(np.float32)
    return amin, amax


def _sah_build(amin, amax, cent, leaf_size):
    """The binary tree of bvh_builder.cpp: node_min/max [n, 3], prim_start, prim_count,
    miss_next [n], prim_order (leaf_size slots per leaf, -1 padded)."""
    fn = native.load_bvh_builder()
    n = amin.shape[0]
    cap = 2 * n + 2
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    prim_start = np.empty((cap,), np.int32)
    prim_count = np.empty((cap,), np.int32)
    miss_next = np.empty((cap,), np.int32)
    prim_order = np.empty((n * leaf_size + leaf_size,), np.int32)
    order_len = ctypes.c_int(0)
    args = [np.ascontiguousarray(x, np.float32) for x in (amin, amax, cent)]
    n_nodes = fn(*(a.ctypes.data for a in args), n, leaf_size, node_min.ctypes.data,
                 node_max.ctypes.data, prim_start.ctypes.data, prim_count.ctypes.data,
                 miss_next.ctypes.data, prim_order.ctypes.data, ctypes.addressof(order_len))
    if n_nodes <= 0:
        raise RuntimeError(f"BVH builder failed ({n_nodes})")
    return (node_min[:n_nodes], node_max[:n_nodes], prim_start[:n_nodes],
            prim_count[:n_nodes], miss_next[:n_nodes], prim_order[:order_len.value])


def pack_bvh(built, rows, leaf_size: int = LEAF_SIZE):
    """Binary pre-order tree and each primitive's leaf row [P, 12] (prim ids
    in the global order) -> (nodes [M, 16] f32, leaf rows [R, 12] f32, depth)."""
    node_min, node_max, prim_start, prim_count, miss_next, prim_order = built
    n = node_min.shape[0]
    inner = prim_start < 0
    leaf = ~inner
    # Leaves in pre-order own consecutive row ranges of the packed arrays.
    start = np.zeros((n,), np.int64)
    start[leaf] = np.cumsum(prim_count[leaf]) - prim_count[leaf]
    code = np.where(inner, np.cumsum(inner) - 1, -1 - (start * 16 + prim_count))
    slots = prim_order.reshape(-1, leaf_size)[prim_start[leaf] // leaf_size]
    prim_id = slots[np.arange(leaf_size)[None, :] < prim_count[leaf][:, None]].astype(np.int32)

    if inner.any():
        ids = np.nonzero(inner)[0]
        left, right = ids + 1, miss_next[ids + 1]     # left child follows its parent
        links = np.stack([code[left], code[right]], -1)
        boxes = np.concatenate([node_min[left], node_max[left],
                                node_min[right], node_max[right]], -1)
        depth = np.zeros((n,), np.int64)
        depth[0] = 1
        for i, lc, rc in zip(ids.tolist(), left.tolist(), right.tolist()):
            depth[lc] = depth[rc] = depth[i] + 1
        max_depth = int(depth[ids].max())
    else:   # the whole scene is one leaf: a root with one child
        links = np.array([[code[0], EMPTY]])
        boxes = np.concatenate([node_min[:1], node_max[:1], np.zeros((1, 6), np.float32)], -1)
        max_depth = 1
    if max_depth > STACK_DEPTH:
        raise ValueError(f"BVH has {max_depth} inner levels; the traversal stack holds "
                         f"{STACK_DEPTH}")
    nodes = np.zeros((links.shape[0], 16), np.float32)
    nodes[:, :12] = boxes
    nodes.view(np.int32)[:, 12:14] = links
    return nodes, rows[prim_id], max_depth


def leaf_rows(v0, v1, v2, center, radius, tri_anim, sph_anim):
    """[T + S, 12] f32 leaf row of each primitive in the global order. A
    triangle: v0 xyz, prim id | v1 xyz, animation id | v2 xyz, 0. A sphere:
    centre xyz, prim id | radius, 0, 0, animation id | 0, 0, 0, 0. The ids
    are int32 bit patterns; a static scene's pad words stay 0."""
    n_tris, n_sph = v0.shape[0], center.shape[0]
    rows = np.zeros((n_tris + n_sph, ROW_WORDS), np.float32)
    ints = rows.view(np.int32)
    rows[:n_tris, 0:3], rows[:n_tris, 4:7], rows[:n_tris, 8:11] = v0, v1, v2
    rows[n_tris:, 0:3], rows[n_tris:, 4] = center, radius
    ints[:, 3] = np.arange(n_tris + n_sph, dtype=np.int32)
    ints[:, 7] = np.concatenate([tri_anim, sph_anim]).astype(np.int32)
    return rows


def build_bvh(tris: Triangles, spheres: Optional[Spheres] = None,
              anims: Optional[AnimTable] = None, t0: float = 0.0, t1: float = 0.0,
              leaf_size: int = LEAF_SIZE) -> BVHArrays:
    """SAH BVH over the triangles and spheres of a scene, on the triangles'
    device. An animated primitive (`anims` holds its keyframes) is boxed
    over the render interval [t0, t1] (`swept_aabbs`); its object box is
    the JAX flattener's, from p0, p0 + e1 and p0 + e2, so that both packages
    sweep the same boxes."""
    n_sph = 0 if spheres is None else spheres.count
    if tris.count + n_sph == 0:
        raise ValueError("cannot build a BVH over an empty scene")
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    v0, v1, v2 = (host(x) for x in (tris.p0, tris.v1, tris.v2))
    center = host(spheres.center) if n_sph else np.zeros((0, 3), np.float32)
    radius = host(spheres.radius) if n_sph else np.zeros((0,), np.float32)
    tri_anim = host(anim_ids(tris))
    sph_anim = host(anim_ids(spheres)) if n_sph else np.zeros((0,), np.int32)
    prim_anim = np.concatenate([tri_anim, sph_anim])
    boxes = [np.concatenate(x) for x in zip(prim_aabbs(v0, v1, v2), sphere_aabbs(center, radius))]
    if np.any(prim_anim != 0):
        if anims is None:
            raise ValueError("animated primitives need the keyframe tables to box them")
        p0, e1, e2 = (host(x) for x in (tris.p0, tris.e1, tris.e2))
        obj_min, obj_max, _ = (np.concatenate(x) for x in zip(
            prim_aabbs(p0, p0 + e1, p0 + e2), sphere_aabbs(center, radius)))
        amin, amax = swept_aabbs(obj_min, obj_max, prim_anim, anims, t0, t1)
        moving = prim_anim != 0
        boxes[0][moving], boxes[1][moving] = amin[moving], amax[moving]
        boxes[2][moving] = (amin[moving] + amax[moving]) * np.float32(0.5)
    built = _sah_build(*boxes, leaf_size)
    rows = leaf_rows(v0, v1, v2, center, radius, tri_anim, sph_anim)
    nodes, prim_v, depth = pack_bvh(built, rows, leaf_size)
    dev = tris.p0.device
    return BVHArrays(torch.as_tensor(nodes, device=dev), torch.as_tensor(prim_v, device=dev),
                     depth, tris.count, n_sph, int(prim_anim.max(initial=0)) + 1)
