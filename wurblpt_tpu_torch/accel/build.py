"""BVH construction for the K5/K6 kernels (port of ``wurblpt_tpu/accel/build.py``:
`prim_aabbs` and the SAH build).

The SAH build is the host builder of ``csrc/host/bvh_builder.cpp`` (binned
SAH, binary tree emitted in DFS pre-order with miss links; a copy of the JAX
package's, the same code), compiled with g++ and called through ctypes
(:func:`wurblpt_tpu_torch.native.load_bvh_builder`). Its tree is then
packed into the port's own layout, :class:`~wurblpt_tpu_torch.scene.ir.BVHArrays`:
each node row holds the boxes and links of its two children, so a ray reads
one 64-byte row and tests both; a leaf holds up to `LEAF_SIZE` triangles
stored contiguously, each an aligned 48-byte row of three float4 (v0, v1,
v2, absolute; the prim id bit-cast into v0's pad), which a thread reads
with three 16-byte loads. The JAX package's W=32 collapse, octant threading
and float-encoded links are TPU gather tricks and are not ported; a
compressed 8-wide collapse (Ylitie et al. 2017: 8-bit child boxes against
a per-node origin and power-of-two scales) was built and measured against
this layout on the H100 and walked slower under the kernels' bit-equality
with their plain versions (PERF.md), so the tree stays binary.

The traversal pushes at most one entry per inner level, so a walk holds at
most `depth` stack entries; a tree with more inner nodes on one
root-to-leaf path than `STACK_DEPTH` is refused here, never truncated.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import native
from ..scene.ir import BVHArrays, Triangles

LEAF_SIZE = 8        # triangles per leaf at most; a leaf code keeps the count in 4 bits
STACK_DEPTH = 64     # stack entries a walk may need at most (its depth): deeper trees are refused
TRI_WORDS = 12       # 48 bytes per leaf triangle row
EMPTY = -1           # link of a missing child


def prim_aabbs(v0, v1, v2):
    """(min, max, centroid) [T, 3] f32 of each triangle.

    From the absolute vertices, so a box holds exactly the corners the
    watertight test reads (the JAX package boxes p0 + e1, p0 + e2)."""
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    return lo, hi, ((lo + hi) * np.float32(0.5)).astype(np.float32)


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


def pack_bvh(built, v0, v1, v2, leaf_size: int = LEAF_SIZE):
    """Binary pre-order tree -> (nodes [M, 16] f32, tri_v [T, 12] f32, depth)."""
    node_min, node_max, prim_start, prim_count, miss_next, prim_order = built
    n = node_min.shape[0]
    inner = prim_start < 0
    leaf = ~inner
    # Leaves in pre-order own consecutive triangle ranges of the packed arrays.
    start = np.zeros((n,), np.int64)
    start[leaf] = np.cumsum(prim_count[leaf]) - prim_count[leaf]
    code = np.where(inner, np.cumsum(inner) - 1, -1 - (start * 16 + prim_count))
    slots = prim_order.reshape(-1, leaf_size)[prim_start[leaf] // leaf_size]
    tri_id = slots[np.arange(leaf_size)[None, :] < prim_count[leaf][:, None]].astype(np.int32)

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
    tri_v = np.zeros((tri_id.shape[0], TRI_WORDS), np.float32)
    tri_v[:, 0:3], tri_v[:, 4:7], tri_v[:, 8:11] = v0[tri_id], v1[tri_id], v2[tri_id]
    tri_v.view(np.int32)[:, 3] = tri_id
    return nodes, tri_v, max_depth


def build_bvh(tris: Triangles, leaf_size: int = LEAF_SIZE) -> BVHArrays:
    """SAH BVH over the triangles of a scene, on the triangles' device."""
    if tris.count == 0:
        raise ValueError("cannot build a BVH over an empty scene")
    v0, v1, v2 = (x.detach().cpu().numpy() for x in (tris.p0, tris.v1, tris.v2))
    built = _sah_build(*prim_aabbs(v0, v1, v2), leaf_size)
    nodes, tri_v, depth = pack_bvh(built, v0, v1, v2, leaf_size)
    dev = tris.p0.device
    return BVHArrays(torch.as_tensor(nodes, device=dev), torch.as_tensor(tri_v, device=dev), depth)
