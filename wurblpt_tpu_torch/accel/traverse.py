"""BVH closest hit (K5) and any hit (K6) over the port's binary BVH.

Port of ``wurblpt_tpu/accel/traverse.py`` `bvh_closest_hit` / `bvh_any_hit`
(the wide-BVH path, `_wide_closest_hit` / `_wide_any_hit`). The kernels
(``csrc/bvh_closest.cu``, ``csrc/bvh_any.cu``, the walk in
``csrc/bvh_common.cuh``) run a persistent launch whose warps take only the
live lanes, each thread's stack in shared memory. The plain versions beside
them walk the SAME tree in lockstep over the rays still walking (finished
rays drop out of the lockstep tensors when they are half of them), with a
per-lane [N, depth] stack, and take every decision the kernels take, in
the same order:

1. at an inner node, slab-test both children against (t_min, min(t_max,
   best t)); descend into the first hit child and push the other with its
   entry distance: the closest cast takes the nearer first (child 0 on a
   tie), the any-hit cast child 0 first (its result does not depend on the
   order, and this order walks less on the bench frames' shadow rays);
2. at a leaf, test its rows in order against the bound of step 1: a
   triangle row with `watertight_tri`, a sphere row (prim id >= n_tris)
   with the stable quadratic of the sweeps (`ray_sphere_tile`) in the
   BVH's rounding (the fused multiply-adds of XLA's leaf test); the closest
   cast keeps the first strictly nearer hit in the walk's order (a sphere
   with u = v = 0), the any-hit cast stops at the first valid one;
3. with no child hit, or after a leaf, pop the topmost stack entry whose
   entry distance is below min(t_max, best t), dropping the entries above it;
   an empty stack ends the walk.

With the animations' rows at the frame's instant (`frames`,
scene/animation.anim_frames) a row is tested with the ray in its
animation's object space (row 0, the identity, for static primitives;
`frames_ray_to_object`, the sweeps' expression), while the slab tests stay
on the world ray against the swept world boxes. Kernel and plain version
therefore resolve ties identically, and their prim ids can be compared
exactly. A lane with t_max <= t_min (dead, or not in this
cast) leaves without reading the tree. A ray direction component with
|d| <= 1e-20 gets 1/d = BIG, so a slab term is never 0 * inf.

The wrappers take the plain version for CPU tensors only; on CUDA they launch
the kernel or raise.
"""

from __future__ import annotations

import torch

from .. import native
from ..render.intersect import watertight_tri
from ..render.intersect_brute import BIG, _check_rays
from ..render.intersect_sweep import ray_sphere_tile
from ..scene.animation import FRAME_WIDTH, frames_ray_to_object
from ..scene.ir import BVHArrays
from .build import EMPTY, LEAF_SIZE, STACK_DEPTH

SHARED_STACK = 16    # stack entries per thread in shared memory: SHORT in csrc/bvh_common.cuh


def _inv_dir(d):
    return torch.where(torch.abs(d) > 1e-20, 1.0 / torch.where(d == 0.0, 1.0, d), BIG)


def _children(bvh: BVHArrays, node, o, inv_d, t_min, bound):
    """(hit [N, 2], entry distance [N, 2], links [N, 2]) of both children of `node`."""
    row = bvh.nodes[node]
    links = bvh.links[node]
    box = row[:, :12].reshape(-1, 2, 6)
    t0 = (box[..., 0:3] - o[:, None]) * inv_d[:, None]
    t1 = (box[..., 3:6] - o[:, None]) * inv_d[:, None]
    near = torch.maximum(torch.minimum(t0, t1).amax(-1), t_min[:, None])
    far = torch.minimum(torch.maximum(t0, t1).amin(-1), bound[:, None])
    return (near <= far) & (links != EMPTY), near, links.long()


def _object_runs(aid, in_leaf, last):
    """Object rays a lane computes at a leaf: the slots whose animation id
    differs from the one before (the lane's `last` before the first), and
    the lane's last id after the leaf."""
    prev = torch.cat([last[:, None], aid[:, :-1]], 1)
    k = in_leaf.sum(1)
    new_last = torch.where(k > 0, aid.gather(1, torch.clamp_min(k - 1, 0)[:, None])[:, 0], last)
    return int(((aid != prev) & in_leaf).sum()), new_last


def _leaf_tests(bvh: BVHArrays, rows, o, d, t_min, bound, frames):
    """(t, u, v, valid) [N, K] of each lane against its leaf rows [N, K, 12]:
    the watertight test on triangle rows, the sphere quadratic on sphere
    rows (u = v = 0), each with the world ray or, with `frames`, the ray in
    the row's animation space."""
    ids = rows.view(torch.int32)
    if frames is None:
        ox, dx = o[:, None], d[:, None]
    else:
        ox, dx, _ = frames_ray_to_object(frames, ids[..., 7], o, d)
    t, u, v, valid = watertight_tri(ox, dx, rows[..., 0:3], rows[..., 4:7], rows[..., 8:11],
                                    t_min[:, None], bound[:, None])
    if bvh.n_spheres:
        sph = ids[..., 3] >= bvh.n_tris
        ts, vs = ray_sphere_tile(ox, dx, rows[..., 0:3], rows[..., 4], t_min, bound, bvh=True)
        t, valid = torch.where(sph, ts, t), torch.where(sph, vs, valid)
        u, v = torch.where(sph, 0.0, u), torch.where(sph, 0.0, v)
    return t, u, v, valid


def _walk(bvh: BVHArrays, o, d, t_min, t_max, any_hit: bool, frames=None, counts=None):
    n = o.shape[0]
    dev = o.device
    depth = max(bvh.depth, 1)
    iota = torch.arange(depth, device=dev)
    slot_ids = torch.arange(LEAF_SIZE, device=dev)
    n_slots = bvh.prim_v.shape[0]
    prim_id = bvh.prim_id
    inv_d = _inv_dir(d)
    last_aid = torch.full((n,), -1, dtype=torch.int32, device=dev)   # counts only

    out_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    out_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    out_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    out_occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    lane = torch.arange(n, device=dev)          # the input lane of each row
    cur = torch.zeros((n,), dtype=torch.int64, device=dev)    # the root
    live = t_max > t_min
    sp = torch.zeros((n,), dtype=torch.int64, device=dev)
    stack_l = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    stack_t = torch.full((n, depth), BIG, dtype=torch.float32, device=dev)
    best_t, best_prim, best_u, best_v, occluded = (out_t.clone(), out_prim.clone(), out_u.clone(),
                                                   out_v.clone(), out_occ.clone())

    def store(sel):
        out_t[lane[sel]], out_prim[lane[sel]] = best_t[sel], best_prim[sel]
        out_u[lane[sel]], out_v[lane[sel]] = best_u[sel], best_v[sel]
        out_occ[lane[sel]] = occluded[sel]

    while True:
        n_live = int(live.sum())
        if n_live == 0:
            break
        if n_live < lane.shape[0] // 2:
            # Finished rays drop out of the lockstep; each ray's walk is unchanged.
            store(~live)
            keep = live
            lane, o, d, inv_d, t_min, t_max, last_aid = (
                x[keep] for x in (lane, o, d, inv_d, t_min, t_max, last_aid))
            cur, live, sp, stack_l, stack_t = (x[keep] for x in (cur, live, sp, stack_l, stack_t))
            best_t, best_prim, best_u, best_v, occluded = (
                x[keep] for x in (best_t, best_prim, best_u, best_v, occluded))
        rows = torch.arange(lane.shape[0], device=dev)
        bound = torch.minimum(t_max, best_t)
        # 1. inner node: descend into the nearer hit child, push the farther
        inner = live & (cur >= 0)
        hit, near, links = _children(bvh, torch.clamp_min(cur, 0), o, inv_d, t_min, bound)
        h0, h1 = hit[:, 0] & inner, hit[:, 1] & inner
        first1 = h1 & ~h0 if any_hit else h1 & (~h0 | (near[:, 1] < near[:, 0]))
        push = h0 & h1
        slot = torch.clamp_max(sp, depth - 1)
        stack_l[rows, slot] = torch.where(push, torch.where(first1, links[:, 0], links[:, 1]),
                                          stack_l[rows, slot])
        stack_t[rows, slot] = torch.where(push, torch.where(first1, near[:, 0], near[:, 1]),
                                          stack_t[rows, slot])
        sp = sp + push.long()
        cur = torch.where(h0 | h1, torch.where(first1, links[:, 1], links[:, 0]), cur)
        pop = inner & ~(h0 | h1)

        # 2. leaf: its rows against this step's bound
        leaf = live & (cur <= -2)
        code = torch.clamp_min(-1 - cur, 0)
        slots = (code >> 4)[:, None] + slot_ids
        in_leaf = (slot_ids < (code & 15)[:, None]) & leaf[:, None]
        rows_k = bvh.prim_v[torch.clamp_max(slots, n_slots - 1)]
        t, u, v, valid = _leaf_tests(bvh, rows_k, o, d, t_min, bound, frames)
        valid = valid & in_leaf
        if counts is not None:   # the work this walk does: node visits, leaf tests, object rays
            sph = rows_k.view(torch.int32)[..., 3] >= bvh.n_tris
            counts["nodes"] += int(inner.sum())
            counts["tri_tests"] += int((in_leaf & ~sph).sum())
            counts["sphere_tests"] += int((in_leaf & sph).sum())
            if frames is not None:
                runs, last_aid = _object_runs(rows_k.view(torch.int32)[..., 7], in_leaf, last_aid)
                counts["object_rays"] += runs
        if any_hit:
            occluded = occluded | valid.any(1)
            live = live & ~occluded
        else:
            t_all = torch.where(valid, t, BIG)
            t_all = torch.where(t_all < best_t[:, None], t_all, BIG)
            k = torch.argmin(t_all, 1)
            tk = t_all[rows, k]
            closer = tk < best_t
            best_t = torch.where(closer, tk, best_t)
            best_prim = torch.where(closer, prim_id[torch.clamp_max(slots[rows, k], n_slots - 1)],
                                    best_prim)
            best_u = torch.where(closer, u[rows, k], best_u)
            best_v = torch.where(closer, v[rows, k], best_v)
        pop = (pop | leaf) & live

        # 3. pop the topmost entry still nearer than the bound
        bound = torch.minimum(t_max, best_t)
        cand = (iota < sp[:, None]) & (stack_t < bound[:, None])
        top = torch.where(cand, iota, -1).amax(1)
        found = top >= 0
        cur = torch.where(pop & found, stack_l[rows, torch.clamp_min(top, 0)], cur)
        sp = torch.where(pop, torch.clamp_min(top, 0), sp)
        live = live & ~(pop & ~found)
    store(torch.ones_like(live))
    if any_hit:
        return out_occ
    return out_t, out_prim, out_u, out_v


def bvh_closest_hit_plain(bvh: BVHArrays, o, d, t_min, t_max, frames=None):
    """Plain version of K5: (t, prim, u, v); prim = -1 and t = BIG on a miss."""
    return _walk(bvh, o, d, t_min, t_max, any_hit=False, frames=frames)


def bvh_any_hit_plain(bvh: BVHArrays, o, d, t_min, t_max, frames=None):
    """Plain version of K6: True where a primitive is hit in (t_min, t_max)."""
    return _walk(bvh, o, d, t_min, t_max, any_hit=True, frames=frames)


def bvh_walk_counts(bvh: BVHArrays, o, d, t_min, t_max, any_hit: bool, frames=None):
    """{"nodes": inner-node visits, "tri_tests": leaf triangle tests,
    "sphere_tests": leaf sphere tests, "object_rays": object-space rays
    computed (with `frames`: one wherever a lane's next leaf row has
    another animation id than its last)} of the walk that K5 (any_hit
    False) or K6 takes for these rays: the plain version walks the same
    tree in the same order."""
    counts = {"nodes": 0, "tri_tests": 0, "sphere_tests": 0, "object_rays": 0}
    _walk(bvh, o, d, t_min, t_max, any_hit, frames, counts)
    return counts


def _check_bvh(bvh: BVHArrays, device, frames):
    if bvh.nodes.device != device or bvh.prim_v.device != device:
        raise ValueError(f"BVH is on {bvh.nodes.device}, rays on {device}")
    if frames is None:
        if bvh.n_anims > 1:
            raise ValueError("an animated BVH needs the animations' frames")
    elif (frames.dtype != torch.float32 or frames.dim() != 2 or frames.shape[1] != FRAME_WIDTH
          or frames.shape[0] < bvh.n_anims or not frames.is_contiguous()
          or frames.device != device):
        raise ValueError(f"frames: need contiguous float32 [>= {bvh.n_anims}, {FRAME_WIDTH}] "
                         f"on {device}, got {frames.dtype} {tuple(frames.shape)} on "
                         f"{frames.device}")
    if bvh.depth > STACK_DEPTH:
        raise ValueError(f"BVH depth {bvh.depth} exceeds the traversal stack ({STACK_DEPTH})")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no BVH kernel for device {device}")


# (entry point, variant, device, stream) -> [threads of a full launch, lane
# counter, spill rows or None]: made on a stream's first cast, grown with the
# tree's depth, and reused, since the casts of one stream run one after another.
_SCRATCH = {}


def variant(bvh: BVHArrays, frames) -> int:
    """The kernels' instantiation for a cast: bit 0 sphere rows in the tree,
    bit 1 object-space rays (`frames`)."""
    return int(bvh.n_spheres > 0) | (int(frames is not None) << 1)


def _scratch(bvh: BVHArrays, var: int, device, stream: int, lib, entry: str):
    """(the persistent launch's lane counter, the stack's spill rows or None):
    the kernel's first SHARED_STACK entries per thread live in shared
    memory, the rest of the tree's depth in rows of device memory for every
    thread of a full launch. The launch zeroes the counter on the stream
    before it starts; neither needs a kernel of its own, nor, after the
    stream's first cast, an allocation."""
    key = (entry, var, device, stream)
    if key not in _SCRATCH:
        threads = getattr(lib, f"wpt_{entry}_threads")(var)
        _SCRATCH[key] = [threads, torch.empty((1,), dtype=torch.int32, device=device), None]
    scratch = _SCRATCH[key]
    threads, counter, spill = scratch
    need = threads * max(bvh.depth - SHARED_STACK, 0) * 2
    if need and (spill is None or spill.numel() < need):
        spill = scratch[2] = torch.empty((need,), dtype=torch.int32, device=device)
    return counter, spill if need else None


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def bvh_closest_hit(bvh: BVHArrays, o, d, t_min, t_max, frames=None):
    """Closest hit (t, prim, u, v) of rays [N] in (t_min, t_max) (K5); with
    `frames`, each primitive tested in its animation's object space."""
    _check_rays(o, d, t_min, t_max)
    _check_bvh(bvh, o.device, frames)
    if o.device.type == "cpu":
        return bvh_closest_hit_plain(bvh, o, d, t_min, t_max, frames)
    lib = native.load_kernels()
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    stream = native.stream_ptr(o)
    var = variant(bvh, frames)
    counter, spill = _scratch(bvh, var, o.device, stream, lib, "bvh_closest")
    code = lib.wpt_bvh_closest_hit(
        var, o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n,
        bvh.nodes.data_ptr(), bvh.prim_v.data_ptr(), bvh.n_tris, _ptr(frames),
        counter.data_ptr(), _ptr(spill), t.data_ptr(), prim.data_ptr(), u.data_ptr(),
        v.data_ptr(), stream)
    native.check(code, "bvh_closest_hit")
    native.LAUNCHES["bvh_closest_hit"] += 1
    return t, prim, u, v


def bvh_any_hit(bvh: BVHArrays, o, d, t_min, t_max, frames=None):
    """Occlusion of rays [N] in (t_min, t_max) (K6); t_max <= t_min means not
    occluded; `frames` as bvh_closest_hit."""
    _check_rays(o, d, t_min, t_max)
    _check_bvh(bvh, o.device, frames)
    if o.device.type == "cpu":
        return bvh_any_hit_plain(bvh, o, d, t_min, t_max, frames)
    lib = native.load_kernels()
    n = o.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=o.device)
    stream = native.stream_ptr(o)
    var = variant(bvh, frames)
    counter, spill = _scratch(bvh, var, o.device, stream, lib, "bvh_any")
    code = lib.wpt_bvh_any_hit(
        var, o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n,
        bvh.nodes.data_ptr(), bvh.prim_v.data_ptr(), bvh.n_tris, _ptr(frames),
        counter.data_ptr(), _ptr(spill), occ.data_ptr(), stream)
    native.check(code, "bvh_any_hit")
    native.LAUNCHES["bvh_any_hit"] += 1
    return occ
