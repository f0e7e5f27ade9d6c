"""BVH closest hit (K5) and any hit (K6) over the port's binary BVH.

Port of ``wurblpt_tpu/accel/traverse.py`` `bvh_closest_hit` / `bvh_any_hit`
(the wide-BVH path, `_wide_closest_hit` / `_wide_any_hit`). The kernels
(``csrc/bvh_closest.cu``, ``csrc/bvh_any.cu``, the walk in
``csrc/bvh_common.cuh``) run a persistent launch whose warps take only the
live lanes, each thread's stack in shared memory. A small tree is walked
from shared memory (`walk_plan`: its node table, leaf rows and
animations' frames staged per block where they fit the bytes a block may
take without costing the SM a resident block), a larger one from L2; the
wrapper names the branch (`plan`). The plain versions beside
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

With the animations' rows (`frames`: scene/animation.anim_frames [A, 30]
at the frame's instant, or anim_frames_per_ray [N, A, 30] at each ray's
own instant under motion blur, which the kernels read from device memory
rather than stage) a row is tested with the ray in its
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


def _new_animations(aid, in_leaf, seen):
    """Object rays a leaf costs its lanes: the animations other than 0 (the
    identity, tested with the world ray) among the lane's tested slots that
    no earlier leaf of its walk used, and each lane's used animations [N, A]
    after the leaf."""
    used = torch.zeros(seen.shape, dtype=torch.int32, device=seen.device)
    used.scatter_add_(1, aid.long(), (in_leaf & (aid != 0)).to(torch.int32))
    fresh = (used > 0) & ~seen
    return int(fresh.sum()), seen | fresh


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
    # counts only: each lane's lockstep steps, by input lane, and the
    # animations its walk has used
    steps = torch.zeros((n,), dtype=torch.int64, device=dev)
    seen = torch.zeros((n, 0 if frames is None else frames.shape[-2]), dtype=torch.bool,
                       device=dev)
    live_in = t_max > t_min

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
            lane, o, d, inv_d, t_min, t_max, seen = (
                x[keep] for x in (lane, o, d, inv_d, t_min, t_max, seen))
            if frames is not None and frames.dim() == 3:   # each ray keeps its own rows
                frames = frames[keep]
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
            steps.index_add_(0, lane, live.long())
            if frames is not None:
                fresh, seen = _new_animations(rows_k.view(torch.int32)[..., 7], in_leaf, seen)
                counts["object_rays"] += fresh
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
    if counts is not None:
        counts.update(walk_lengths(steps, live_in))
    if any_hit:
        return out_occ
    return out_t, out_prim, out_u, out_v


def bvh_closest_hit_plain(bvh: BVHArrays, o, d, t_min, t_max, frames=None):
    """Plain version of K5: (t, prim, u, v); prim = -1 and t = BIG on a miss."""
    return _walk(bvh, o, d, t_min, t_max, any_hit=False, frames=frames)


def bvh_any_hit_plain(bvh: BVHArrays, o, d, t_min, t_max, frames=None):
    """Plain version of K6: True where a primitive is hit in (t_min, t_max)."""
    return _walk(bvh, o, d, t_min, t_max, any_hit=True, frames=frames)


WARP = 32   # lanes of a warp's chunk in the kernels' launch


def walk_lengths(steps, live):
    """Lockstep steps of the live lanes' walks (`steps` [N] by input lane,
    `live` [N]): their mean, 99th percentile and maximum, and the mean over
    the warps' chunks of 32 lanes (those with a live lane) of the chunk's
    longest walk, which bounds a launch of one wave."""
    if not bool(live.any()):
        return {"steps_mean": 0.0, "steps_p99": 0.0, "steps_max": 0, "warp_steps_mean": 0.0}
    s = torch.where(live, steps, 0)
    warps = torch.nn.functional.pad(s, (0, -s.shape[0] % WARP)).view(-1, WARP)
    has_live = torch.nn.functional.pad(live, (0, -live.shape[0] % WARP)).view(-1, WARP).any(1)
    per_lane = steps[live].double()
    return {"steps_mean": float(per_lane.mean()),
            "steps_p99": float(torch.quantile(per_lane, 0.99)),
            "steps_max": int(per_lane.max()),
            "warp_steps_mean": float(warps.amax(1)[has_live].double().mean())}


def bvh_walk_counts(bvh: BVHArrays, o, d, t_min, t_max, any_hit: bool, frames=None):
    """{"nodes": inner-node visits, "tri_tests": leaf triangle tests,
    "sphere_tests": leaf sphere tests, "object_rays": object-space rays
    computed (with `frames`: one per lane and animation other than 0 whose
    rows the lane's walk tests), and walk_lengths' keys} of the walk that
    K5 (any_hit False) or K6 takes for these rays: the plain version walks
    the same tree in the same order. A lockstep step visits one inner node,
    the leaf it may reach and the pop after it."""
    counts = {"nodes": 0, "tri_tests": 0, "sphere_tests": 0, "object_rays": 0}
    _walk(bvh, o, d, t_min, t_max, any_hit, frames, counts)
    return counts


def _check_bvh(bvh: BVHArrays, device, frames, n: int) -> int:
    """Raise unless the tree and the frame rows suit a cast of n rays on
    `device`; returns the kernels' lane stride of the rows in floats (0:
    one instant, or no rows; A 30: [n, A, 30] per-ray rows)."""
    if bvh.nodes.device != device or bvh.prim_v.device != device:
        raise ValueError(f"BVH is on {bvh.nodes.device}, rays on {device}")
    stride = 0
    if frames is None:
        if bvh.n_anims > 1:
            raise ValueError("an animated BVH needs the animations' frames")
    else:
        per_ray = frames.dim() == 3
        rows = frames.shape[-2] if frames.dim() in (2, 3) else -1
        if (frames.dtype != torch.float32 or frames.dim() not in (2, 3)
                or frames.shape[-1] != FRAME_WIDTH or rows < bvh.n_anims
                or per_ray and frames.shape[0] != n or not frames.is_contiguous()
                or frames.device != device):
            raise ValueError(f"frames: need contiguous float32 [>= {bvh.n_anims}, {FRAME_WIDTH}] "
                             f"or [{n}, >= {bvh.n_anims}, {FRAME_WIDTH}] on {device}, got "
                             f"{frames.dtype} {tuple(frames.shape)} on {frames.device}")
        stride = rows * FRAME_WIDTH if per_ray else 0
    if bvh.depth > STACK_DEPTH:
        raise ValueError(f"BVH depth {bvh.depth} exceeds the traversal stack ({STACK_DEPTH})")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no BVH kernel for device {device}")
    return stride


# (entry point, branch asked for, the tree's sizes, device, stream) ->
# (instantiation, lane counter, spill rows or None): planned and made on a
# stream's first cast of such a tree, and reused, since the casts of one
# stream run one after another.
_SCRATCH = {}

# The kernels' dynamic shared memory (csrc/bvh_common.cuh Layout).
BLOCK = 128          # threads per block
SLOTS_MAX = 8        # object-ray cache slots per thread at most
SLOT_WORDS = 8       # words of a slot
STAGED_FRAME = 12    # floats of an animation's staged frame row


def variant(bvh: BVHArrays, frames) -> int:
    """The kernels' leaf kind for a cast: bit 0 sphere rows in the tree, bit
    1 object-space rays (`frames`, at one instant or per ray)."""
    return int(bvh.n_spheres > 0) | (int(frames is not None) << 1)


def _per_ray(frames) -> bool:
    return frames is not None and frames.dim() == 3


def cache_slots(bvh: BVHArrays, frames) -> int:
    """Object-ray cache slots per thread: the animations other than the
    identity, to a power of two, at most SLOTS_MAX (0 without `frames`)."""
    if frames is None:
        return 0
    want = min(max(bvh.n_anims - 1, 1), SLOTS_MAX)
    return 1 << (want - 1).bit_length()


def layout_bytes(bvh: BVHArrays, frames, staged: bool) -> int:
    """Bytes of one block's dynamic shared memory (csrc/bvh_common.cuh
    `layout`): the stack at the tree's depth (staged); the object-ray
    cache and each thread's world ray (with `frames`); the node table, the
    leaf rows (32 bytes each in a tree without triangles, else 48) and the
    animations' inverse frames (staged, at one instant: per-ray rows stay in
    device memory)."""
    n = bvh.depth * BLOCK * 8 if staged else 0
    if frames is not None:
        n += cache_slots(bvh, frames) * SLOT_WORDS * BLOCK * 4 + 6 * BLOCK * 4
    if staged:
        n += bvh.nodes.shape[0] * 64 + bvh.prim_v.shape[0] * (2 if bvh.n_tris == 0 else 3) * 16
        if frames is not None and not _per_ray(frames):
            n += bvh.n_anims * STAGED_FRAME * 4
    return n


def walk_plan(bvh: BVHArrays, frames, budget: int):
    """(instantiation, branch, shared-memory bytes) of a cast: the leaf kind
    of `variant`, with bit 2 set when the tree is walked from shared memory
    ("shared": its staged layout fits `budget`, the bytes a block may take
    without costing the SM a resident block), else the L2 walk ("L2")."""
    var = variant(bvh, frames)
    staged = layout_bytes(bvh, frames, True)
    if staged <= budget:
        return var | 4, "shared", staged
    return var, "L2", layout_bytes(bvh, frames, False)


def plan(bvh: BVHArrays, frames, entry: str = "bvh_closest", branch=None):
    """walk_plan on the card, with the budget of the entry point's
    (`bvh_closest` or `bvh_any`) staged kernel; `branch` ("shared" or "L2")
    names the branch a check wants instead, and a staged layout past the
    budget raises."""
    lib = native.load_kernels()
    budget = getattr(lib, f"wpt_{entry}_budget")(variant(bvh, frames))
    var, name, smem = walk_plan(bvh, frames, budget)
    if branch is None or branch == name:
        return var, name, smem
    if branch == "L2":
        return var & 3, "L2", layout_bytes(bvh, frames, False)
    if branch == "shared":
        raise ValueError(f"the staged layout ({layout_bytes(bvh, frames, True)} B) passes the "
                         f"budget of {budget} B")
    raise ValueError(f"no branch {branch!r}")


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _launch_args(bvh: BVHArrays, o, d, t_min, t_max, frames, stride: int, entry: str, branch):
    """The entry point's arguments from the variant to the spill rows. The
    cast's plan, the persistent launch's lane counter (zeroed on the stream
    by the C entry where the lanes pass one wave) and the L2 walk's spill
    rows (the stack past SHARED_STACK entries, for every thread of a full
    launch; the staged walk keeps its whole stack in shared memory) are
    looked up once per tree size and stream."""
    lib = native.load_kernels()
    stream = native.stream_ptr(o)
    key = (entry, branch, variant(bvh, frames), _per_ray(frames), bvh.nodes.shape[0],
           bvh.prim_v.shape[0], bvh.n_tris, bvh.n_anims, bvh.depth, o.device, stream)
    if key not in _SCRATCH:
        var, _, smem = plan(bvh, frames, entry, branch)
        spill = None
        if not var & 4 and bvh.depth > SHARED_STACK:
            threads = getattr(lib, f"wpt_{entry}_threads")(var, smem)
            spill = torch.empty((threads * (bvh.depth - SHARED_STACK) * 2,), dtype=torch.int32,
                                device=o.device)
        _SCRATCH[key] = (var, torch.empty((1,), dtype=torch.int32, device=o.device), spill)
    var, counter, spill = _SCRATCH[key]
    return lib, (var, o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), o.shape[0],
                 bvh.nodes.data_ptr(), bvh.nodes.shape[0], bvh.prim_v.data_ptr(),
                 bvh.prim_v.shape[0], bvh.n_tris, _ptr(frames), stride, bvh.n_anims, bvh.depth,
                 counter.data_ptr(), _ptr(spill), stream)


def bvh_closest_hit(bvh: BVHArrays, o, d, t_min, t_max, frames=None, branch=None):
    """Closest hit (t, prim, u, v) of rays [N] in (t_min, t_max) (K5); with
    `frames`, each primitive tested in its animation's object space. The
    walk's branch follows the tree's size (`plan`); `branch` names one for
    a check of the other."""
    _check_rays(o, d, t_min, t_max)
    stride = _check_bvh(bvh, o.device, frames, o.shape[0])
    if o.device.type == "cpu":
        return bvh_closest_hit_plain(bvh, o, d, t_min, t_max, frames)
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    lib, args = _launch_args(bvh, o, d, t_min, t_max, frames, stride, "bvh_closest",
                             branch)
    code = lib.wpt_bvh_closest_hit(*args[:-1], t.data_ptr(), prim.data_ptr(), u.data_ptr(),
                                   v.data_ptr(), args[-1])
    native.check(code, "bvh_closest_hit")
    native.LAUNCHES["bvh_closest_hit"] += 1
    return t, prim, u, v


def bvh_any_hit(bvh: BVHArrays, o, d, t_min, t_max, frames=None, branch=None):
    """Occlusion of rays [N] in (t_min, t_max) (K6); t_max <= t_min means not
    occluded; `frames` and `branch` as bvh_closest_hit."""
    _check_rays(o, d, t_min, t_max)
    stride = _check_bvh(bvh, o.device, frames, o.shape[0])
    if o.device.type == "cpu":
        return bvh_any_hit_plain(bvh, o, d, t_min, t_max, frames)
    occ = torch.empty((o.shape[0],), dtype=torch.bool, device=o.device)
    lib, args = _launch_args(bvh, o, d, t_min, t_max, frames, stride, "bvh_any", branch)
    code = lib.wpt_bvh_any_hit(*args[:-1], occ.data_ptr(), args[-1])
    native.check(code, "bvh_any_hit")
    native.LAUNCHES["bvh_any_hit"] += 1
    return occ
