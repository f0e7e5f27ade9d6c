"""The plain BVH walk's work counts (``accel/traverse.py``
`bvh_walk_counts`), which the bounds and `utils/cast_steps.py` read: the
object rays of the object-space walk, one at most per ray and animation
other than the identity, and the walk lengths of each cast (a live lane's
lockstep steps, their mean, 99th percentile and maximum, and the mean of a
warp's longest walk). Also the identity row the kernels rely on, and the
edge sets' rays, built on the CPU."""

import functools

import numpy as np
import pytest
import torch

from wurblpt_tpu_torch.accel import traverse
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _animated():
    sc = scenes.cornell_box_animated("cpu", spheres=True, use_bvh=True)
    return sc.bvh, kc.frames_at(sc)


@functools.lru_cache(maxsize=None)
def _rtiow():
    return scenes.rtiow(n=8, device="cpu", use_bvh=True).bvh


def test_row_zero_of_the_frames_is_the_exact_identity():
    """The kernels test rows of animation 0 with the world ray moved by the
    identity's own arithmetic: that is the plain version's product only if
    row 0 holds exactly 1 and +0 (no -0) in r_inv and +0 in t_inv."""
    _, fr = _animated()
    want = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0]).view(torch.int32)
    assert torch.equal(fr[0, :12].view(torch.int32), want)


@pytest.mark.parametrize("any_hit", [False, True])
def test_object_rays_at_most_one_per_ray_and_moving_animation(any_hit):
    """Object rays count once per lane and animation other than 0 that its
    walk tests: never more than the animations per live lane, and on the
    animated box's camera rays at most 2 per live ray (the leaves alternate
    the identity with moving rows)."""
    bvh, fr = _animated()
    rays = kc.camera_lanes(24, 24, 1, "cpu")
    live = int((rays[3] > rays[2]).sum())
    c = traverse.bvh_walk_counts(bvh, *rays, any_hit=any_hit, frames=fr)
    assert 0 < c["object_rays"] <= live * (bvh.n_anims - 1)
    assert c["object_rays"] <= 2 * live
    for lane in range(0, rays[0].shape[0], 97):   # each lane alone: its own animations
        one = tuple(x[lane:lane + 1] for x in rays)
        assert traverse.bvh_walk_counts(bvh, *one, any_hit=any_hit,
                                        frames=fr)["object_rays"] <= bvh.n_anims - 1
    assert traverse.bvh_walk_counts(bvh, *rays, any_hit=any_hit)["object_rays"] == 0


@pytest.mark.parametrize("scene", ["rtiow", "animated"])
def test_walk_lengths_are_each_lanes_lockstep_steps(scene):
    """The walk lengths of a cast from the steps of each lane walked alone
    (a lane's walk does not depend on the others)."""
    if scene == "rtiow":
        bvh, fr = _rtiow(), None
        rays = kc.random_lanes(70, "cpu", seed=4, lo=(-4.0, 0.0, -4.0), hi=(4.0, 2.0, 4.0))
    else:
        bvh, fr = _animated()
        rays = kc.random_lanes(70, "cpu", seed=4)
    c = traverse.bvh_walk_counts(bvh, *rays, any_hit=False, frames=fr)
    live = rays[3] > rays[2]
    steps = torch.tensor([traverse.bvh_walk_counts(bvh, *(x[i:i + 1] for x in rays),
                                                   any_hit=False, frames=fr)["steps_max"]
                          for i in range(rays[0].shape[0])])
    assert int(steps[~live].sum()) == 0 and bool((steps[live] > 0).all())
    s = steps[live].double()
    assert c["steps_mean"] == pytest.approx(float(s.mean()))
    assert c["steps_p99"] == pytest.approx(float(torch.quantile(s, 0.99)))
    assert c["steps_max"] == int(s.max())
    warps = [steps[k:k + 32] for k in range(0, 70, 32)]
    longest = [float(w.max()) for k, w in zip(range(0, 70, 32), warps) if live[k:k + 32].any()]
    assert c["warp_steps_mean"] == pytest.approx(float(np.mean(longest)))
    assert c["steps_mean"] <= c["warp_steps_mean"] <= c["steps_max"]


def test_walk_lengths_of_dead_lanes():
    bvh = _rtiow()
    o, d, t_min, t_max = kc.random_lanes(40, "cpu")
    c = traverse.bvh_walk_counts(bvh, o, d, t_min, torch.zeros_like(t_max), any_hit=True)
    assert (c["steps_mean"], c["steps_max"], c["warp_steps_mean"]) == (0.0, 0, 0.0)


def test_walk_plan_names_the_branch_by_the_trees_size():
    """The staged walk where the layout fits the budget, the L2 walk past
    it; the RTIOW field's sphere-only rows staged at 32 bytes."""
    bvh, fr = _animated()
    rt = _rtiow()
    assert traverse.layout_bytes(rt, None, True) == (rt.depth * 128 * 8 + rt.nodes.shape[0] * 64
                                                     + rt.prim_v.shape[0] * 32)
    assert traverse.layout_bytes(rt, None, False) == 0
    # the animated walk: 4 cache slots of 8 words and the world ray, per thread
    assert traverse.cache_slots(bvh, fr) == 4
    assert traverse.layout_bytes(bvh, fr, False) == (4 * 8 + 6) * 128 * 4
    full = traverse.layout_bytes(bvh, fr, True)
    assert traverse.walk_plan(bvh, fr, full)[:2] == (7, "shared")
    assert traverse.walk_plan(bvh, fr, full - 1)[:2] == (3, "L2")
    assert traverse.walk_plan(rt, None, 1 << 20)[:2] == (5, "shared")


def test_edge_sets_are_built_on_the_cpu():
    """bvh_leaf_edge_sets at a small size: every set present, its rays
    finite and normalized, the tied set tied, the tree past the budget
    past it by less than a few leaves."""
    bvh, fr = _animated()
    budget = 9000
    sets = kc.bvh_leaf_edge_sets(_rtiow(), bvh, fr, "cpu", waves=(100,), budget=budget,
                                 frames_bytes=lambda b: traverse.layout_bytes(b, None, True),
                                 n=64)
    assert len(sets) == 18
    for name, (tree, (o, d, t_min, t_max), f) in sets.items():
        assert torch.isfinite(o).all() and torch.isfinite(d).all(), name
        assert torch.allclose(d.norm(dim=1), torch.ones(d.shape[0]), atol=1e-6), name
    past = sets["a tree just past the staging budget"][0]
    assert budget < traverse.layout_bytes(past, None, True) < budget + 4096
    tie, rays, _ = sets["a triangle and a sphere tied"]
    t, prim, _, _ = traverse.bvh_closest_hit_plain(tie, *rays)
    whole = (prim >= 0) & (t == torch.round(t))     # straight down a centre: a tie
    assert int(whole.sum()) > rays[0].shape[0] // 2
    assert bool((prim[whole] >= tie.n_tris).any()) and bool((prim[whole] < tie.n_tris).any())
