"""The port's BVH (build, and the plain versions of K5/K6) against the JAX
package's BVH traversal and against a brute-force watertight sweep.

The scene is the small terrain_city (2594 triangles); rays are made with
numpy from a seed: camera rays of the mesh frame's camera, random rays,
axis-aligned rays (zero direction components), and dead lanes (t_max = 0).
The two packages build different trees from the same triangles, so where
two triangles lie at the same distance (the terrain's shared edges) either
may win: prim ids are compared only where the runner-up is farther than
1e-5 * t; t, u, v are compared where both pick the same triangle: t to
rtol 1e-5, u and v to atol 1e-5 (XLA's CPU backend may fuse a product and
a difference of the edge functions into one FMA, PyTorch rounds both, and
the edge functions cancel). Against the brute-force sweep of the same
watertight test, t is equal on every lane."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu.accel.traverse import bvh_any_hit as jbvh_any_hit
from wurblpt_tpu.accel.traverse import bvh_closest_hit as jbvh_closest_hit
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import native
from wurblpt_tpu_torch.accel import build, traverse
from wurblpt_tpu_torch.render.intersect import watertight_tri
from wurblpt_tpu_torch.render.intersect_brute import BIG
from wurblpt_tpu_torch.scene.ir import scene_from_numpy
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

SMALL = dict(terrain_res=24, n_buildings=8, sphere_slices=6)
N = 1024
# One jitted callable per function, every call at the same shapes.
_jclosest = jax.jit(jbvh_closest_hit)
_jany = jax.jit(jbvh_any_hit)


@functools.lru_cache(maxsize=None)
def _scenes():
    jscene = jscenes.terrain_city(seed=3, **SMALL).build(use_bvh=True)
    return jscene, scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")


def _rays(kind):
    rs = np.random.default_rng({"camera": 0, "random": 1, "axis": 2, "dead": 3}[kind])
    if kind == "camera":
        return kc.camera_lanes(32, 32, 1, "cpu", camera=scenes.terrain_camera("cpu"))
    o = rs.uniform((-20.0, -2.0, -20.0), (20.0, 6.0, 20.0), size=(N, 3))
    if kind == "axis":
        d = np.eye(3)[rs.integers(0, 3, N)] * rs.choice([-1.0, 1.0], size=(N, 1))
    else:
        d = rs.normal(size=(N, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full((N,), BIG)
    if kind == "dead":
        t_max[rs.uniform(size=N) < 0.5] = 0.0
    f32 = dict(dtype=torch.float32)
    return (torch.as_tensor(o, **f32), torch.as_tensor(d, **f32), torch.full((N,), 1e-4),
            torch.as_tensor(t_max, **f32))


def _sweep(scene, o, d, t_min, t_max):
    """[N, T] watertight hit distance of every ray/triangle pair (BIG if none)."""
    T = scene.tris
    t, _, _, _ = watertight_tri(o[:, None], d[:, None], T.p0[None], T.v1[None], T.v2[None],
                                t_min[:, None], t_max[:, None])
    return t


@pytest.mark.parametrize("kind", ["camera", "random", "axis", "dead"])
def test_closest_hit_matches_jax_and_the_sweep(kind):
    jscene, scene = _scenes()
    rays = _rays(kind)
    t, prim, u, v = (x.numpy() for x in traverse.bvh_closest_hit_plain(scene.bvh, *rays))
    jt, jprim, ju, jv = (np.asarray(x) for x in _jclosest(
        jscene, *(jnp.asarray(r.numpy()) for r in rays)))
    cand = np.sort(_sweep(scene, *rays).numpy(), 1)
    tie = (cand[:, 1] - cand[:, 0] <= 1e-5 * cand[:, 0]) & (cand[:, 0] < BIG)
    np.testing.assert_array_equal(prim[~tie], jprim[~tie])
    same = (prim == jprim) & (prim >= 0)
    np.testing.assert_allclose(t[same], jt[same], rtol=1e-5)
    np.testing.assert_allclose(u[same], ju[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v[same], jv[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t, cand[:, 0])          # the sweep's nearest distance
    assert 0.1 < (prim >= 0).mean() and (prim < 0).any()
    dead = rays[3].numpy() == 0.0
    assert (prim[dead] == -1).all() and (t[dead] == np.float32(BIG)).all()


@pytest.mark.parametrize("kind", ["random", "axis", "dead"])
def test_any_hit_matches_jax_and_the_sweep(kind):
    jscene, scene = _scenes()
    o, d, t_min, t_max = _rays(kind)
    # Finite segments as shadow rays have them, BIG on a quarter of the live lanes.
    rs = np.random.default_rng(9)
    seg = np.where(rs.uniform(size=N) < 0.25, BIG, rs.uniform(0.1, 12.0, size=N))
    t_max = torch.minimum(t_max, torch.as_tensor(seg, dtype=torch.float32))
    rays = (o, d, t_min, t_max)
    occ = traverse.bvh_any_hit_plain(scene.bvh, *rays).numpy()
    jocc = np.asarray(_jany(jscene, *(jnp.asarray(r.numpy()) for r in rays)))
    near = _sweep(scene, o, d, t_min, torch.full_like(t_max, BIG)).min(1).values.numpy()
    clear = np.abs(near - t_max.numpy()) > 1e-5 * t_max.numpy()
    np.testing.assert_array_equal(occ[clear], jocc[clear])
    np.testing.assert_array_equal(occ, near < t_max.numpy())
    assert 0 < occ.sum() < N


def _check_layout(bvh, tris):
    """Every triangle sits in exactly one leaf of 1..LEAF_SIZE rows, its
    absolute vertices copied into a 48-byte row with the prim id in v0's pad
    and zero pads; every child box holds its subtree's triangles; the depth
    is the tree's, within the stack."""
    assert sorted(bvh.tri_id.tolist()) == list(range(tris.count))
    ids = bvh.tri_id.long()
    tv = bvh.tri_v
    assert tv.shape[1] == 12
    assert torch.equal(tv[:, 0:3], tris.p0[ids]) and torch.equal(tv[:, 4:7], tris.v1[ids])
    assert torch.equal(tv[:, 8:11], tris.v2[ids])
    assert (tv[:, 7] == 0).all() and (tv[:, 11] == 0).all()
    links = bvh.links
    lo = torch.minimum(torch.minimum(tv[:, 0:3], tv[:, 4:7]), tv[:, 8:11])
    hi = torch.maximum(torch.maximum(tv[:, 0:3], tv[:, 4:7]), tv[:, 8:11])
    rows_seen = torch.zeros(tv.shape[0], dtype=torch.int64)

    def span(link):   # (lo, hi, inner levels) of the subtree under `link`
        if link <= -2:
            code = -1 - link
            s, c = code >> 4, code & 15
            assert 1 <= c <= build.LEAF_SIZE
            rows_seen[s:s + c] += 1
            return lo[s:s + c].amin(0), hi[s:s + c].amax(0), 0
        kids = []
        for c in range(2):
            if int(links[link, c]) != build.EMPTY:
                klo, khi, kd = span(int(links[link, c]))
                box = bvh.nodes[link, 6 * c:6 * c + 6]
                assert (box[:3] <= klo).all() and (box[3:] >= khi).all()
                kids.append((klo, khi, kd))
        return (torch.stack([k[0] for k in kids]).amin(0), torch.stack([k[1] for k in kids]).amax(0),
                1 + max(k[2] for k in kids))

    assert span(0)[2] == bvh.depth and 1 <= bvh.depth <= build.STACK_DEPTH
    assert (rows_seen == 1).all()


def test_build_layout():
    """The small terrain_city's tree (see _check_layout)."""
    _, scene = _scenes()
    _check_layout(scene.bvh, scene.tris)
    assert scene.bvh.depth >= 3


def test_build_refuses_a_tree_deeper_than_the_stack(monkeypatch):
    _, scene = _scenes()
    monkeypatch.setattr(build, "STACK_DEPTH", scene.bvh.depth - 1)
    with pytest.raises(ValueError, match="stack"):
        build.build_bvh(scene.tris)


def test_one_leaf_scene():
    """A scene of <= LEAF_SIZE triangles is a root with one leaf child."""
    _, scene = _scenes()
    tris = type(scene.tris)(*(x[:5] for x in scene.tris))
    bvh = build.build_bvh(tris)
    assert bvh.nodes.shape[0] == 1 and bvh.depth == 1
    assert bvh.links[0, 1] == build.EMPTY
    _check_layout(bvh, tris)
    rays = _rays("random")
    t, prim, _, _ = traverse.bvh_closest_hit_plain(bvh, *rays)
    sweep = _sweep(scene._replace(tris=tris), *rays)
    assert torch.equal(t, sweep.min(1).values)


def _flat_scene():
    """Axis-aligned flat quads: a 12 x 12 floor at y = 0 and walls at x = 0
    and z = 3, each a pair of triangles, so many child boxes are flat on one
    axis (as the terrain's and the city's walls are)."""
    _, scene = _scenes()
    g = np.arange(12, dtype=np.float32)
    cells = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    quads = []
    for a, b in cells:
        quads.append([(a, 0, b), (a + 1, 0, b), (a + 1, 0, b + 1), (a, 0, b + 1)])
        quads.append([(0, a * 0.5, b), (0, a * 0.5 + 0.5, b), (0, a * 0.5 + 0.5, b + 1),
                      (0, a * 0.5, b + 1)])
        quads.append([(a, b * 0.5, 3), (a + 1, b * 0.5, 3), (a + 1, b * 0.5 + 0.5, 3),
                      (a, b * 0.5 + 0.5, 3)])
    q = np.asarray(quads, np.float32) - np.float32(6.0)
    v0 = np.concatenate([q[:, 0], q[:, 0]])
    v1 = np.concatenate([q[:, 1], q[:, 2]])
    v2 = np.concatenate([q[:, 2], q[:, 3]])
    n = v0.shape[0]
    ref = scene.tris
    fields = {name: getattr(ref, name)[:1].expand(n, *getattr(ref, name).shape[1:]).clone()
              for name in ref._fields}
    fields.update(p0=torch.as_tensor(v0), v1=torch.as_tensor(v1), v2=torch.as_tensor(v2),
                  e1=torch.as_tensor(v1 - v0), e2=torch.as_tensor(v2 - v0))
    tris = type(ref)(**fields)
    return scene._replace(tris=tris), build.build_bvh(tris)


def _aimed_rays(tris, kind, seed=5):
    """N rays at points of the triangles (pushed up to 5 % outside them, so
    some miss) from 1-10 units away: from random directions, along the axes,
    or from random directions with half the lanes dead (t_max = 0)."""
    rs = np.random.default_rng(seed)
    k = rs.integers(0, tris.count, N)
    a, b = rs.uniform(size=(2, N, 1))
    a, b = np.where(a + b > 1, 1 - a, a) * 1.1 - 0.05, np.where(a + b > 1, 1 - b, b) * 1.1 - 0.05
    target = tris.p0.numpy()[k] + a * tris.e1.numpy()[k] + b * tris.e2.numpy()[k]
    if kind == "axis":
        d = np.eye(3)[rs.integers(0, 3, N)] * rs.choice([-1.0, 1.0], size=(N, 1))
    else:
        d = rs.normal(size=(N, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = target - d * rs.uniform(1.0, 10.0, size=(N, 1))
    t_max = np.full((N,), BIG)
    if kind == "dead":
        t_max[rs.uniform(size=N) < 0.5] = 0.0
    f32 = dict(dtype=torch.float32)
    return (torch.as_tensor(o, **f32), torch.as_tensor(d, **f32), torch.full((N,), 1e-4),
            torch.as_tensor(t_max, **f32))


@pytest.mark.parametrize("case", ["flat boxes", "<= 8 triangles"])
@pytest.mark.parametrize("kind", ["random", "axis", "dead"])
def test_small_and_flat_trees_match_the_sweep(case, kind):
    """The walk over flat child boxes (zero extent on one axis, as the
    terrain's and the city's walls have) and over a one-leaf tree finds the
    sweep's nearest hit on every lane, and the any-hit walk the sweep's
    occlusion."""
    if case == "flat boxes":
        scene, bvh = _flat_scene()
        box = bvh.nodes[:, :12].reshape(-1, 2, 6)
        assert (box[..., 3:] == box[..., :3]).any()     # some child box is flat on an axis
    else:
        _, scene = _scenes()
        scene = scene._replace(tris=type(scene.tris)(*(x[:7] for x in scene.tris)))
        bvh = build.build_bvh(scene.tris)
        assert bvh.nodes.shape[0] == 1
    _check_layout(bvh, scene.tris)
    o, d, t_min, t_max = rays = _aimed_rays(scene.tris, kind)
    t, prim, _, _ = traverse.bvh_closest_hit_plain(bvh, *rays)
    sweep = _sweep(scene, *rays)
    assert torch.equal(t, sweep.min(1).values)
    assert ((prim >= 0) == (t < BIG)).all() and 0.2 < (prim >= 0).float().mean() < 1
    seg = torch.minimum(t_max, torch.as_tensor(
        np.random.default_rng(4).uniform(0.1, 12.0, size=N), dtype=torch.float32))
    occ = traverse.bvh_any_hit_plain(bvh, o, d, t_min, seg)
    assert torch.equal(occ, _sweep(scene, o, d, t_min, seg).min(1).values < BIG)
    assert occ.any()


def test_wrappers_take_the_plain_version_on_cpu_and_check_inputs():
    _, scene = _scenes()
    rays = _rays("random")
    counts = dict(native.LAUNCHES)
    for a, b in zip(traverse.bvh_closest_hit(scene.bvh, *rays),
                    traverse.bvh_closest_hit_plain(scene.bvh, *rays)):
        assert torch.equal(a, b)
    assert torch.equal(traverse.bvh_any_hit(scene.bvh, *rays),
                       traverse.bvh_any_hit_plain(scene.bvh, *rays))
    assert native.LAUNCHES == counts           # no kernel ran
    o, d, t_min, t_max = rays
    with pytest.raises(ValueError):
        traverse.bvh_closest_hit(scene.bvh, o.double(), d, t_min, t_max)
    with pytest.raises(ValueError):
        traverse.bvh_any_hit(scene.bvh, o, d[:, ::2].contiguous(), t_min, t_max)
