"""The port's BVH (build, and the plain versions of K5/K6) against the JAX
package's BVH traversal and against a brute-force sweep of the same tests.

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
watertight test, t is equal on every lane.

The sphere rows and the object-space leaves on three scenes built by the
JAX package with use_bvh=True: cornell_box(short_object="sphere") (a
sphere beside triangles), rtiow(n=8) (68 spheres alone) and the animated
Cornell box with its two spheres (`jax_frame_reference.jax_cornell_animated`)
swept at t0 = t1 = 0.5, cast with the JAX package's object rays
(`anim_ctx.ray_to_object`) and the port's animation rows at t = 0.5. The
same tolerances: prim ids equal except at ties within 1e-5 t and, with
object rays, where the winner's barycentrics lie within 1e-5 of an edge
(XLA contracts the object ray's products into FMAs, C.4, so a ray grazing
an edge may fall on either side; under 2 % of the lanes are excused so);
where both packages pick the same primitive, t to rtol 1e-5 (atol 1e-6),
on a sphere also within the rounding of its quadratic (`_t_tolerance`: the
ground sphere's c = |oc|^2 - r^2 cancels, and XLA's FMAs move it by ulps
of 1e6), u and v to atol 1e-5; each walk's nearest t equal to a
brute-force sweep of the same tests on every lane but at ties and where
a sphere wins (there within rtol 1e-5: PyTorch's CPU sqrt rounds by the
input's place in the tensor), its occlusion equal to the sweep's. The port's swept
boxes equal the JAX flattener's `_swept_aabbs` boxes bit for bit."""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu.accel.traverse import bvh_any_hit as jbvh_any_hit
from wurblpt_tpu.accel.traverse import bvh_closest_hit as jbvh_closest_hit
from wurblpt_tpu.scene.animation import make_anim_ctx as jmake_anim_ctx
from wurblpt_tpu.scene.flatten import _swept_aabbs as jswept_aabbs
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import native
from wurblpt_tpu_torch.accel import build, traverse
from wurblpt_tpu_torch.core.transform import from_lookat
from wurblpt_tpu_torch.render.intersect import watertight_tri
from wurblpt_tpu_torch.render.intersect_brute import BIG
from wurblpt_tpu_torch.render.intersect_sweep import ray_sphere_tile
from wurblpt_tpu_torch.scene.animation import anim_frames, frames_ray_to_object
from wurblpt_tpu_torch.scene.flatten import MeshSpec, SphereSpec, flatten_meshes, material_table
from wurblpt_tpu_torch.scene.ir import MaterialType, anim_ids, scene_from_numpy
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import jax_frame_reference as jfr  # noqa: E402

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


def _check_layout(bvh, tris, spheres=None, boxes=None):
    """Every primitive sits in exactly one leaf of 1..LEAF_SIZE rows: a
    triangle's absolute vertices copied into a 48-byte row with the prim id
    in v0's pad, the animation id in v1's and a zero pad, a sphere's centre,
    prim id, radius and animation id; every child box holds its subtree's
    primitives (their own boxes, or `boxes` (lo, hi) by prim id: the swept
    ones); the depth is the tree's, within the stack."""
    n_sph = 0 if spheres is None else spheres.count
    assert (bvh.n_tris, bvh.n_spheres) == (tris.count, n_sph)
    assert sorted(bvh.prim_id.tolist()) == list(range(tris.count + n_sph))
    ids = bvh.prim_id.long()
    tv = bvh.prim_v
    assert tv.shape[1] == 12
    tri, sph = ids < tris.count, ids >= tris.count
    ti, si = ids[tri], ids[sph] - tris.count
    assert torch.equal(tv[tri, 0:3], tris.p0[ti]) and torch.equal(tv[tri, 4:7], tris.v1[ti])
    assert torch.equal(tv[tri, 8:11], tris.v2[ti]) and (tv[:, 11] == 0).all()
    aid = torch.cat([anim_ids(tris)] + ([anim_ids(spheres)] if n_sph else []))
    assert torch.equal(bvh.anim_id, aid[ids]) and bvh.n_anims == int(aid.max()) + 1
    if n_sph:
        assert torch.equal(tv[sph, 0:3], spheres.center[si])
        assert torch.equal(tv[sph, 4], spheres.radius[si]) and (tv[sph, 5:7] == 0).all()
        assert (tv[sph, 8:11] == 0).all()
    links = bvh.links
    if boxes is None:
        lo = torch.minimum(torch.minimum(tv[:, 0:3], tv[:, 4:7]), tv[:, 8:11])
        hi = torch.maximum(torch.maximum(tv[:, 0:3], tv[:, 4:7]), tv[:, 8:11])
        if n_sph:
            r = tv[sph, 4:5]
            lo[sph], hi[sph] = tv[sph, 0:3] - r, tv[sph, 0:3] + r
    else:
        lo, hi = (torch.as_tensor(b)[ids] for b in boxes)
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


# --- sphere rows and object-space leaves -----------------------------------

ANIM_T = 0.5


@functools.lru_cache(maxsize=None)
def _leaf_scenes(name):
    """(JAX scene, port scene, port camera (pose, vfov), random-ray box) of
    one of the three scenes with sphere rows or animated rows."""
    if name == "cornell sphere":
        js = jscenes.cornell_box(short_object="sphere").build(use_bvh=True)
        t0 = 0.0
        cam = (from_lookat((0.0, 0.0, 3.2), (0.0, 0.0, 0.0), device="cpu"), 50.0)
        box = ((-1.0, -1.0, -1.0), (1.0, 1.0, 3.0))
    elif name == "rtiow":
        js = jscenes.rtiow(n=8).build(use_bvh=True)
        t0 = 0.0
        cam = scenes.rtiow_camera("cpu")
        box = ((-6.0, 0.0, -6.0), (6.0, 2.5, 6.0))
    else:
        js = jfr.jax_cornell_animated(spheres=True, use_bvh=True, t=ANIM_T)
        t0 = ANIM_T
        cam = scenes.cornell_ref_camera("cpu")
        box = ((-1.0, 0.0, -1.0), (1.0, 2.0, 3.0))
    ps = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu", t0, t0)
    assert js.bvh is not None and ps.has_bvh
    return js, ps, cam, box


def _leaf_rays(name, kind):
    """Rays for the leaf tests: camera rays, random rays from `box`,
    axis-aligned ones, random ones with half the lanes dead; t_max BIG
    (closest hit: no finite t_max, C.3) or 0."""
    _, _, cam, (lo, hi) = _leaf_scenes(name)
    if kind == "camera":
        return kc.camera_lanes(32, 32, 1, "cpu", camera=cam)
    rs = np.random.default_rng({"random": 11, "axis": 12, "dead": 13}[kind])
    o = rs.uniform(lo, hi, size=(N, 3))
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


def _frames(ps):
    return anim_frames(ps.anims, ANIM_T) if ps.n_anims > 1 else None


def _jax_obj_rays(js, o, d):
    if int(js.anims.times.shape[0]) <= 1:
        return None
    ctx = jmake_anim_ctx(js.anims, jnp.full((o.shape[0],), jnp.float32(ANIM_T)))
    return ctx.ray_to_object(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))


def _sweep_all(ps, o, d, t_min, t_max, frames):
    """([N, P] hit distance of every ray/primitive pair (BIG if none) with the
    walk's own tests and object rays, [N, P] u, v of the triangle tests)."""
    T, S = ps.tris, ps.spheres
    n = o.shape[0]
    aid = torch.cat([anim_ids(T), anim_ids(S)])
    if frames is None:
        ox, dx = o[:, None].expand(n, aid.shape[0], 3), d[:, None].expand(n, aid.shape[0], 3)
    else:
        ox, dx, _ = frames_ray_to_object(frames, aid[None, :].expand(n, -1), o, d)
    nt = T.count
    t, u, v, _ = watertight_tri(ox[:, :nt], dx[:, :nt], T.p0[None], T.v1[None], T.v2[None],
                                t_min[:, None], t_max[:, None])
    ts, _ = ray_sphere_tile(ox[:, nt:], dx[:, nt:], S.center[None], S.radius[None], t_min, t_max,
                            bvh=True)
    zeros = torch.zeros_like(ts)
    return torch.cat([t, ts], 1), torch.cat([u, zeros], 1), torch.cat([v, zeros], 1)


LEAF_SCENES = ["cornell sphere", "rtiow", "animated cornell"]


def _t_tolerance(ps, rays, prim, t, frames):
    """Per lane, how far the JAX package's t may lie from the port's: rtol
    1e-5 and atol 1e-6 on a triangle; on a sphere also the rounding of its
    quadratic, 4 ulp of |oc|^2 + r^2 over |q| (the near root is c / q): XLA
    contracts the dots into FMAs (C.4), and the radius-1000 ground sphere's
    c = |oc|^2 - r^2 cancels, so an ulp of 1e6 there is a visible part of
    c close to the ground; and the discriminant's rounding through the
    root, large on a grazing ray."""
    tol = 1e-5 * np.abs(t) + 1e-6
    sph = prim >= ps.n_tris
    if not sph.any():
        return tol
    o, d = (x.numpy().astype(np.float64) for x in rays[:2])
    if frames is not None:   # the winner's object-space ray
        aid = anim_ids(ps.spheres)[torch.as_tensor(np.clip(prim - ps.n_tris, 0, None))]
        oa, da, _ = frames_ray_to_object(frames, aid, rays[0], rays[1])
        o, d = oa.numpy().astype(np.float64), da.numpy().astype(np.float64)
    si = np.clip(prim - ps.n_tris, 0, ps.n_spheres - 1)
    oc = o - ps.spheres.center.numpy()[si].astype(np.float64)
    r2 = ps.spheres.radius.numpy()[si].astype(np.float64) ** 2
    a, half_b = (d * d).sum(-1), (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - r2
    sq = np.sqrt(np.maximum(half_b * half_b - a * c, 1e-30))
    q = np.maximum(np.abs(half_b) + sq, 1e-30)
    eps = np.finfo(np.float32).eps
    # c's rounding, and the discriminant's through the root (a grazing ray's sq is small)
    quad = 4 * eps * ((oc * oc).sum(-1) + r2 + np.abs(t) * (half_b * half_b + np.abs(a * c))
                      / (2 * sq)) / q
    return np.where(sph, tol + quad, tol)


@pytest.mark.parametrize("name", LEAF_SCENES)
@pytest.mark.parametrize("kind", ["camera", "random", "axis", "dead"])
def test_sphere_and_object_space_leaves_match_jax_and_the_sweep(name, kind):
    js, ps, _, _ = _leaf_scenes(name)
    rays = _leaf_rays(name, kind)
    o, d, t_min, t_max = rays
    fr = _frames(ps)
    t, prim, u, v = (x.numpy() for x in traverse.bvh_closest_hit_plain(ps.bvh, *rays, fr))
    jt, jprim, ju, jv = (np.asarray(x) for x in jbvh_closest_hit(
        js, *(jnp.asarray(r.numpy()) for r in rays), obj_rays=_jax_obj_rays(js, o, d)))
    cand, cu, cv = (x.numpy() for x in _sweep_all(ps, *rays, fr))
    order = np.sort(cand, 1)
    hit = order[:, 0] < BIG
    tie = (order[:, 1] - order[:, 0] <= 1e-5 * order[:, 0]) & hit
    if fr is not None:   # XLA's object rays: a ray grazing an edge may fall on either side
        k = np.argmin(cand, 1)
        lanes = np.arange(cand.shape[0])
        bu, bv = cu[lanes, k], cv[lanes, k]
        tie |= hit & (k < ps.n_tris) & (np.minimum(np.minimum(bu, bv), 1.0 - bu - bv) <= 1e-5)
    np.testing.assert_array_equal(prim[~tie], jprim[~tie])
    assert tie.mean() < 0.02
    same = (prim == jprim) & (prim >= 0)
    np.testing.assert_array_less(np.abs(t - jt)[same], _t_tolerance(ps, rays, prim, t, fr)[same])
    np.testing.assert_allclose(u[same], ju[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v[same], jv[same], rtol=1e-5, atol=1e-5)
    sph = prim >= ps.n_tris
    # the sweep's nearest distance; on a sphere within an ulp: PyTorch's CPU
    # sqrt rounds an input by its position in the tensor (a vector kernel
    # that is not correctly rounded, a scalar tail that is); at a tie the
    # walk's bound may reject the runner-up an ulp nearer (its range test
    # compares tn with bound * det)
    exact = ~sph & ~tie
    np.testing.assert_array_equal(t[exact], order[exact, 0])
    np.testing.assert_allclose(t[~exact], order[~exact, 0], rtol=1e-5)
    assert (u[sph] == 0).all() and (v[sph] == 0).all()
    assert (prim >= 0).any() and (sph.any() or kind != "camera")
    dead = t_max.numpy() == 0.0
    assert (prim[dead] == -1).all() and (t[dead] == np.float32(BIG)).all()


@pytest.mark.parametrize("name", LEAF_SCENES)
@pytest.mark.parametrize("kind", ["random", "axis", "dead"])
def test_sphere_and_object_space_any_hit_matches_jax_and_the_sweep(name, kind):
    js, ps, _, _ = _leaf_scenes(name)
    o, d, t_min, t_max = _leaf_rays(name, kind)
    rs = np.random.default_rng(9)
    seg = np.where(rs.uniform(size=N) < 0.25, BIG, rs.uniform(0.05, 4.0, size=N))
    t_max = torch.minimum(t_max, torch.as_tensor(seg, dtype=torch.float32))
    rays = (o, d, t_min, t_max)
    fr = _frames(ps)
    occ = traverse.bvh_any_hit_plain(ps.bvh, *rays, fr).numpy()
    jocc = np.asarray(jbvh_any_hit(js, *(jnp.asarray(r.numpy()) for r in rays),
                                   obj_rays=_jax_obj_rays(js, o, d)))
    near = _sweep_all(ps, o, d, t_min, torch.full_like(t_max, BIG), fr)[0].min(1).values.numpy()
    clear = np.abs(near - t_max.numpy()) > 1e-5 * t_max.numpy()
    np.testing.assert_array_equal(occ[clear], jocc[clear])
    np.testing.assert_array_equal(occ, near < t_max.numpy())
    assert 0 < occ.sum() < N


def test_the_layout_of_sphere_and_animated_rows():
    """The three scenes' trees (see _check_layout); the animated one's child
    boxes hold the swept boxes."""
    for name in LEAF_SCENES:
        _, ps, _, _ = _leaf_scenes(name)
        boxes = None
        if ps.n_anims > 1:
            boxes = _port_swept_boxes(ps)
        _check_layout(ps.bvh, ps.tris, ps.spheres, boxes)


def _port_swept_boxes(ps):
    """The port's boxes of every primitive of an animated scene, the static
    ones included, as build_bvh makes them (the JAX flattener's inputs)."""
    T, S = ps.tris, ps.spheres
    p0, e1, e2 = (x.numpy() for x in (T.p0, T.e1, T.e2))
    lo, hi, _ = (np.concatenate(x) for x in zip(
        build.prim_aabbs(p0, p0 + e1, p0 + e2),
        build.sphere_aabbs(S.center.numpy(), S.radius.numpy())))
    aid = torch.cat([anim_ids(T), anim_ids(S)]).numpy()
    return build.swept_aabbs(lo, hi, aid, ps.anims, ANIM_T, ANIM_T)


@pytest.mark.parametrize("interval", [(ANIM_T, ANIM_T), (0.0, 1.0), (0.2, 0.7)])
def test_swept_boxes_equal_the_jax_flatteners(interval):
    """build.swept_aabbs against the JAX flattener's _swept_aabbs on the
    animated Cornell box with spheres, bit for bit, over the frame's instant
    and over intervals with and without key times inside."""
    from wurblpt_tpu.accel.build import prim_aabbs as jprim_aabbs

    _, ps, _, _ = _leaf_scenes("animated cornell")
    sc = _jax_anim_scene()
    T, S = ps.tris, ps.spheres
    tri_np = tuple(x.numpy() for x in (T.p0, T.e1, T.e2))
    amin, amax, _ = jprim_aabbs(tri_np, (S.center.numpy(), S.radius.numpy()))
    aid = torch.cat([anim_ids(T), anim_ids(S)]).numpy()
    want = jswept_aabbs(amin, amax, aid, sc, *interval)
    p0, e1, e2 = tri_np
    lo, hi, _ = (np.concatenate(x) for x in zip(
        build.prim_aabbs(p0, p0 + e1, p0 + e2),
        build.sphere_aabbs(S.center.numpy(), S.radius.numpy())))
    got = build.swept_aabbs(lo, hi, aid, ps.anims, *interval)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    moving = aid != 0
    assert moving.any() and (got[0][moving] != lo[moving]).all()


def _jax_anim_scene():
    """A JAX builder Scene holding the animated box's keyframes, as
    jax_cornell_animated takes them: what _swept_aabbs reads."""
    from wurblpt_tpu.core.transform import Transformation as JTransformation
    from wurblpt_tpu.scene import builder as B

    sc = B.Scene()
    for a in scenes.cornell_animations():
        sc.take_animation(B.AnimationKeyframes(list(a.times), [
            JTransformation.make(*(np.asarray(x) for x in tf)) for tf in a.transformations]))
    return sc


@pytest.mark.parametrize("n_spheres, bvh", [(511, False), (512, True)])
def test_use_bvh_none_follows_the_jax_rule(n_spheres, bvh):
    """flatten_meshes(use_bvh=None) builds a BVH from 512 primitives on, as
    the JAX flattener's auto rule; so does the JAX build of the same scene."""
    from wurblpt_tpu.scene import builder as B

    rs = np.random.default_rng(3)
    centers = rs.uniform(-5.0, 5.0, size=(n_spheres, 3)).astype(np.float32)
    quad = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    mesh = MeshSpec(quad, None, None, np.array([[0, 1, 2], [0, 2, 3]], np.int32), 0)
    rows = [(MaterialType.LAMBERTIAN, (0.5, 0.5, 0.5), None)]
    # 2 triangles + n - 2 spheres: n primitives in all
    sph = [SphereSpec(tuple(c), 0.1, 0) for c in centers[:n_spheres - 2]]
    ps = flatten_meshes([mesh], material_table(rows), "cpu", spheres=sph)
    js = B.Scene()
    m = js.take_material(B.Lambertian(albedo=(0.5, 0.5, 0.5)))
    js.take_mesh_instance(B.MeshInstance(B.Mesh(quad, None, None, indices=mesh.indices), m))
    for c in centers[:n_spheres - 2]:
        js.take_sphere(B.SphereObject(tuple(c), 0.1, m))
    jarr = js.build()
    assert ps.n_tris + ps.n_spheres == n_spheres == jarr.n_tris + jarr.n_spheres
    assert ps.has_bvh == bvh == (jarr.bvh is not None)
    if bvh:
        _check_layout(ps.bvh, ps.tris, ps.spheres)
