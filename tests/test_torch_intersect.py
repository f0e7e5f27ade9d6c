"""Plain versions of K1 (closest hit), K2 (any hit) and K3 (hit assembly)
against the JAX package's brute-force intersector on the same rays.

Tolerances: prim ids must agree wherever the runner-up candidate is farther
than 1e-5 * t (closer pairs are ties up to f32 rounding: coplanar faces such
as the short box's bottom on the floor, and the JAX feature matmul sums in
another order). t/u/v on triangles: rtol 1e-5 with atol 1e-5, the absolute
floor being a few ulp of the largest matmul term (~8) over |det|, which a ray
starting next to a surface or meeting it at a grazing angle makes visible.
Sphere t: rtol 1e-4, since at the silhouette the discriminant cancels and the
square root amplifies its rounding. K3 fields: atol 1e-5.

The sphere-only rtiow scene is held to the JAX sphere test as the render
compiles it (the feature matrix a traced argument, so the dot stays one FMA
chain and the decode is fused): prim ids equal but for ties, t to rtol
1e-6 (1.4e-7 measured; 99.8 % of lanes bit-equal). The scene centre is the
JAX package's to the bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig, make_camera as jmake_camera
from wurblpt_tpu.core import rng as jrng
from wurblpt_tpu.render.camera import DistortionModel as JDistortionModel
from wurblpt_tpu.render.camera import camera_rays as jcamera_rays
from wurblpt_tpu.render.intersect import assemble_hit as jassemble_hit
from wurblpt_tpu.render.intersect_mxu import build_mxu_scene, mxu_any_hit, mxu_closest_hit
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import scene_from_numpy
from wurblpt_tpu_torch.render.intersect import assemble_hit, build_hit_tables
from wurblpt_tpu_torch.render.intersect_brute import (
    BIG,
    any_hit,
    build_brute_scene,
    candidate_t,
    closest_hit,
    scene_centre,
)

torch.set_num_threads(2)

SCENES = {   # (scene, its camera)
    "cornell_ref": (lambda: jscenes.cornell_box_ref().build(), jscenes.cornell_ref_camera),
    "cornell_sphere": (lambda: jscenes.cornell_box(short_object="sphere").build(),
                       jscenes.cornell_camera),
}


def _camera_rays(camera, n_side=48, ssqrt=2):
    pose, vfov = camera()
    cam = jmake_camera(transformation=pose, vfov_deg=vfov, width=n_side, height=n_side)
    n = n_side * n_side * ssqrt * ssqrt
    i = jnp.arange(n, dtype=jnp.int32)
    pix, s = i % (n_side * n_side), i // (n_side * n_side)
    uj = jrng.uniform2(pix, s, 0, jrng.Salt.PIXEL_JITTER)
    pxy = jnp.stack([(pix % n_side) + ((s % ssqrt) + uj[:, 0]) / ssqrt,
                     (pix // n_side) + ((s // ssqrt) + uj[:, 1]) / ssqrt], -1)
    o, d, _ = jcamera_rays(cam, JCameraConfig(), pxy, n_side, n_side, 0.0, 0.0,
                           jnp.zeros((n,)), jnp.zeros((n, 2)))
    t_max = np.full((n,), BIG, np.float32)
    return np.asarray(o), np.asarray(d), np.full((n,), 1e-4, np.float32), t_max


def _random_rays(camera, n=6000, seed=3):
    """Origins in and around the box, random directions; a third of the lanes
    get a finite t_max, a tenth are dead (t_max = 0)."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-1.2, -1.2, -1.2], [1.2, 2.2, 1.2], size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rs.uniform(size=n) < 0.33, rs.uniform(0.05, 2.5, size=n), BIG)
    t_max = np.where(rs.uniform(size=n) < 0.1, 0.0, t_max).astype(np.float32)
    return o, d, np.full((n,), 1e-4, np.float32), t_max


RAYS = {"camera": _camera_rays, "random": _random_rays}


def _setup(scene_name, ray_name):
    build, camera = SCENES[scene_name]
    jscene = build()
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")
    return jscene, scene, RAYS[ray_name](camera)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _unambiguous(bs, o, d, t_min, t_max):
    """Lanes whose runner-up candidate is farther than 1e-5 * t from the winner."""
    c = torch.sort(candidate_t(bs, o, d, t_min, t_max), 1).values
    best = c[:, 0]
    second = c[:, 1] if c.shape[1] > 1 else torch.full_like(best, BIG)
    return (second - best > 1e-5 * best) | (best >= BIG)


@pytest.mark.parametrize("ray_name", sorted(RAYS))
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_closest_hit_plain_matches_jax(scene_name, ray_name):
    jscene, scene, (o, d, t_min, t_max) = _setup(scene_name, ray_name)
    ms = build_mxu_scene(jscene)
    jt, jprim, ju, jv, _ = jax.jit(lambda *a: mxu_closest_hit(ms, *a))(o, d, t_min, t_max)
    jt, jprim, ju, jv = (np.asarray(x) for x in (jt, jprim, ju, jv))

    bs = build_brute_scene(scene)
    args = _t(o, d, t_min, t_max)
    t, prim, u, v = (x.numpy() for x in closest_hit(bs, *args))
    ok = _unambiguous(bs, *args).numpy()
    assert ok.mean() > 0.98
    np.testing.assert_array_equal(prim[ok], jprim[ok])
    tri = ok & (prim >= 0) & (prim < scene.n_tris)
    sph = ok & (prim >= scene.n_tris)
    assert tri.sum() > 0.3 * len(o)
    np.testing.assert_allclose(t[tri], jt[tri], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(u[tri], ju[tri], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v[tri], jv[tri], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t[sph], jt[sph], rtol=1e-4)
    assert (u[sph] == 0).all() and (v[sph] == 0).all()
    assert (t[prim < 0] == np.float32(BIG)).all() and (u[prim < 0] == 0).all()
    assert (prim[t_max == 0] == -1).all()
    if scene_name == "cornell_sphere" and ray_name == "camera":
        assert (prim == scene.n_tris).sum() > 100      # the sphere is seen


@pytest.mark.parametrize("ray_name", sorted(RAYS))
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_any_hit_plain_matches_jax(scene_name, ray_name):
    jscene, scene, (o, d, t_min, t_max) = _setup(scene_name, ray_name)
    if ray_name == "camera":  # shadow-ray-like bounds: short of half the first hit
        t_max = np.where(np.arange(len(o)) % 2 == 0, 1.5, 3.0).astype(np.float32)
    ms = build_mxu_scene(jscene)
    jocc = np.asarray(jax.jit(lambda *a: mxu_any_hit(ms, *a))(o, d, t_min, t_max))

    bs = build_brute_scene(scene)
    args = _t(o, d, t_min, t_max)
    occ = any_hit(bs, *args).numpy()
    near = torch.sort(candidate_t(bs, args[0], args[1], args[2],
                                  torch.full_like(args[3], BIG)), 1).values[:, 0].numpy()
    ok = (np.abs(near - t_max) > 1e-5 * t_max) | (near >= BIG)
    assert ok.mean() > 0.98 and 0.05 < occ.mean() < 0.95
    np.testing.assert_array_equal(occ[ok], jocc[ok])
    assert not occ[t_max == 0].any()


@pytest.mark.parametrize("ray_name", sorted(RAYS))
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_assemble_hit_plain_matches_jax(scene_name, ray_name):
    jscene, scene, (o, d, t_min, t_max) = _setup(scene_name, ray_name)
    ms = build_mxu_scene(jscene)
    jt, jprim, ju, jv, _ = jax.jit(lambda *a: mxu_closest_hit(ms, *a))(o, d, t_min, t_max)
    jhr = jax.jit(lambda *a: jassemble_hit(jscene, *a, ms=ms))(o, d, jt, jprim, ju, jv)

    ht = build_hit_tables(scene)
    hr = assemble_hit(ht, *_t(o, d, np.asarray(jt), np.asarray(jprim), np.asarray(ju),
                              np.asarray(jv)))
    for f in ("hit", "prim", "mat", "backside"):
        np.testing.assert_array_equal(getattr(hr, f).numpy(), np.asarray(getattr(jhr, f)), f)
    h = np.asarray(jhr.hit)
    for f in ("position", "normal", "geom_normal", "tangent", "uv"):
        np.testing.assert_allclose(getattr(hr, f).numpy()[h], np.asarray(getattr(jhr, f))[h],
                                   rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(np.linalg.norm(hr.tangent.numpy()[h], axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("name", ["cornell_ref", "cornell_sphere", "envmap", "rtiow"])
def test_scene_centre_is_the_jax_packages(name):
    jscene = {"envmap": lambda: jscenes.envmap_spheres(cube=True).build(),
              "rtiow": lambda: jscenes.rtiow().build()}.get(name, lambda: SCENES[name][0]())()
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")
    c = build_brute_scene(scene).center
    np.testing.assert_array_equal(np.float32(c), np.asarray(build_mxu_scene(jscene).center))
    for n in (100, 2048, 40000):      # two, three and four levels of the reduction
        rows = torch.from_numpy(np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32))
        np.testing.assert_array_equal(scene_centre(rows).numpy(),
                                      np.asarray(jax.jit(lambda x: x.mean(0))(rows.numpy())))


@functools.lru_cache(maxsize=None)
def _rtiow_rays(kind, n_side=48):
    if kind == "camera":   # the bench camera, OpenCV lens, 48 x 32 x 4
        cam = jmake_camera(transformation=jscenes_lookat((13.0, 2.0, 3.0)), vfov_deg=30.0,
                           width=n_side, height=32, dist_k=(-0.1, 0.02, 0.0, 0.0, 0.0, 0.0),
                           dist_p=(0.001, -0.001))
        n = n_side * 32 * 4
        pxy = np.random.default_rng(2).uniform(size=(n, 2)) * [n_side, 32]
        o, d, _ = jcamera_rays(cam, JCameraConfig(distortion=JDistortionModel.OPENCV,
                                                  undistort_iters=8),
                               jnp.asarray(pxy, jnp.float32), n_side, 32, 0.0, 0.0,
                               jnp.zeros((n,)), jnp.zeros((n, 2)))
        o, d = np.asarray(o), np.asarray(d)
        t_max = np.full((n,), BIG, np.float32)
    else:                  # from above and inside the sphere field, a tenth dead
        rs = np.random.default_rng(3)
        n = 6144
        o = rs.uniform([-6, 0.01, -4], [6, 2.5, 4], size=(n, 3)).astype(np.float32)
        d = rs.normal(size=(n, 3))
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
        t_max = np.where(rs.uniform(size=n) < 0.1, 0.0, BIG).astype(np.float32)
    return o, d, np.full((o.shape[0],), 1e-4, np.float32), t_max


def jscenes_lookat(eye):
    from wurblpt_tpu.core.transform import from_lookat

    return from_lookat(eye, (0.0, 0.0, 0.0))


@pytest.mark.parametrize("kind", ["camera", "random"])
def test_sphere_only_scene_matches_jax_as_the_render_compiles_it(kind):
    jscene = jscenes.rtiow().build()
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")
    assert scene.n_tris == 0 and scene.n_spheres == 40
    o, d, t_min, t_max = _rtiow_rays(kind)
    ms = build_mxu_scene(jscene)
    jt, jprim, ju, jv, _ = jax.jit(
        lambda feat, *a: mxu_closest_hit(ms._replace(feat=feat), *a))(ms.feat, o, d, t_min, t_max)
    jt, jprim = np.asarray(jt), np.asarray(jprim)

    bs = build_brute_scene(scene)
    args = _t(o, d, t_min, t_max)
    t, prim, u, v = (x.numpy() for x in closest_hit(bs, *args))
    ok = _unambiguous(bs, *args).numpy()
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(prim[ok], jprim[ok])
    hit = ok & (prim >= 0)
    assert hit.sum() > 0.3 * len(o) and (prim[hit] == 0).sum() > 100     # the ground is seen
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-6)
    assert (u == 0).all() and (v == 0).all() and (prim[t_max == 0] == -1).all()

    jocc = np.asarray(jax.jit(lambda feat, *a: mxu_any_hit(ms._replace(feat=feat), *a))(
        ms.feat, o, d, t_min, np.minimum(t_max, 2.0)))
    args[3] = torch.minimum(args[3], torch.tensor(2.0))
    occ = any_hit(bs, *args).numpy()
    near = torch.sort(candidate_t(bs, args[0], args[1], args[2], torch.full_like(args[3], BIG)),
                      1).values[:, 0].numpy()
    sure = (np.abs(near - args[3].numpy()) > 1e-5 * 2.0) | (near >= BIG)
    np.testing.assert_array_equal(occ[sure], jocc[sure])

    jhr = jax.jit(lambda *a: jassemble_hit(jscene, *a, ms=ms))(o, d, jt, jprim, np.asarray(ju),
                                                              np.asarray(jv))
    hr = assemble_hit(build_hit_tables(scene), *_t(o, d, jt, jprim, np.asarray(ju),
                                                   np.asarray(jv)))
    for f in ("hit", "prim", "mat", "backside"):
        np.testing.assert_array_equal(getattr(hr, f).numpy(), np.asarray(getattr(jhr, f)), f)
    h = np.asarray(jhr.hit)
    for f in ("position", "normal", "geom_normal", "tangent"):
        np.testing.assert_allclose(getattr(hr, f).numpy()[h], np.asarray(getattr(jhr, f))[h],
                                   rtol=0, atol=1e-5, err_msg=f)
    # Lat/long uv near the pole of the radius-1000 ground (its hits are within
    # 1e-2 of it): atan2 of components ~1e-3 turns their last bits into 1e-5.
    ground = h & (jprim == 0)
    for sel, atol in ((h & ~ground, 1e-5), (ground, 1e-4)):
        np.testing.assert_allclose(hr.uv.numpy()[sel], np.asarray(jhr.uv)[sel], rtol=0, atol=atol)
