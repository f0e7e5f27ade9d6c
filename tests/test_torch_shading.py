"""Shading of the port against the JAX package on the same hits and uniforms:
bsdf_sample, bsdf_eval, emitted, lights_sample, lights_pdf_multi.

All inputs (the hit records of Cornell camera rays, the uniforms) are made
once and handed to both sides, so any difference is the port's arithmetic:
tolerances are f32 rounding (rtol 1e-5, atol 1e-6), except: pdfs, which
divide by |cos| * area, rtol 1e-4; sampled directions and the cosines taken
of them atol 1e-5, because XLA's and PyTorch's sin/cos differ by an ulp and
the cosine warp's z = sqrt(1 - x^2 - y^2) amplifies that near the horizon.

GGX and Mirror run on the hits of the mesh path's camera on the small
terrain_city, with materials drawn per lane from its table (Lambertian,
GGX, mirror). GGX values and pdfs to rtol 1e-4: the microfacet density
1/(pi a^2 (...)^2) of a roughness-0.1 lobe magnifies an ulp of the half
vector. ModPhong (the city's buildings, windows and mirrors) runs on hits of
random rays on spheres, from outside and inside, opaque and 40 % opaque
(the pass-through refraction with its total internal reflection), to rtol
1e-4: XLA's and PyTorch's pow differ in the last bit, and cos^40 magnifies
it."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig, SceneStatic as JSceneStatic
from wurblpt_tpu import make_camera as jmake_camera
from wurblpt_tpu.core.transform import from_lookat
from wurblpt_tpu.core.sampler import power_heuristic as jpower_heuristic
from wurblpt_tpu.render import bsdf as jbsdf
from wurblpt_tpu.render import lights as jlights
from wurblpt_tpu.render.camera import camera_rays as jcamera_rays
from wurblpt_tpu.render.intersect import assemble_hit as jassemble_hit
from wurblpt_tpu.render.intersect import scene_raw_hit as jscene_raw_hit
from wurblpt_tpu.render.intersect_mxu import build_mxu_scene, mxu_closest_hit
from wurblpt_tpu.core.transform import Transformation as JTransformation
from wurblpt_tpu.scene import builder as B
from wurblpt_tpu.scene import generator as JG
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import scene_from_numpy
from wurblpt_tpu_torch.core.sampler import power_heuristic
from wurblpt_tpu_torch.render import bsdf, lights
from wurblpt_tpu_torch.render.intersect import HitRecord

torch.set_num_threads(2)

N_SIDE = 40


@functools.lru_cache(maxsize=None)
def _case(light_sampling="power"):
    """JAX scene, port scene, JAX hit record of 4 samples per pixel, uniforms."""
    jscene = jscenes.cornell_box_ref().build(light_sampling=light_sampling)
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")
    pose, vfov = jscenes.cornell_ref_camera()
    cam = jmake_camera(transformation=pose, vfov_deg=vfov, width=N_SIDE, height=N_SIDE)
    rs = np.random.default_rng(11)
    n = 4 * N_SIDE * N_SIDE
    pix = np.arange(n) % (N_SIDE * N_SIDE)
    pxy = np.stack([pix % N_SIDE, pix // N_SIDE], -1) + rs.uniform(size=(n, 2))
    o, d, _ = jcamera_rays(cam, JCameraConfig(), jnp.asarray(pxy, jnp.float32), N_SIDE,
                           N_SIDE, 0.0, 0.0, jnp.zeros((n,)), jnp.zeros((n, 2)))
    ms = build_mxu_scene(jscene)
    t_min = jnp.full((n,), 1e-4)
    t, prim, u, v, _ = mxu_closest_hit(ms, o, d, t_min, jnp.full((n,), 3e37))
    jhr = jassemble_hit(jscene, o, d, t, prim, u, v, ms=ms)
    uni = rs.uniform(size=(n, 4)).astype(np.float32)
    return jscene, scene, d, jhr, uni


def _port_hr(jhr):
    return HitRecord(*(torch.from_numpy(np.array(x)) for x in jhr))


def _mrow(scene, hr):
    return bsdf.gather_material_rows(bsdf.pack_material_table(scene.materials), hr.mat.long())


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


def test_hits_cover_walls_boxes_and_the_light():
    _, scene, _, jhr, _ = _case()
    prims = set(np.asarray(jhr.prim).tolist())
    assert {34, 35} <= prims and len(prims) > 20 and np.asarray(jhr.hit).mean() > 0.5


def test_emitted_matches():
    jscene, scene, d, jhr, _ = _case()
    hr = _port_hr(jhr)
    je = jbsdf.emitted(jscene, JSceneStatic.from_scene(jscene), jhr, -d)
    e = bsdf.emitted(hr, -torch.from_numpy(np.array(d)), _mrow(scene, hr))
    _close(e, je)
    assert float(e.max()) == 4.0


def test_bsdf_sample_matches():
    jscene, scene, d, jhr, uni = _case()
    hr = _port_hr(jhr)
    n = uni.shape[0]
    ior = np.ones((n, 4), np.float32)
    js = jbsdf.bsdf_sample(jscene, JSceneStatic.from_scene(jscene), jhr, d, jnp.asarray(ior),
                           jnp.asarray(uni), jnp.asarray(uni[:, 2]), jnp.asarray(uni[:, 3]))
    ts = bsdf.bsdf_sample(hr, torch.from_numpy(np.array(d)), torch.from_numpy(ior),
                          torch.from_numpy(uni), torch.from_numpy(uni[:, 2]),
                          torch.from_numpy(uni[:, 3]), _mrow(scene, hr))
    np.testing.assert_array_equal(ts.kind.numpy(), np.asarray(js.kind))
    _close(ts.direction, js.direction, atol=1e-5)
    _close(ts.atten, js.atten, atol=1e-5)
    _close(ts.pdf, js.pdf, atol=1e-5)
    _close(ts.ior, js.ior)


def test_bsdf_eval_matches():
    jscene, scene, d, jhr, uni = _case()
    hr = _port_hr(jhr)
    wd = uni[:, :3] * 2.0 - 1.0
    wd /= np.linalg.norm(wd, axis=-1, keepdims=True)
    jf, jp = jbsdf.bsdf_eval(jscene, JSceneStatic.from_scene(jscene), jhr, d, jnp.asarray(wd))
    f, p = bsdf.bsdf_eval(hr, torch.from_numpy(np.array(d)), torch.from_numpy(wd),
                          _mrow(scene, hr))
    _close(f, jf)
    _close(p, jp)
    assert float((p > 0).float().mean()) > 0.2


@pytest.mark.parametrize("light_sampling", ["power", "uniform"])
def test_lights_sample_and_mixture_pdf_match(light_sampling):
    jscene, scene, _, jhr, uni = _case(light_sampling)
    origin = np.array(jhr.position)
    jd, jlp, jdist, jpick, jpdf = jlights.lights_sample(jscene, jnp.asarray(origin),
                                                        jnp.asarray(uni[:, :3]))
    td, tlp, tdist, tpick, tpdf = lights.lights_sample(scene, torch.from_numpy(origin),
                                                       torch.from_numpy(uni[:, :3]))
    np.testing.assert_array_equal(tpick.numpy(), np.asarray(jpick))
    np.testing.assert_array_equal(tlp.numpy(), np.asarray(jlp))
    _close(td, jd)
    _close(tdist, jdist)
    _close(tpdf, jpdf, rtol=1e-4)

    # Mixture pdf of (NEE direction, a second direction) from the hit points.
    other = np.roll(np.asarray(jd), 1, axis=0)
    dirs = np.stack([np.asarray(jd), other], 1)
    jm = jlights.lights_pdf_multi(jscene, jnp.asarray(origin), jnp.asarray(dirs))
    tm = lights.lights_pdf_multi(scene, torch.from_numpy(origin), torch.from_numpy(dirs))
    _close(tm, jm, rtol=1e-4)
    assert float((tm[:, 0] > 0).float().mean()) > 0.9

    picks = torch.from_numpy(np.array(jpick))
    _close(lights.light_pick_prob_of(scene, picks),
           jlights.light_pick_prob_of(jscene, jnp.asarray(jpick)))


def test_power_heuristic_matches():
    rs = np.random.default_rng(5)
    a, b = (rs.exponential(size=256).astype(np.float32) * (rs.uniform(size=256) > 0.2)
            for _ in range(2))
    _close(power_heuristic(torch.from_numpy(a), torch.from_numpy(b)),
           jpower_heuristic(jnp.asarray(a), jnp.asarray(b)))


@functools.lru_cache(maxsize=None)
def _mesh_case():
    """Small terrain_city: JAX scene, port scene, JAX hits of camera rays with
    a material per lane drawn from the table, uniforms, directions."""
    jscene = jscenes.terrain_city(seed=3, terrain_res=24, n_buildings=8,
                                  sphere_slices=6).build(use_bvh=True)
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")
    cam = jmake_camera(transformation=from_lookat((14.0, 9.0, 14.0), (0.0, 0.5, 0.0)),
                       vfov_deg=45.0, width=N_SIDE, height=N_SIDE)
    rs = np.random.default_rng(12)
    n = N_SIDE * N_SIDE
    pxy = np.stack([np.arange(n) % N_SIDE, np.arange(n) // N_SIDE], -1) + rs.uniform(size=(n, 2))
    o, d, _ = jcamera_rays(cam, JCameraConfig(), jnp.asarray(pxy, jnp.float32), N_SIDE,
                           N_SIDE, 0.0, 0.0, jnp.zeros((n,)), jnp.zeros((n, 2)))
    cast = jax.jit(lambda s, o, d: jassemble_hit(s, o, d, *jscene_raw_hit(
        s, o, d, jnp.full((n,), 1e-4), jnp.full((n,), 3e37))))
    jhr = cast(jscene, o, d)
    mats = rs.integers(0, int(np.asarray(jscene.materials.typ).shape[0]), n).astype(np.int32)
    jhr = jhr._replace(mat=jnp.where(jhr.hit, jnp.asarray(mats), 0))
    uni = rs.uniform(size=(n, 4)).astype(np.float32)
    wd = rs.normal(size=(n, 3))
    wd = (wd / np.linalg.norm(wd, axis=-1, keepdims=True)).astype(np.float32)
    return jscene, scene, d, jhr, uni, wd


def test_ggx_and_mirror_sample_match():
    jscene, scene, d, jhr, uni, _ = _mesh_case()
    static = JSceneStatic.from_scene(jscene)
    assert static.mat_types == {1, 2, 4}
    hr = _port_hr(jhr)
    typ = np.asarray(jscene.materials.typ)[np.asarray(jhr.mat)] * np.asarray(jhr.hit)
    assert (typ == 2).sum() > 100 and (typ == 4).sum() > 20
    n = uni.shape[0]
    ior = np.ones((n, 4), np.float32)
    js = jbsdf.bsdf_sample(jscene, static, jhr, d, jnp.asarray(ior), jnp.asarray(uni),
                           jnp.asarray(uni[:, 2]), jnp.asarray(uni[:, 3]))
    ts = bsdf.bsdf_sample(hr, torch.from_numpy(np.array(d)), torch.from_numpy(ior),
                          torch.from_numpy(uni), torch.from_numpy(uni[:, 2]),
                          torch.from_numpy(uni[:, 3]), _mrow(scene, hr), static.mat_types)
    np.testing.assert_array_equal(ts.kind.numpy(), np.asarray(js.kind))
    assert (ts.kind.numpy()[typ == 4] == bsdf.ScatterKind.EXPLICIT).all()
    _close(ts.direction, js.direction, atol=1e-5)
    _close(ts.atten, js.atten, rtol=1e-4, atol=1e-5)
    _close(ts.pdf, js.pdf, rtol=1e-4, atol=1e-5)
    _close(ts.ior, js.ior)


def test_ggx_and_mirror_eval_match():
    jscene, scene, d, jhr, _, wd = _mesh_case()
    static = JSceneStatic.from_scene(jscene)
    hr = _port_hr(jhr)
    jf, jp = jbsdf.bsdf_eval(jscene, static, jhr, d, jnp.asarray(wd))
    f, p = bsdf.bsdf_eval(hr, torch.from_numpy(np.array(d)), torch.from_numpy(wd),
                          _mrow(scene, hr), static.mat_types)
    _close(f, jf, rtol=1e-4, atol=1e-5)
    _close(p, jp, rtol=1e-4, atol=1e-5)
    typ = np.asarray(jscene.materials.typ)[np.asarray(jhr.mat)] * np.asarray(jhr.hit)
    assert (p.numpy()[typ == 2] > 0).mean() > 0.2 and (p.numpy()[typ == 4] == 0).all()


@functools.lru_cache(maxsize=None)
def _modphong_case():
    """Tessellated spheres of ModPhong materials (opaque and shiny; 40 %
    opaque with ior 1.5 and a transmissive colour; emissive), hit from
    outside and inside: hits with per-lane ModPhong materials, uniforms."""
    sc = B.Scene()
    mats = [B.ModPhong(diffuse=(0.6, 0.5, 0.4), specular=(0.3, 0.3, 0.3), shininess=40.0),
            B.ModPhong(diffuse=(0.2, 0.6, 0.3), specular=(0.1, 0.2, 0.1), shininess=5.0,
                       opacity=0.4, ior=1.5, transmissive=(0.9, 0.8, 0.7)),
            B.ModPhong(diffuse=(0.8, 0.8, 0.8), emissive=(5.0, 4.0, 3.0))]
    for i, m in enumerate(mats):
        sc.take_mesh_instance(B.MeshInstance(
            JG.generate_sphere(1.0, slices=16, stacks=12), sc.take_material(m),
            JTransformation.make(translation=(3.0 * i - 3.0, 0.0, 0.0))))
    jscene = sc.build(use_bvh=True)
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")
    rs = np.random.default_rng(13)
    n = 4096
    o = np.stack([rs.uniform(-5, 5, n), rs.uniform(-2, 2, n), rs.uniform(-2, 2, n)], -1)
    inside = rs.uniform(size=n) < 0.3
    o[inside] = np.array([[-3.0, 0, 0], [0, 0, 0], [3.0, 0, 0]])[rs.integers(0, 3, inside.sum())]
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
    jhr = jassemble_hit(jscene, o, d, *jscene_raw_hit(jscene, o, d, jnp.full((n,), 1e-4),
                                                      jnp.full((n,), 3e37)))
    jhr = jhr._replace(mat=jnp.where(jhr.hit, jnp.asarray(rs.integers(0, 3, n), jnp.int32), 0))
    uni = rs.uniform(size=(n, 4)).astype(np.float32)
    wd = rs.normal(size=(n, 3))
    return jscene, scene, d, jhr, uni, (wd / np.linalg.norm(wd, axis=-1, keepdims=True)).astype(
        np.float32)


def test_modphong_sample_matches_including_pass_through():
    jscene, scene, d, jhr, uni, _ = _modphong_case()
    static = JSceneStatic.from_scene(jscene)
    assert static.mat_types == {5}
    hr = _port_hr(jhr)
    n = uni.shape[0]
    ior = np.ones((n, 4), np.float32)
    js = jbsdf.bsdf_sample(jscene, static, jhr, d, jnp.asarray(ior), jnp.asarray(uni),
                           jnp.asarray(uni[:, 2]), jnp.asarray(uni[:, 3]))
    ts = bsdf.bsdf_sample(hr, torch.from_numpy(np.array(d)), torch.from_numpy(ior),
                          torch.from_numpy(uni), torch.from_numpy(uni[:, 2]),
                          torch.from_numpy(uni[:, 3]), _mrow(scene, hr), static.mat_types)
    kind = ts.kind.numpy()
    np.testing.assert_array_equal(kind, np.asarray(js.kind))
    hit = np.asarray(jhr.hit)
    # pass-through refractions, absorbed backsides and total internal reflection all occur
    assert (kind[hit] == bsdf.ScatterKind.EXPLICIT).sum() > 100
    assert (kind[hit] == bsdf.ScatterKind.NONE).sum() > 100
    assert (np.asarray(jhr.backside) & hit).sum() > 300
    _close(ts.direction, js.direction, atol=1e-5)
    _close(ts.atten, js.atten, rtol=1e-4, atol=1e-5)
    _close(ts.pdf, js.pdf, rtol=1e-4, atol=1e-5)
    _close(ts.ior, js.ior)
    assert float(ts.ior.max()) == 1.5


def test_modphong_eval_and_emitted_match():
    jscene, scene, d, jhr, _, wd = _modphong_case()
    static = JSceneStatic.from_scene(jscene)
    hr = _port_hr(jhr)
    jf, jp = jbsdf.bsdf_eval(jscene, static, jhr, d, jnp.asarray(wd))
    mrow = _mrow(scene, hr)
    f, p = bsdf.bsdf_eval(hr, torch.from_numpy(np.array(d)), torch.from_numpy(wd), mrow,
                          static.mat_types)
    _close(f, jf, rtol=1e-4, atol=1e-5)
    _close(p, jp, rtol=1e-4, atol=1e-5)
    assert float((p > 0).float().mean()) > 0.2
    je = jbsdf.emitted(jscene, static, jhr, -d)
    e = bsdf.emitted(hr, -torch.from_numpy(np.array(d)), mrow)
    _close(e, je)
    assert float(e.max()) == 5.0
