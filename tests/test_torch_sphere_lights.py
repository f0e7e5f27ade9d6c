"""Sphere hot spots (the first half of ROADMAP A.5) against the JAX package.

The light functions with sphere lights (cone sampling, the cone's pdf in
the mixture and at a hit, the emission at the sampled point) on random
origins, and renders: the scenes of the JAX package's
tests/test_inverse.py:18-26 (a quad under a sphere light, built by the
port's flattener bit for bit as the JAX builder builds it) and
tests/test_gradients.py:113-150 (the edge-free floor) through the pass
renderer, and the Veach MIS scene (four sphere lights over glossy plates,
brute force and in a BVH) and a scene of eight sphere lights (per-light
MIS) through the wavefront renderer, whose generic bounce takes them. Bars
of tests/test_torch_integrator.py: equal counters (0.5 % on the sphere
scenes of the wavefront), 99 % of pixels to rtol 1e-3, the mean to 1e-4
relative (1e-3 where the scene's casts part on spheres)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig, RenderParams as JRenderParams
from wurblpt_tpu import SceneStatic as JSceneStatic, SensorRGB as JSensorRGB
from wurblpt_tpu import make_camera as jmake_camera
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
from wurblpt_tpu.render import lights as jlights
from wurblpt_tpu.render.integrator import render_frame as jrender_frame
from wurblpt_tpu.render.integrator import render_frame_wavefront as jrender_wavefront
from wurblpt_tpu.scene import builder as B
from wurblpt_tpu.scene.generator import generate_quad
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import (CameraConfig, RenderParams, SceneStatic, SensorRGB, render_frame,
                               render_frame_wavefront, scene_from_numpy)
from wurblpt_tpu_torch.render import lights
from wurblpt_tpu_torch.render.camera import camera_from_numpy
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)


def _port(js):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")


def _cam(jcam):
    return camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam), "cpu")


def _jax_quad(albedo=(0.3, 0.6, 0.4)):
    sc = B.Scene()
    sc.take_mesh_instance(B.MeshInstance(mesh=generate_quad(1.5, 1.5),
                                         material=B.Lambertian(albedo=albedo)))
    sc.take_sphere(B.SphereObject((0.6, 1.0, 2.4), 0.3, B.LightDiffuse(radiance=(16.0,) * 3)),
                   hot_spot=True)
    return sc.build()


def _ring_of_lights(n=8):
    """A Lambertian quad under n small sphere lights of different power on a
    ring: per-light MIS (n >= 8)."""
    sc = B.Scene()
    sc.take_mesh_instance(B.MeshInstance(mesh=generate_quad(2.0, 2.0),
                                         material=B.Lambertian(albedo=(0.6, 0.6, 0.6))))
    for i in range(n):
        a = 2.0 * np.pi * i / n
        sc.take_sphere(B.SphereObject((1.2 * np.cos(a), 1.2 * np.sin(a), 1.0 + 0.1 * i),
                                      0.05 + 0.02 * i,
                                      B.LightDiffuse(radiance=(4.0 + i,) * 3)), hot_spot=True)
    return sc.build()


def test_port_builds_the_lit_scenes_as_the_jax_builder_does():
    """scenes.lit_quad and scenes.sphere_lit_floor (sphere hot spots in the
    port's flattener) equal the JAX builds field by field."""
    from test_torch_gradients import _floor_scene

    for js, ps in ((_jax_quad(), scenes.lit_quad(device="cpu")),
                   (_floor_scene(), scenes.sphere_lit_floor("cpu"))):
        ref = _port(js)
        for f in ("p0", "e1", "e2", "n0", "v1", "v2"):
            assert torch.equal(getattr(ps.tris, f), getattr(ref.tris, f)), f
        assert torch.equal(ps.spheres.center, ref.spheres.center)
        assert torch.equal(ps.spheres.radius, ref.spheres.radius)
        for f in ("light_prims", "light_weights", "light_alias_prob", "light_alias_idx",
                  "prim_light_pick", "prim_inv_area"):
            assert torch.equal(getattr(ps, f), getattr(ref, f)), f
        for f in ("typ", "albedo", "emissive", "p0", "flags"):
            assert torch.equal(getattr(ps.materials, f), getattr(ref.materials, f)), f


@pytest.mark.parametrize("build", [jscenes.mis_test, _ring_of_lights], ids=["mis", "ring"])
def test_light_sampling_and_pdfs_match_jax(build):
    """lights_sample (direction, prim, distance, pick, pdf), the mixture pdf
    of two directions and, with the ring's per-prim rows, lights_pdf_at_hit
    of a hit on each light, from 2048 random origins: directions rtol 1e-5,
    the cone's distance 1e-4 (a quadratic's near root), the pdfs 1e-3 (a
    small, far sphere's solid angle 2 pi (1 - cos_max) loses the digits
    that cos_max shares with 1: 2.5e-4 seen on 3 of 2048 lanes). The JAX
    pdfs are jitted (one compile, not one per op); the sample stays eager,
    op for op the port's (jitted, XLA's fusion moves the near root by up
    to 3.6e-4)."""
    js = build() if build is _ring_of_lights else build().build()
    ps = _port(js)
    rng = np.random.default_rng(3)
    n = 2048
    origin = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32) * [2.0, 0.5, 2.0]
    origin[:, 1] += 0.2 if build is _ring_of_lights else 0.0
    origin = origin.astype(np.float32)
    u3 = rng.uniform(size=(n, 3)).astype(np.float32)
    ref = jlights.lights_sample(js, jnp.asarray(origin), jnp.asarray(u3))
    got = lights.lights_sample(ps, torch.as_tensor(origin), torch.as_tensor(u3))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=1e-3)
    dirs = np.stack([np.asarray(ref[0]), -np.asarray(ref[0])], 1)
    np.testing.assert_allclose(
        lights.lights_pdf_multi(ps, torch.as_tensor(origin), torch.as_tensor(dirs)).numpy(),
        np.asarray(jax.jit(lambda o, d: jlights.lights_pdf_multi(js, o, d))(
            jnp.asarray(origin), jnp.asarray(dirs))),
        rtol=1e-3, atol=1e-7)
    if build is _ring_of_lights:
        prim, dist, d = got[1], got[2], got[0]
        gn = -d   # a sphere's pdf needs no normal
        pdf = lights.lights_pdf_at_hit(lights.pick_area_table(ps), d, dist, prim, gn, ps,
                                       torch.as_tensor(origin))
        jpdf = jax.jit(lambda *a: jlights.lights_pdf_at_hit(js, *a))(
            jnp.asarray(origin), jnp.asarray(d.numpy()), jnp.asarray(dist.numpy()),
            jnp.asarray(prim.numpy()), jnp.asarray(gn.numpy()))
        np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-3)
        assert float(pdf.min()) > 0.0


def _compare(img, stats, jimg, jstats, mean_rtol=1e-4, stats_rtol=0.0):
    img, jimg = img.numpy(), np.asarray(jimg)
    assert np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_allclose(stats.numpy(), np.asarray(jstats), rtol=stats_rtol)
    close = np.isclose(img, jimg, rtol=1e-3, atol=1e-7).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() - jimg.mean()) <= mean_rtol * jimg.mean()


@pytest.mark.parametrize("case", ["quad", "floor"])
def test_pass_renderer_matches_jax_under_a_sphere_light(case):
    """The JAX inverse test's quad (24 x 24, 4 spp, 2 path components) and
    the gradient test's floor (12 x 12, 4 spp, 4) through render_frame."""
    from test_torch_gradients import _floor_scene

    if case == "quad":
        js, w, depth = _jax_quad(), 24, 2
        jcam = jmake_camera(transformation=jfrom_lookat((0, 0, 2.4), (0, 0, 0)), vfov_deg=45.0,
                            width=w, height=w)
    else:
        js, w, depth = _floor_scene(), 12, 4
        jcam = jmake_camera(transformation=jfrom_lookat((0.0, 2.0, 0.01), (0.0, 0.0, 0.0)),
                            vfov_deg=50.0, width=w, height=w)
    jimg, jstats = jrender_frame(js, JSceneStatic.from_scene(js), jcam, JCameraConfig(),
                                 JSensorRGB(), w, w, 2,
                                 params=JRenderParams(max_path_components=depth),
                                 return_stats=True)
    ps = _port(js)
    img, stats = render_frame(ps, SceneStatic.from_scene(ps), _cam(jcam), CameraConfig(),
                              SensorRGB(), w, w, 2, params=RenderParams(max_path_components=depth),
                              return_stats=True, device="cpu")
    _compare(img, stats, jimg, jstats)


@pytest.mark.parametrize("case", ["mis", "mis_bvh", "ring"])
def test_wavefront_renders_sphere_lights_as_jax_does(case):
    """The Veach MIS scene (brute force and in a BVH: the scenes
    SceneStatic.check_slice refused before) and the ring of eight sphere
    lights (per-light MIS) through render_frame_wavefront's generic bounce,
    24 x 16, 1 spp, 4 path components."""
    if case == "ring":
        js = _ring_of_lights()
        eye, center = (0.0, -2.0, 3.0), (0.0, 0.0, 0.5)
    else:
        js = jscenes.mis_test().build(use_bvh=case == "mis_bvh")
        eye, center = (0.0, 1.0, 4.0), (0.0, -0.5, -1.0)
    w, h = 24, 16
    jcam = jmake_camera(transformation=jfrom_lookat(eye, center), vfov_deg=50.0, width=w,
                        height=h)
    jimg, jstats = jrender_wavefront(js, JSceneStatic.from_scene(js), jcam, JCameraConfig(),
                                     JSensorRGB(), w, h, 1,
                                     params=JRenderParams(max_path_components=4),
                                     return_stats=True)
    ps = _port(js)
    static = SceneStatic.from_scene(ps)
    assert static.sphere_lights and static.per_light_mis == (case == "ring")
    static.check_slice()
    img, stats = render_frame_wavefront(ps, static, _cam(jcam), CameraConfig(), SensorRGB(), w,
                                        h, 1, params=RenderParams(max_path_components=4),
                                        return_stats=True, device="cpu")
    _compare(img, stats, jimg, jstats, mean_rtol=1e-3, stats_rtol=5e-3)
