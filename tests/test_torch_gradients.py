"""The port's differentiable render against the JAX package's gradients.

The JAX package's gradient tests of tests/test_gradients.py (those of
tests/test_gradients_breadth.py that need no texture and no RGL table are
in tests/test_torch_gradients_breadth.py), on the same
scenes carried across with `scene_from_numpy` and the same losses: each
port gradient (autograd through `render_frame` with
`RenderParams(differentiable=True)`, P0T, K3T and K8T's plain versions on
the CPU) is held to `jax.grad` of the same loss, and to the port's own
central difference at the JAX test's tolerance. Both draw the same
counter-based random numbers, so the two renders take the same paths and
their gradients agree to float rounding: rtol 1e-3, 2e-3 on the sphere
scenes of the breadth cases, where a few paths part between XLA's jitted
and eager casts of the same sphere (tests/test_torch_integrator.py), which
moves JAX's own gradient by ~1.5e-3. The JAX side is computed once per
case (a module fixture), jitted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig, RenderParams as JRenderParams
from wurblpt_tpu import SceneStatic as JSceneStatic, SensorRGB as JSensorRGB
from wurblpt_tpu import make_camera as jmake_camera
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
from wurblpt_tpu.core.transform import Transformation as JTransformation
from wurblpt_tpu.core.transform import quat_from_axis_angle as jquat_from_axis_angle
from wurblpt_tpu.render.integrator import render_frame as jrender_frame
from wurblpt_tpu.scene import builder as B
from wurblpt_tpu.scene import generator as JG
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import (CameraConfig, RenderParams, SceneStatic, SensorRGB, render_frame,
                               scene_from_numpy)
from wurblpt_tpu_torch.render.camera import camera_from_numpy

torch.set_num_threads(2)


def _port(jscene):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")


def _cam(jcam):
    return camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam), "cpu")


class Case:
    """A gradient test: the JAX loss and the port's, of one scalar at x0,
    the FD step and the JAX test's FD tolerance."""

    def __init__(self, jloss, loss, x0, eps, fd_rtol, fd_atol=0.0, rtol=1e-3):
        self.jloss, self.loss, self.x0, self.eps = jloss, loss, x0, eps
        self.fd_rtol, self.fd_atol, self.rtol = fd_rtol, fd_atol, rtol


def _furnace():
    js = jscenes.furnace(albedo=0.5, env_radiance=1.0).build()
    w = h = 16
    jcam = jmake_camera(transformation=jfrom_lookat((0, 0, 4), (0, 0, 0)), vfov_deg=30,
                        width=w, height=h)
    jp = JRenderParams(max_path_components=4, differentiable=True,
                       randomize_ray_over_pixel=False)
    jstatic = JSceneStatic.from_scene(js)

    def jloss(a):
        sc = js._replace(materials=js.materials._replace(
            albedo=jnp.full_like(js.materials.albedo, a)))
        img = jrender_frame(sc, jstatic, jcam, JCameraConfig(), JSensorRGB(), w, h, 2, params=jp)
        return jnp.mean(img[6:10, 6:10])

    ps, cam = _port(js), _cam(jcam)
    static = SceneStatic.from_scene(ps)
    p = RenderParams(max_path_components=4, differentiable=True, randomize_ray_over_pixel=False)

    def loss(a):
        m = ps.materials
        sc = ps._replace(materials=m._replace(albedo=torch.zeros_like(m.albedo) + a))
        img = render_frame(sc, static, cam, CameraConfig(), SensorRGB(), w, h, 2, params=p,
                           device="cpu")
        return img[6:10, 6:10].mean()

    return Case(jloss, loss, 0.5, 1e-2, 2e-2)


PARAMS4 = RenderParams(max_path_components=4, differentiable=True)
JPARAMS4 = JRenderParams(max_path_components=4, differentiable=True)


def _cornell(patch, jpatch, x0, eps, fd_rtol):
    js = jscenes.cornell_box_ref().build()
    pose, vfov = jscenes.cornell_ref_camera()
    w = h = 24
    jcam = jmake_camera(transformation=pose, vfov_deg=vfov, width=w, height=h)
    jstatic = JSceneStatic.from_scene(js)

    def jloss(s):
        img = jrender_frame(jpatch(js, s), jstatic, jcam, JCameraConfig(), JSensorRGB(), w, h,
                            2, params=JPARAMS4)
        return jnp.mean(img)

    ps, cam = _port(js), _cam(jcam)
    static = SceneStatic.from_scene(ps)

    def loss(s):
        return render_frame(patch(ps, s), static, cam, CameraConfig(), SensorRGB(), w, h, 2,
                            params=PARAMS4, device="cpu").mean()

    return Case(jloss, loss, x0, eps, fd_rtol)


def _emissive():
    def jpatch(js, s):
        return js._replace(materials=js.materials._replace(emissive=js.materials.emissive * s))

    def patch(ps, s):
        return ps._replace(materials=ps.materials._replace(emissive=ps.materials.emissive * s))

    return _cornell(patch, jpatch, 1.0, 1e-2, 1e-3)


def _wall_albedo():
    def jpatch(js, s):
        sel = jnp.zeros_like(js.materials.albedo).at[0, :3].set(1.0)
        return js._replace(materials=js.materials._replace(albedo=js.materials.albedo + sel * s))

    def patch(ps, s):
        sel = torch.zeros_like(ps.materials.albedo)
        sel[0, :3] = 1.0
        return ps._replace(materials=ps.materials._replace(albedo=ps.materials.albedo + sel * s))

    return _cornell(patch, jpatch, 0.0, 5e-3, 5e-2)


def _floor_scene():
    scene = B.Scene()
    floor = scene.take_material(B.Lambertian(albedo=(0.6, 0.5, 0.4)))
    tf = JTransformation.make(rotation=jquat_from_axis_angle(
        np.array([1.0, 0.0, 0.0], np.float32), -np.pi / 2))
    scene.take_mesh_instance(B.MeshInstance(JG.generate_quad(50.0, 50.0), floor, tf))
    light = scene.take_material(B.LightDiffuse(radiance=(30.0, 30.0, 30.0)))
    scene.take_sphere(B.SphereObject((0.0, 6.0, 0.0), 1.0, light), hot_spot=True)
    return scene.build()


def _camera_translation():
    js = _floor_scene()
    w = h = 12
    jcam = jmake_camera(transformation=jfrom_lookat((0.0, 2.0, 0.01), (0.0, 0.0, 0.0)),
                        vfov_deg=50, width=w, height=h)
    jstatic = JSceneStatic.from_scene(js)

    def jloss(dy):
        t = jcam.transformation
        c2 = jcam._replace(transformation=t._replace(
            translation=t.translation + jnp.array([0.0, 1.0, 0.0]) * dy))
        return jnp.mean(jrender_frame(js, jstatic, c2, JCameraConfig(), JSensorRGB(), w, h, 2,
                                      params=JPARAMS4))

    ps, cam = _port(js), _cam(jcam)
    static = SceneStatic.from_scene(ps)

    def loss(dy):
        t = cam.transformation
        c2 = cam._replace(transformation=t._replace(
            translation=t.translation + torch.tensor([0.0, 1.0, 0.0]) * dy))
        return render_frame(ps, static, c2, CameraConfig(), SensorRGB(), w, h, 2,
                            params=PARAMS4, device="cpu").mean()

    return Case(jloss, loss, 0.0, 1e-3, 0.08, fd_atol=1e-4)


CASES = {"albedo_furnace_analytic": _furnace, "emissive_linear": _emissive,
         "wall_albedo_fd": _wall_albedo, "camera_translation_fd": _camera_translation}


def evaluate(case: Case):
    """(case, jax.grad, the port's gradient, loss and central difference)."""
    jg = float(jax.jit(jax.grad(case.jloss))(jnp.float32(case.x0)))
    x = torch.tensor(case.x0, requires_grad=True)
    loss = case.loss(x)
    loss.backward()
    with torch.no_grad():
        fd = (float(case.loss(torch.tensor(case.x0 + case.eps)))
              - float(case.loss(torch.tensor(case.x0 - case.eps)))) / (2 * case.eps)
    return case, jg, float(x.grad), float(loss.detach()), fd


def check(result):
    c, jg, g, _, fd = result
    assert np.isfinite(g)
    np.testing.assert_allclose(g, jg, rtol=c.rtol, atol=1e-7)
    assert abs(fd) > max(c.fd_atol, 1e-6), f"degenerate FD ({fd}): the loss sees no effect"
    np.testing.assert_allclose(g, fd, rtol=c.fd_rtol, atol=c.fd_atol)


@pytest.fixture(scope="module")
def results():
    """Per case, evaluated once: the JAX gradient, the port's gradient, loss
    and central difference."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = evaluate(CASES[name]())
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_matches_jax_and_its_central_difference(results, name):
    check(results(name))


def test_furnace_gradient_is_the_analytic_one(results):
    """image = albedo x E on the sphere's centre pixels: d(mean)/d(albedo) = E = 1."""
    _, _, g, _, _ = results("albedo_furnace_analytic")
    np.testing.assert_allclose(g, 1.0, rtol=2e-2)


def test_emission_gradient_is_the_loss(results):
    """The image is linear in the emission (every path carries it once):
    d(loss)/ds at s = 1 is loss(1) (rtol 1e-3, the JAX test's)."""
    _, _, g, loss, _ = results("emissive_linear")
    np.testing.assert_allclose(g, loss, rtol=1e-3)


def test_brighter_walls_brighten_the_image(results):
    _, _, g, _, _ = results("wall_albedo_fd")
    assert g > 0.0
