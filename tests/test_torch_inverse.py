"""The port's inverse rendering (`wurblpt_tpu_torch.inverse.fit`): the JAX
package's tests/test_inverse.py mirrored on the same scene (a quad under a
sphere light, `scenes.lit_quad`, built by the port as the JAX builder builds
it), with the same sizes, steps, optimiser settings and bars: the albedo
recovered within 0.06 with the last loss below a quarter of the first, the
camera's lateral offset within 0.06 with the last loss below 0.3 of the
first. The targets are held to the JAX package's render of them first."""

import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig, RenderParams as JRenderParams
from wurblpt_tpu import SceneStatic as JSceneStatic, SensorRGB as JSensorRGB
from wurblpt_tpu import make_camera as jmake_camera
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
from wurblpt_tpu.render.integrator import render_frame as jrender_frame
from test_torch_sphere_lights import _jax_quad
from wurblpt_tpu_torch import (CameraConfig, RenderParams, SceneStatic, SensorRGB, from_lookat,
                               make_camera, render_frame)
from wurblpt_tpu_torch.inverse import fit, make_train_step
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

W = 24
PARAMS = RenderParams(max_path_components=2)


def _cam(eye, center):
    return make_camera(from_lookat(eye, center, device="cpu"), 45.0, W, W, device="cpu")


def _target(scene, cam):
    return render_frame(scene, SceneStatic.from_scene(scene), cam, CameraConfig(), SensorRGB(),
                        W, W, 2, params=PARAMS, device="cpu")


def _set_albedo(scene, p):
    m = scene.materials
    row = torch.cat([p["albedo"], m.albedo[0, 3:]])[None]
    return scene._replace(materials=m._replace(albedo=torch.cat([row, m.albedo[1:]], 0)))


def test_target_matches_the_jax_render():
    """The albedo test's target, 99 % of pixels to rtol 1e-3 and the mean
    to 1e-4 of the JAX package's render_frame of it."""
    js = _jax_quad(albedo=(0.7, 0.2, 0.5))
    jcam = jmake_camera(transformation=jfrom_lookat((0, 0, 2.4), (0, 0, 0)), vfov_deg=45.0,
                        width=W, height=W)
    jimg = np.asarray(jrender_frame(js, JSceneStatic.from_scene(js), jcam, JCameraConfig(),
                                    JSensorRGB(), W, W, 2,
                                    params=JRenderParams(max_path_components=2)))
    img = _target(scenes.lit_quad((0.7, 0.2, 0.5), device="cpu"),
                  _cam((0, 0, 2.4), (0, 0, 0))).numpy()
    assert np.isclose(img, jimg, rtol=1e-3, atol=1e-7).all(-1).mean() >= 0.99
    assert abs(img.mean() - jimg.mean()) <= 1e-4 * jimg.mean()


def test_fit_recovers_albedo():
    cam = _cam((0, 0, 2.4), (0, 0, 0))
    target = _target(scenes.lit_quad((0.7, 0.2, 0.5), device="cpu"), cam)
    res = fit(scenes.lit_quad((0.4, 0.4, 0.4), device="cpu"), {"albedo": torch.full((3,), 0.4)},
              _set_albedo, target, cam=cam, width=W, height=W, samples_sqrt=2,
              render_params=PARAMS, optimizer=lambda ps: torch.optim.Adam(ps, lr=5e-2),
              steps=40, device="cpu")
    np.testing.assert_allclose(res.params["albedo"].numpy(), [0.7, 0.2, 0.5], atol=0.06)
    assert res.losses[-1] < 0.25 * res.losses[0]
    assert res.final_image.shape == (W, W, 3)


def test_fit_recovers_camera_translation():
    """The apply_cam hook: a lateral camera offset recovered from pixels."""
    scene = scenes.lit_quad(device="cpu")
    target = _target(scene, _cam((0.25, -0.1, 2.4), (0.25, -0.1, 0.0)))

    def apply_cam(cam, p):
        tf = cam.transformation
        return cam._replace(transformation=tf._replace(translation=tf.translation + p["dt"]))

    res = fit(scene, {"dt": torch.zeros(3)}, lambda s, p: s, target,
              cam=_cam((0.0, 0.0, 2.4), (0.0, 0.0, 0.0)), width=W, height=W, samples_sqrt=2,
              render_params=PARAMS, apply_cam=apply_cam,
              optimizer=lambda ps: torch.optim.Adam(ps, lr=2e-2), steps=60, device="cpu")
    np.testing.assert_allclose(res.params["dt"][:2].numpy(), [0.25, -0.1], atol=0.06)
    assert res.losses[-1] < 0.3 * res.losses[0]


def test_a_mesh_of_cards_is_refused():
    scene = scenes.lit_quad(device="cpu")
    cam = _cam((0, 0, 2.4), (0, 0, 0))
    with pytest.raises(NotImplementedError, match="A.11"):
        make_train_step(scene, _set_albedo, torch.zeros((W, W, 3)),
                        {"albedo": torch.full((3,), 0.4, requires_grad=True)}, cam=cam, width=W,
                        height=W, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A.11"):
        fit(scene, {"albedo": torch.full((3,), 0.4)}, _set_albedo, torch.zeros((W, W, 3)),
            cam=cam, width=W, height=W, steps=1, mesh=object(), device="cpu")


def test_post_step_clips_the_params():
    """post_step runs after each update: params clipped to [0.45, 0.5] stay there."""
    cam = _cam((0, 0, 2.4), (0, 0, 0))
    target = _target(scenes.lit_quad((0.7, 0.2, 0.5), device="cpu"), cam)
    res = fit(scenes.lit_quad((0.4, 0.4, 0.4), device="cpu"), {"albedo": torch.full((3,), 0.4)},
              _set_albedo, target, cam=cam, width=W, height=W, render_params=PARAMS, steps=2,
              post_step=lambda p: {"albedo": p["albedo"].clamp(0.45, 0.5)}, device="cpu")
    lo, hi = np.float32(0.45), np.float32(0.5)
    assert float(res.params["albedo"].min()) >= lo and float(res.params["albedo"].max()) <= hi
    assert len(res.losses) == 2
