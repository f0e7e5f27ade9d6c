"""Depth of field and animated cameras in the port against the JAX package,
on the CPU.

* `camera_rays` through the thin lens (pinhole, through an OpenCV lens
  model, and the surround camera) and with an animated pose (random
  keyframes at random per-ray times, composed with a static local pose)
  against the JAX package's `camera_rays` on the same pixels, u_lens and
  u_time: origins and directions within 2e-5 of their size (XLA's fused
  multiply-adds, its sin and cos).
* K4's plain pinhole regeneration through the thin lens (regen_plain, the
  lens sample drawn by Salt.LENS) against the JAX camera at the pixel
  coordinates and lens samples its regeneration draws.
* rtiow's depth-of-field frame (examples/rtiow.py's aperture 0.08 focused
  at 10) at 24 x 24, 4 spp, 4 path components: the port's
  render_frame_wavefront (K4's env class through the lens) against the JAX
  package's: mean within rtol 2e-3, counters within 0.5 % (XLA's sphere
  test parts from its own eager one on a few casts:
  tests/test_torch_integrator.py).
* A mirror of tests/test_animated_nee.py::test_animated_camera_matches_static_pose:
  a camera keyframed to a pose renders, at the key's time, the static
  camera's image there (atol 1e-4), through render_frame (the pose per
  ray) and render_frame_wavefront (the pose composed once); and at one
  instant K4 keeps its route for an animated camera.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from test_torch_animation import _both  # noqa: E402
from wurblpt_tpu import CameraConfig as JCameraConfig  # noqa: E402
from wurblpt_tpu import RenderParams as JRenderParams  # noqa: E402
from wurblpt_tpu import SceneStatic as JSceneStatic  # noqa: E402
from wurblpt_tpu import SensorRGB as JSensorRGB  # noqa: E402
from wurblpt_tpu import make_camera as jmake_camera  # noqa: E402
from wurblpt_tpu.core.rng import Salt as JSalt, uniform2 as juniform2  # noqa: E402
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat  # noqa: E402
from wurblpt_tpu.render.camera import camera_rays as jcamera_rays  # noqa: E402
from wurblpt_tpu.render.integrator import render_frame_wavefront as jrender_wf  # noqa: E402
from wurblpt_tpu.utils import scenes as jscenes  # noqa: E402
from wurblpt_tpu_torch import (CameraConfig, RenderParams, SceneStatic, SensorRGB,  # noqa: E402
                               make_camera, render_frame, render_frame_wavefront)
from wurblpt_tpu_torch.core.transform import Transformation, from_lookat  # noqa: E402
from wurblpt_tpu_torch.core.transform import quat_from_axis_angle  # noqa: E402
from wurblpt_tpu_torch.render import camera as tcamera  # noqa: E402
from wurblpt_tpu_torch.render import wavefront as wf  # noqa: E402
from wurblpt_tpu_torch.render.camera import (DistortionModel, SurroundMode,  # noqa: E402
                                             camera_from_numpy)
from wurblpt_tpu_torch.scene import builder as B  # noqa: E402
from wurblpt_tpu_torch.scene.generator import generate_quad  # noqa: E402
from wurblpt_tpu_torch.utils import kernel_check as kc  # noqa: E402
from wurblpt_tpu_torch.utils import scenes  # noqa: E402

torch.set_num_threads(2)

W, H = 48, 32


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _inputs(n, seed):
    rs = np.random.default_rng(seed)
    pxy = np.stack([rs.uniform(0, W, n), rs.uniform(0, H, n)], -1).astype(np.float32)
    u_lens = rs.uniform(size=(n, 2)).astype(np.float32)
    u_lens[:4] = [[0.5, 0.5], [0.0, 0.0], [0.5, 0.9], [0.9, 0.5]]   # the disk's centre and axes
    return pxy, u_lens, rs.uniform(size=n).astype(np.float32)


def _close(ours, ref, rel=2e-5):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("case", ["pinhole", "opencv", "surround stereo", "no lens"])
def test_camera_rays_through_the_thin_lens_match_jax(case):
    lens = dict(focus_distance=4.5, aperture_diameter=0.3)
    kw = {}
    if case == "opencv":
        kw = dict(dist_k=(-0.1, 0.02, 0.0, 0.0, 0.0, 0.0), dist_p=(0.001, -0.001))
    jcam = jmake_camera(transformation=jfrom_lookat((1.0, 2.0, 6.0), (0.0, 0.3, 0.0)),
                        vfov_deg=35.0, width=W, height=H, eye_distance=0.07, **lens, **kw)
    cfg = {"pinhole": dict(dof=True), "opencv": dict(dof=True, distortion=DistortionModel.OPENCV,
                                                     undistort_iters=8),
           "surround stereo": dict(dof=True, surround=SurroundMode.S360, stereo=True),
           "no lens": dict()}[case]
    cam = camera_from_numpy(_np(jcam), "cpu")
    pxy, u_lens, u_time = _inputs(2000, 1)
    ref = jcamera_rays(jcam, JCameraConfig(**cfg), jnp.asarray(pxy), W, H, 0.0, 1.0,
                       jnp.asarray(u_time), jnp.asarray(u_lens))
    ours = tcamera.camera_rays(cam, CameraConfig(**cfg), torch.as_tensor(pxy), W, H, 0.0, 1.0,
                               torch.as_tensor(u_time), torch.as_tensor(u_lens))
    for a, b in zip(ours, ref):
        _close(a, b)
    if case == "pinhole":   # the lens point of the disk's centre is the pinhole's ray
        pin = tcamera.camera_rays(cam, CameraConfig(), torch.as_tensor(pxy[:1]), W, H)
        torch.testing.assert_close(ours[1][:1], pin[1], rtol=0, atol=1e-6)
        # rays of one pixel through the lens meet on the focus plane
        o, d = ours[0], ours[1]
        assert float((o - o[:1]).norm(dim=-1).max()) <= 0.15 + 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_animated_camera_rays_match_jax(seed):
    jt, pt, _ = _both(seed)
    jcam = jmake_camera(transformation=jfrom_lookat((0.0, 1.0, 3.0), (0.0, 0.0, 0.0)),
                        vfov_deg=40.0, width=W, height=H, focus_distance=3.0,
                        aperture_diameter=0.1)
    cam = camera_from_numpy(_np(jcam), "cpu")
    pxy, u_lens, u_time = _inputs(1500, seed + 5)
    for aid in (2, 5):
        for dof in (False, True):
            jc, c = (JCameraConfig(anim_id=aid, dof=dof), CameraConfig(anim_id=aid, dof=dof))
            ref = jcamera_rays(jcam, jc, jnp.asarray(pxy), W, H, -0.2, 1.2, jnp.asarray(u_time),
                               jnp.asarray(u_lens), anims=jt)
            ours = tcamera.camera_rays(cam, c, torch.as_tensor(pxy), W, H, -0.2, 1.2,
                                       torch.as_tensor(u_time), torch.as_tensor(u_lens),
                                       anims=pt)
            for a, b in zip(ours, ref):
                _close(a, b, 2e-5)
    with pytest.raises(ValueError, match="AnimTable"):
        tcamera.camera_rays(cam, CameraConfig(anim_id=1), torch.as_tensor(pxy), W, H)
    # static_pose: one instant's pose, the config without the animation
    c1, cfg1 = tcamera.static_pose(cam, CameraConfig(anim_id=2, dof=True), pt, 0.4)
    assert cfg1 == CameraConfig(dof=True)
    a = tcamera.camera_rays(c1, cfg1, torch.as_tensor(pxy), W, H, u_lens=torch.as_tensor(u_lens))
    b = tcamera.camera_rays(cam, CameraConfig(anim_id=2, dof=True), torch.as_tensor(pxy), W, H,
                            0.4, 0.4, torch.as_tensor(u_time), torch.as_tensor(u_lens), anims=pt)
    for x, y in zip(a[:2], b[:2]):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def test_lens_regeneration_matches_the_jax_camera():
    """regen_plain through the thin lens on a small rtiow_dof block after 2
    steps: the regenerated lanes' rays are the JAX camera's at the pixel
    coordinates and Salt.LENS samples its regeneration draws (to 2e-5: XLA's
    sin and cos and its FMAs); the lens moves them."""
    w, h, ssqrt = 24, 16, 2
    inp = kc.k4_inputs("cpu", "rtiow_dof", width=w, height=h, ssqrt=ssqrt, m=2)
    st, sample, k_next, cam, cfg, lanes = inp.regen[:6]
    assert cfg.dof and wf._pinhole(cfg)
    need = ((~st.active) & (k_next < lanes.P) & lanes.valid).numpy()
    assert 0 < need.sum() < need.size
    new, new_sample, _, _, _ = wf.regen_plain(st, sample, k_next, cam, cfg, lanes, True)
    s_new = new_sample.numpy()[need].astype(np.int32)
    pix = jnp.asarray(lanes.pixel.numpy()[need].astype(np.int32))
    uj = np.asarray(juniform2(pix, jnp.asarray(s_new), 0, JSalt.PIXEL_JITTER))
    ul = np.asarray(juniform2(pix, jnp.asarray(s_new), 0, JSalt.LENS))
    jx = ((s_new % ssqrt).astype(np.float32) + uj[:, 0]) * np.float32(1.0 / ssqrt)
    jy = ((s_new // ssqrt).astype(np.float32) + uj[:, 1]) * np.float32(1.0 / ssqrt)
    pxy = np.stack([lanes.px.numpy()[need] + jx, lanes.py.numpy()[need] + jy], -1)
    jcam = jmake_camera(transformation=jfrom_lookat((13.0, 2.0, 3.0), (0.0, 0.0, 0.0)),
                        vfov_deg=25.0, width=w, height=h, focus_distance=kc.DOF_FOCUS,
                        aperture_diameter=kc.DOF_APERTURE)
    jo, jd, _ = jcamera_rays(jcam, JCameraConfig(dof=True), jnp.asarray(pxy), w, h, 0.0, 0.0,
                             jnp.zeros((pxy.shape[0],)), jnp.asarray(ul))
    _close(new.o[torch.as_tensor(need)], jo)
    _close(new.d[torch.as_tensor(need)], jd)
    sharp, _, _, _, _ = wf.regen_plain(st, sample, k_next, cam, CameraConfig(), lanes, True)
    assert float((new.o - sharp.o).abs().max()) > 1e-3


def test_rtiow_dof_frame_matches_jax():
    w, ssqrt, depth = 24, 2, 4
    js = jscenes.rtiow().build()
    jcam = jmake_camera(transformation=jfrom_lookat((13.0, 2.0, 3.0), (0.0, 0.0, 0.0)),
                        vfov_deg=25.0, width=w, height=w, focus_distance=kc.DOF_FOCUS,
                        aperture_diameter=kc.DOF_APERTURE)
    jimg, jstats = jrender_wf(js, JSceneStatic.from_scene(js), jcam, JCameraConfig(dof=True),
                              JSensorRGB(), w, w, ssqrt, 0.0, 0.0,
                              JRenderParams(max_path_components=depth), return_stats=True)
    render = kc.rtiow_dof_frame("cpu", scenes.rtiow(device="cpu"), depth, w, w, ssqrt)
    img, stats = render()
    cam, cfg = scenes.rtiow_dof_camera(w, w, kc.DOF_APERTURE, kc.DOF_FOCUS, "cpu")
    ps = scenes.rtiow(device="cpu")
    assert wf.env_class(ps, SceneStatic.from_scene(ps), cfg)    # K4's route through the lens
    mean, jmean = float(img.double().mean()), float(np.asarray(jimg, np.float64).mean())
    assert abs(mean - jmean) <= 2e-3 * jmean, (mean, jmean)
    np.testing.assert_allclose(stats.numpy(), np.asarray(jstats), rtol=5e-3)
    # the same frame without the lens parts from it
    sharp = render_frame_wavefront(ps, SceneStatic.from_scene(ps), cam, CameraConfig(),
                                   SensorRGB(), w, w, ssqrt, RenderParams(max_path_components=depth),
                                   device="cpu")
    assert float((sharp - img).abs().max()) > 1e-2


def _rot_x(deg):
    return quat_from_axis_angle((1.0, 0.0, 0.0), np.deg2rad(deg))


def _light_room(camera_anim=None):
    """tests/test_animated_nee.py's light room (a floor quad and a small
    emissive quad above it), through the port's Scene; with `camera_anim`,
    that keyframe animation taken too (for the camera)."""
    sc = B.Scene()
    sc.take_mesh_instance(B.MeshInstance(generate_quad(2.0, 2.0),
                                         B.Lambertian(albedo=(0.8, 0.8, 0.8)),
                                         Transformation.make(rotation=_rot_x(-90.0))))
    sc.take_mesh_instance(B.MeshInstance(generate_quad(0.3, 0.3),
                                         B.LightDiffuse(radiance=(20.0, 20.0, 20.0)),
                                         Transformation.make(translation=(0.0, 1.5, 0.0),
                                                             rotation=_rot_x(90.0))),
                          hot_spot=True)
    aid = None if camera_anim is None else sc.take_animation(camera_anim)
    return sc.build(t0=0.0, t1=1.0, device="cpu"), aid


def test_animated_camera_matches_static_pose():
    """A camera keyframed from pose a to pose b over [0, 1], rendered at t =
    1, gives the image of a static camera at pose b (atol 1e-4, as the JAX
    package's test), through the pass renderer and the wavefront."""
    w = 24
    pose_a = from_lookat((0, 2.5, 3.5), (0, 0, 0), device="cpu")
    pose_b = from_lookat((1.5, 2.0, 3.0), (0, 0, 0), device="cpu")
    params = RenderParams(max_path_components=4)
    still, _ = _light_room()
    cam_s = make_camera(pose_b, 50.0, w, w, device="cpu")
    moving, aid = _light_room(B.AnimationKeyframes([0.0, 1.0], [pose_a, pose_b]))
    assert aid == 1
    cam_a = make_camera(None, 50.0, w, w, device="cpu")
    for render in (render_frame, render_frame_wavefront):
        kw = dict(t0=1.0, t1=1.0, params=params, device="cpu")
        ref = render(still, SceneStatic.from_scene(still), cam_s, CameraConfig(), SensorRGB(),
                     w, w, 3, **kw)
        img = render(moving, SceneStatic.from_scene(moving), cam_a, CameraConfig(anim_id=aid),
                     SensorRGB(), w, w, 3, **kw)
        assert float(ref.mean()) > 0
        np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=0, atol=1e-4)
    # at one instant the camera is posed once, and the frame keeps K4's route
    cam1, cfg1 = tcamera.static_pose(cam_a, CameraConfig(anim_id=aid), moving.anims, 1.0)
    torch.testing.assert_close(cam1.transformation.translation,
                               pose_b.translation.to(torch.float32), rtol=0, atol=1e-6)
    assert cfg1.anim_id == -1 and wf.diffuse_class(moving, SceneStatic.from_scene(moving), cfg1)
