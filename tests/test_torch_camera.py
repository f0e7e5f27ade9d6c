"""Camera rays of the port against the JAX package, same counters: the
pinhole, and the 360/180-degree surround and stereo cameras of the city path,
and the three lens distortion models of the rtiow path.

Distortion: the forward models and the undistortions to atol 2e-7 of
normalized coordinates in [-0.6, 0.6] (XLA contracts the polynomials into
FMAs on the CPU, the port does not; 1.2e-7 measured, eager or jitted JAX);
the rays through them to atol 1e-6 like the pinhole's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig, make_camera as jmake_camera
from wurblpt_tpu.core import rng as jrng
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
from wurblpt_tpu.render import camera as jcamera
from wurblpt_tpu.render.camera import camera_rays as jcamera_rays
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import CameraConfig, camera_rays, from_lookat, make_camera
from wurblpt_tpu_torch.core import rng as trng
from wurblpt_tpu_torch.render import camera as tcamera
from wurblpt_tpu_torch.render.camera import DistortionModel, SurroundMode, camera_from_numpy
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

W, H, SSQRT = 24, 16, 2


def _pixels(rng, uniform2, arange):
    """Jittered pixel coords of every (pixel, sample) as the wavefront makes them."""
    n = W * H * SSQRT * SSQRT
    i = arange(n)
    pix, s = i % (W * H), i // (W * H)
    uj = uniform2(pix, s, 0, rng.Salt.PIXEL_JITTER)
    jx = ((s % SSQRT) + uj[..., 0]) / SSQRT
    jy = ((s // SSQRT) + uj[..., 1]) / SSQRT
    return pix, jx, jy


def test_lookat_pose_and_intrinsics_match():
    jpose, vfov = jscenes.cornell_ref_camera()
    tpose, tvfov = scenes.cornell_ref_camera("cpu")
    assert vfov == tvfov
    for a, b in zip(jpose, tpose):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-7)
    jcam = jmake_camera(transformation=jpose, vfov_deg=vfov, width=W, height=H)
    tcam = make_camera(tpose, vfov, W, H, device="cpu")
    via_numpy = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam), "cpu")
    for a, b, c in zip(jax.tree_util.tree_leaves(jcam), jax.tree_util.tree_leaves(
            tuple(tcam)), jax.tree_util.tree_leaves(tuple(via_numpy))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-7)
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))


def test_camera_rays_match_from_the_same_counters():
    jpose, vfov = jscenes.cornell_ref_camera()
    jcam = jmake_camera(transformation=jpose, vfov_deg=vfov, width=W, height=H)
    tcam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam), "cpu")

    pix, jx, jy = _pixels(jrng, jrng.uniform2, lambda n: jnp.arange(n, dtype=jnp.int32))
    pxy = jnp.stack([(pix % W) + jx, (pix // W) + jy], -1).astype(jnp.float32)
    n = pxy.shape[0]
    jo, jd, _ = jcamera_rays(jcam, JCameraConfig(), pxy, W, H, 0.0, 0.0,
                             jnp.zeros((n,)), jnp.zeros((n, 2)))

    tpix, tjx, tjy = _pixels(trng, trng.uniform2, lambda n: torch.arange(n))
    tpxy = torch.stack([(tpix % W) + tjx, (tpix // W) + tjy], -1).to(torch.float32)
    np.testing.assert_allclose(tpxy.numpy(), np.asarray(pxy), rtol=0, atol=1e-6)
    to, td = camera_rays(tcam, CameraConfig(), tpxy, W, H)

    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(td.numpy(), axis=-1), 1.0, atol=1e-6)
    # Row 0 is at the top: the first pixel row looks up (+y) from the camera.
    assert float(td[:W, 1].mean()) > 0 > float(td[-W:, 1].mean())


@pytest.mark.parametrize("surround, stereo", [(SurroundMode.S360, True), (SurroundMode.S360, False),
                                              (SurroundMode.S180, True), (SurroundMode.OFF, True)])
def test_surround_and_stereo_rays_match(surround, stereo):
    """360/180-degree and stereo rays of the city camera against JAX (the
    JAX package's divisions by the image size are XLA multiplications by the
    reciprocal, which the port reproduces)."""
    w, h = 64, 36
    pose = jfrom_lookat((0.0, 3.5, 14.0), (0.0, 1.5, 0.0))
    jcam = jmake_camera(transformation=pose, vfov_deg=50.0, width=w, height=h,
                        eye_distance=0.065)
    tcam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam), "cpu")
    rs = np.random.default_rng(3)
    n = w * h * 2
    pxy = np.stack([np.arange(n) % w, (np.arange(n) // w) % h], -1) + rs.uniform(size=(n, 2))
    pxy = pxy.astype(np.float32)
    jo, jd, _ = jcamera_rays(jcam, JCameraConfig(surround=surround, stereo=stereo),
                             jnp.asarray(pxy), w, h, 0.0, 0.0, jnp.zeros((n,)), jnp.zeros((n, 2)))
    to, td = camera_rays(tcam, CameraConfig(surround=surround, stereo=stereo),
                         torch.from_numpy(pxy), w, h)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_ods_eye_circle():
    """360-degree stereo: each eye sits on the circle of diameter eye_distance
    around the camera, perpendicular to its viewing column; left eye on top."""
    w, h, ed = 32, 16, 0.065
    # level: camera y is world up
    pose = from_lookat((0.0, 3.5, 14.0), (0.0, 3.5, 0.0), device="cpu")
    cam = make_camera(pose, 50.0, w, h, eye_distance=ed, device="cpu")
    pxy = torch.stack(torch.meshgrid(torch.arange(w) + 0.5, torch.arange(h) + 0.5,
                                     indexing="xy"), -1).reshape(-1, 2)
    o, d = camera_rays(cam, CameraConfig(surround=SurroundMode.S360, stereo=True), pxy, w, h)
    off = (o - pose.translation).numpy()
    np.testing.assert_allclose(np.linalg.norm(off, axis=-1), 0.5 * ed, rtol=1e-4)
    dh = d.numpy().copy()
    dh[:, 1] = 0.0
    # o - translation loses the low bits of a position 14 units out (ulp ~1e-6)
    np.testing.assert_allclose((off * dh).sum(-1), 0.0, atol=2e-6)
    left, right = off[: w * h // 2], off[w * h // 2:]
    np.testing.assert_allclose(left, -right, atol=2e-6)


MODELS = [DistortionModel.RADIAL_AND_PLANAR, DistortionModel.RADIAL_ONLY, DistortionModel.OPENCV]


def _lens_cameras(model, iters=8):
    jcam = jmake_camera(transformation=jfrom_lookat((13.0, 2.0, 3.0), (0.0, 0.0, 0.0)),
                        vfov_deg=30.0, width=192, height=128,
                        dist_k=(-0.1, 0.02, 0.005, 0.0, 0.0, 0.0), dist_p=(0.001, -0.001))
    return (jcam, JCameraConfig(distortion=model, undistort_iters=iters),
            camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam), "cpu"),
            CameraConfig(distortion=model, undistort_iters=iters))


def _normalized(n=8192, seed=7):
    return np.random.default_rng(seed).uniform(-0.6, 0.6, (n, 2)).astype(np.float32)


@pytest.mark.parametrize("model", MODELS)
def test_distort_and_undistort_match_jax(model):
    jcam, jcfg, cam, cfg = _lens_cameras(model)
    xy = _normalized()
    for ours, ref in ((tcamera.distort_normalized, jcamera.distort_normalized),
                      (tcamera.undistort_normalized, jcamera.undistort_normalized)):
        np.testing.assert_allclose(ours(cam, cfg, torch.from_numpy(xy)).numpy(),
                                   np.asarray(ref(jcam, jcfg, jnp.asarray(xy))), rtol=0, atol=2e-7)
    und = tcamera.undistort_normalized(cam, cfg, torch.from_numpy(xy))
    back = tcamera.distort_normalized(cam, cfg, und).numpy()
    # OpenCV's fixed point inverts to the last bits; the closed forms are approximations.
    tol = {DistortionModel.OPENCV: 1e-6, DistortionModel.RADIAL_ONLY: 1e-3}.get(model, 1e-2)
    np.testing.assert_allclose(back, xy, rtol=0, atol=tol)
    assert np.abs(und.numpy() - xy).max() > 1e-3              # the lens does bend


@pytest.mark.parametrize("model", MODELS)
def test_distorted_camera_rays_match_jax(model):
    jcam, jcfg, cam, cfg = _lens_cameras(model)
    n = 4096
    pxy = (np.random.default_rng(8).uniform(size=(n, 2)) * [192, 128]).astype(np.float32)
    jo, jd, _ = jcamera_rays(jcam, jcfg, jnp.asarray(pxy), 192, 128, 0.0, 0.0, jnp.zeros((n,)),
                             jnp.zeros((n, 2)))
    o, d = camera_rays(cam, cfg, torch.from_numpy(pxy), 192, 128)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    _, d0 = camera_rays(cam, CameraConfig(), torch.from_numpy(pxy), 192, 128)
    assert float((d - d0).abs().max()) > 1e-3


def test_opencv_fixed_point_contracts():
    """At the rtiow coefficients the fixed point contracts: a last-bit change
    of the input moves the result by at most a few ulps after any number of
    steps, and 8 steps agree with 32 (and with JAX's 8 and 32) to 2e-7."""
    jcam, _, cam, _ = _lens_cameras(DistortionModel.OPENCV)
    x1 = torch.from_numpy(_normalized())
    x2 = torch.nextafter(x1, torch.full_like(x1, 10.0))
    ulp = float(np.spacing(np.float32(0.6)))
    outs = {}
    for iters in (1, 2, 4, 8, 16, 32):
        cfg = CameraConfig(distortion=DistortionModel.OPENCV, undistort_iters=iters)
        outs[iters] = tcamera.undistort_normalized(cam, cfg, x1)
        moved = (tcamera.undistort_normalized(cam, cfg, x2) - outs[iters]).abs().max()
        assert float(moved) <= 4 * ulp, (iters, float(moved))
    assert float((outs[8] - outs[32]).abs().max()) <= 2e-7
    for iters in (8, 32):
        ref = jcamera.undistort_normalized(
            jcam, JCameraConfig(distortion=DistortionModel.OPENCV, undistort_iters=iters),
            jnp.asarray(x1.numpy()))
        np.testing.assert_allclose(outs[iters].numpy(), np.asarray(ref), rtol=0, atol=2e-7)


def test_lens_models_pass_the_camera_check_and_dof_does_not():
    for model in [DistortionModel.NONE] + MODELS:
        tcamera.check_camera(CameraConfig(distortion=model))
    for bad, feature in ((CameraConfig(dof=True), "depth of field"),
                         (CameraConfig(anim_id=0), "animated camera"),
                         (CameraConfig(distortion=7), "distortion model 7")):
        with pytest.raises(NotImplementedError, match=feature):
            tcamera.check_camera(bad)
