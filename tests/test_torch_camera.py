"""Camera rays of the port against the JAX package, same counters: the
pinhole, and the 360/180-degree surround and stereo cameras of the city path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig, make_camera as jmake_camera
from wurblpt_tpu.core import rng as jrng
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
from wurblpt_tpu.render.camera import camera_rays as jcamera_rays
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import CameraConfig, camera_rays, from_lookat, make_camera
from wurblpt_tpu_torch.core import rng as trng
from wurblpt_tpu_torch.render.camera import SurroundMode, camera_from_numpy
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
    tpose, tvfov = scenes.cornell_ref_camera()
    assert vfov == tvfov
    for a, b in zip(jpose, tpose):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-7)
    jcam = jmake_camera(transformation=jpose, vfov_deg=vfov, width=W, height=H)
    tcam = make_camera(tpose, vfov, W, H)
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
    pose = from_lookat((0.0, 3.5, 14.0), (0.0, 3.5, 0.0))     # level: camera y is world up
    cam = make_camera(pose, 50.0, w, h, eye_distance=ed)
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
