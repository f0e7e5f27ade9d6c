"""The port's pass renderer (`render_frame`, `render_frame_progressive`,
`accumulate_passes`, `trace_paths`) against the JAX package's.

Both draw the same counter-based random numbers per (pixel, sample,
bounce), so the two renders take the same paths: on the Cornell box (16 x
16, 4 spp, 4 path components) the counters are equal, at least 99 % of the
pixels agree to rtol 1e-3 and the mean to 1e-4 relative (the bars of
tests/test_torch_integrator.py). Any split of a frame's passes gives the
same image bit for bit, and the pass renderer draws the paths of the
wavefront renderer."""

import jax
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig, RenderParams as JRenderParams
from wurblpt_tpu import SceneStatic as JSceneStatic, SensorRGB as JSensorRGB
from wurblpt_tpu import make_camera as jmake_camera
from wurblpt_tpu.render.integrator import render_frame as jrender_frame
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import (CameraConfig, RenderParams, SceneStatic, SensorRGB,
                               accumulate_passes, make_camera, render_frame,
                               render_frame_progressive, render_frame_wavefront, trace_paths)
from wurblpt_tpu_torch.core.rng import Salt, uniform2
from wurblpt_tpu_torch.render.camera import camera_from_numpy, camera_rays
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

W = 16
SSQRT = 2
PARAMS = RenderParams(max_path_components=4)


@pytest.fixture(scope="module")
def cornell():
    scene = scenes.cornell_box_ref("cpu")
    pose, vfov = scenes.cornell_ref_camera("cpu")
    return scene, SceneStatic.from_scene(scene), make_camera(pose, vfov, W, W, device="cpu")


@pytest.fixture(scope="module")
def jax_cornell():
    """The JAX package's render_frame of the same frame: (image, counters)."""
    js = jscenes.cornell_box_ref().build()
    pose, vfov = jscenes.cornell_ref_camera()
    jcam = jmake_camera(transformation=pose, vfov_deg=vfov, width=W, height=W)
    img, stats = jrender_frame(js, JSceneStatic.from_scene(js), jcam, JCameraConfig(),
                               JSensorRGB(), W, W, SSQRT,
                               params=JRenderParams(max_path_components=4), return_stats=True)
    return np.asarray(img), np.asarray(stats), jcam


def _render(cornell, **kw):
    scene, static, cam = cornell
    return render_frame(scene, static, cam, CameraConfig(), SensorRGB(), W, W, SSQRT,
                        params=PARAMS, return_stats=True, device="cpu", **kw)


def test_render_frame_matches_jax(cornell, jax_cornell):
    jimg, jstats, jcam = jax_cornell
    scene, static, _ = cornell
    cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam), "cpu")
    img, stats = render_frame(scene, static, cam, CameraConfig(), SensorRGB(), W, W, SSQRT,
                              params=PARAMS, return_stats=True, device="cpu")
    img = img.numpy()
    assert img.shape == (W, W, 3) and np.isfinite(img).all()
    assert stats.tolist() == jstats.tolist()
    close = np.isclose(img, jimg, rtol=1e-3, atol=1e-7).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() - jimg.mean()) <= 1e-4 * jimg.mean()


@pytest.mark.parametrize("samples_per_pass", [1, 2, 4])
def test_any_split_into_passes_draws_the_same_paths(cornell, samples_per_pass):
    """samples_per_pass 1, 2 and 4 (the whole frame in one batch) trace the
    same paths: equal counters, pixels to rtol 1e-6 (a pass's samples are
    summed before they join the frame's, so the sums' order differs); and
    progressive chunks of 1 and 3 passes give each split's bits."""
    one, one_stats = _render(cornell)
    ref, ref_stats = _render(cornell, samples_per_pass=samples_per_pass)
    assert torch.equal(ref_stats, one_stats)
    torch.testing.assert_close(ref, one, rtol=1e-6, atol=1e-9)
    scene, static, cam = cornell
    previews = []
    for chunk in (1, 3):
        prog = render_frame_progressive(
            scene, static, cam, CameraConfig(), SensorRGB(), W, W, SSQRT, params=PARAMS,
            samples_per_pass=samples_per_pass, passes_per_chunk=chunk,
            progress_cb=lambda done, n, preview: previews.append((done, n, preview)),
            device="cpu")
        assert torch.equal(prog, ref)
    n_pass = SSQRT * SSQRT // samples_per_pass
    assert previews[-1][0] == n_pass and previews[-1][1] == n_pass
    assert torch.equal(previews[-1][2], ref)


def test_accumulate_passes_in_two_calls_and_a_sample_offset(cornell):
    """Passes 0-1 then 2-3 add up to passes 0-3 bit for bit; a sample offset
    of 2 draws the samples that passes 2 and 3 draw."""
    scene, static, cam = cornell
    args = (scene, static, cam, CameraConfig(), SensorRGB(), W, W, SSQRT, 0.0, 0.0, PARAMS, 1)
    zero = torch.zeros((W * W, 3))
    whole = accumulate_passes(*args, zero, 0, 4, device="cpu")
    half = accumulate_passes(*args, zero, 0, 2, device="cpu")
    assert torch.equal(accumulate_passes(*args, half, 2, 2, device="cpu"), whole)
    late = accumulate_passes(*args, zero, 2, 2, device="cpu")
    shifted = accumulate_passes(*args, zero, 0, 2, sample_offset=torch.tensor(2), device="cpu")
    assert torch.equal(shifted, late)


def test_pass_renderer_draws_the_wavefront_renderers_paths(cornell):
    """The persistent-lane wavefront and the pass renderer trace the same
    paths: equal counters, pixels to rtol 1e-5 (the sums of a pixel's
    samples are taken in another order)."""
    scene, static, cam = cornell
    img, stats = _render(cornell)
    wimg, wstats = render_frame_wavefront(scene, static, cam, CameraConfig(), SensorRGB(), W, W,
                                          SSQRT, params=PARAMS, return_stats=True, device="cpu")
    assert stats.tolist() == wstats.tolist()
    torch.testing.assert_close(img, wimg, rtol=1e-5, atol=1e-7)


def test_trace_paths_is_one_pass(cornell):
    """trace_paths on a pass's camera rays gives that pass's accumulator."""
    scene, static, cam = cornell
    n = W * W
    pid = torch.arange(n)
    s = torch.zeros(n, dtype=torch.int64)
    uj = uniform2(pid, s, 0, Salt.PIXEL_JITTER)
    pxy = torch.stack([(pid % W).float() + uj[:, 0] * 0.5, (pid // W).float() + uj[:, 1] * 0.5],
                      -1)
    o, d, time = camera_rays(cam, CameraConfig(), pxy, W, W)
    acc, stats = trace_paths(scene, static, SensorRGB(), o, d, time, pid, s, PARAMS, True,
                             device="cpu")
    one = accumulate_passes(scene, static, cam, CameraConfig(), SensorRGB(), W, W, SSQRT, 0.0,
                            0.0, PARAMS, 1, torch.zeros((n, 3)), 0, 1, device="cpu")
    assert torch.equal(acc, one)
    assert stats[0] >= n


def test_shutter_interval_on_a_static_scene(cornell):
    """A static scene renders over t0 != t1 (the ray times are drawn and
    unused): the image of t0 = t1."""
    ref, _ = _render(cornell)
    img, _ = _render_t(cornell, 0.0, 1.0)
    assert torch.equal(img, ref)


def _render_t(cornell, t0, t1):
    scene, static, cam = cornell
    return render_frame(scene, static, cam, CameraConfig(), SensorRGB(), W, W, SSQRT, t0, t1,
                        params=PARAMS, return_stats=True, device="cpu")


def test_an_animated_scene_over_a_shutter_interval_is_refused():
    """Motion blur, ported: an animated scene over t0 != t1 renders, each ray
    at its own time (its image is not the instant's), and
    render_frame_wavefront hands such a frame to render_frame (the same
    image and counters); the JAX comparisons are in
    tests/test_torch_motion_blur.py."""
    scene = scenes.cornell_box_animated("cpu")
    pose, vfov = scenes.cornell_ref_camera("cpu")
    cam = make_camera(pose, vfov, 8, 8, device="cpu")
    static = SceneStatic.from_scene(scene)
    blur, stats = render_frame(scene, static, cam, CameraConfig(), SensorRGB(), 8, 8, 1, 0.0,
                               1.0, params=PARAMS, return_stats=True, device="cpu")
    img = render_frame(scene, static, cam, CameraConfig(), SensorRGB(), 8, 8, 1, kc.ANIM_TIME,
                       kc.ANIM_TIME, params=PARAMS, device="cpu")
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    assert bool(torch.isfinite(blur).all()) and float(blur.mean()) > 0
    assert not torch.equal(blur, img)
    wf, wf_stats = render_frame_wavefront(scene, static, cam, CameraConfig(), SensorRGB(), 8, 8,
                                          1, PARAMS, return_stats=True, device="cpu", t0=0.0,
                                          t1=1.0)
    assert torch.equal(wf, blur) and torch.equal(wf_stats, stats)


def test_entry_points_default_to_the_card(cornell):
    """Without device="cpu" the entry points render on "cuda": CPU tensors are refused."""
    scene, static, cam = cornell
    with pytest.raises(ValueError, match="render device is cuda"):
        render_frame(scene, static, cam, CameraConfig(), SensorRGB(), W, W, SSQRT, params=PARAMS)
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="render device is cuda"):
        trace_paths(scene, static, SensorRGB(), o, o, torch.zeros(4), torch.zeros(4),
                    torch.zeros(4), PARAMS)
