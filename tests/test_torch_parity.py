"""Image parity of the port's wavefront render against the reference renderer.

The bars of tests/test_parity.py and tests/test_parity_city.py, held by
``wurblpt_tpu_torch``: the goldens in
parity/golden/ were rendered by the C++ reference (parity/src/parity_cornell.cpp)
from the scene that utils/cornell_data.py replicates. The reference writes row
0 at the bottom; the port, like the JAX package, puts row 0 at the top, so
goldens are flipped on load.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import torch

from wurblpt_tpu_torch import (
    CameraConfig,
    RenderParams,
    SceneStatic,
    SensorRGB,
    make_camera,
    render_frame_wavefront,
)
from wurblpt_tpu_torch.render.camera import SurroundMode
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

PARITY = Path(__file__).resolve().parent.parent / "parity"


def _tgdshim():
    spec = importlib.util.spec_from_file_location("tgdshim", PARITY / "tgdshim.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_golden(name):
    img, _ = _tgdshim().load(PARITY / "golden" / name)
    return np.asarray(img, np.float32)[::-1]


@functools.lru_cache(maxsize=None)
def _render_ours(w=64, h=64, ssqrt=4, max_depth=32):
    scene = scenes.cornell_box_ref("cpu")
    pose, vfov = scenes.cornell_ref_camera("cpu")
    cam = make_camera(pose, vfov, w, h, device="cpu")
    img = render_frame_wavefront(scene, SceneStatic.from_scene(scene), cam, CameraConfig(),
                                 SensorRGB(), w, h, ssqrt,
                                 params=RenderParams(max_path_components=max_depth),
                                 device="cpu")
    return img.numpy()


def test_port_cornell_parity_vs_reference_golden():
    """64x64 at 16 spp matches the (downsampled) converged golden about as well
    as the reference's own 16 spp render does."""
    ref2500 = _load_golden("ref_cornell_128_2500spp.tgdshim")
    ref16 = _load_golden("ref_cornell_128_16spp.tgdshim")
    ref_lo = ref2500.reshape(64, 2, 64, 2, 3).mean((1, 3))
    ours = _render_ours()

    scale = max(float(ref_lo.mean()), 1e-9)
    mean_rel = float(np.abs(ours - ref_lo).mean()) / scale
    ref_self = float(np.abs(ref16.reshape(64, 2, 64, 2, 3).mean((1, 3)) - ref_lo).mean()) / scale
    assert mean_rel < max(2.0 * ref_self, 0.10), (mean_rel, ref_self)
    assert abs(float(ours.mean()) - float(ref_lo.mean())) / scale < 0.02
    np.testing.assert_allclose(ours.mean((0, 1)), ref_lo.mean((0, 1)), rtol=0.03)


def test_port_cornell_parity_quantiles():
    """Luminance quantiles of the port's render line up with the golden's."""
    ref_lo = _load_golden("ref_cornell_128_2500spp.tgdshim").reshape(64, 2, 64, 2, 3).mean((1, 3))
    ours = _render_ours()
    for q in (0.1, 0.25, 0.5, 0.75, 0.9):
        a = float(np.quantile(ours.sum(-1), q))
        b = float(np.quantile(ref_lo.sum(-1), q))
        assert abs(a - b) <= 0.10 * max(b, 0.02) + 0.004, (q, a, b)


# The bars of tests/test_parity_city.py, held by the port: the golden was
# rendered by the reference (parity/src/parity_city.cpp) from the same
# round-tripped OBJ/MTL city, RGL table and night sky.

@functools.lru_cache(maxsize=None)
def _city_renders():
    ref = _load_golden("ref_city_64x36_16spp.tgdshim")
    scene = scenes.city_night(seed=7, device="cpu")
    pose, vfov = scenes.city_camera("cpu")
    cam = make_camera(pose, vfov, 64, 36, eye_distance=0.065, device="cpu")
    ours = render_frame_wavefront(scene, SceneStatic.from_scene(scene), cam,
                                  CameraConfig(surround=SurroundMode.S360, stereo=True),
                                  SensorRGB(), 64, 36, 4,
                                  params=RenderParams(max_path_components=4), device="cpu")
    return ref, ours.numpy()


def test_port_city_sky_rows_match_reference():
    """Rows looking straight at the sky are noise-free and pin the equirect orientation."""
    ref, ours = _city_renders()
    np.testing.assert_allclose(ours[:4], ref[:4], rtol=2e-2, atol=2e-3)


def test_port_city_clipped_mean_matches_reference():
    ref, ours = _city_renders()
    r = np.minimum(ref, 0.2).mean()
    o = np.minimum(ours, 0.2).mean()
    assert abs(o - r) / r < 0.12, (o, r)


def test_port_city_quantiles_match_reference():
    ref, ours = _city_renders()
    for q in (0.25, 0.5, 0.75):
        a = float(np.quantile(ours.sum(-1), q))
        b = float(np.quantile(ref.sum(-1), q))
        assert abs(a - b) <= 0.10 * max(b, 0.02) + 0.004, (q, a, b)
