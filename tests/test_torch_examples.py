"""The example apps' scenes (noise_textures, normalmap, material_comparison),
built through the port's Scene, rendered by the port's render_frame against
the JAX package's render_frame of the same scenes (jax_frame_reference's
builder) at 24 x 24, 4 spp in one pass, 3 path components.

They take the generic bounce: textures (checker, the four noises, an
image normal map), sphere lights, a constant sky, dispersive glass,
anisotropic GGX, ModPhong and an RGL sphere (K7's plain version). Both draw
the same counter-based random numbers: the cast counters are equal, the
pixels equal within rtol 1e-3 / atol 1e-5 on all but a few, and the mean
within 1e-4 relative (the parted pixels move it by 3e-5 at most). The few:
the hashed gradient's cos/sin rounds an ulp apart in XLA and PyTorch
(noise_textures), and the RGL sample's quadratic CDF inversion and the
dispersive glass's channel pick at a Fresnel boundary magnify an ulp into
another path (material_comparison; ROADMAP C.4): at most 2 of the 576
pixels part. The JAX side runs under jax.jit (one XLA
compile of ~30-40 s each)."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig, RenderParams as JRenderParams
from wurblpt_tpu import SceneStatic as JSceneStatic, SensorRGB as JSensorRGB
from wurblpt_tpu import make_camera as jmake_camera
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
from wurblpt_tpu.render.integrator import render_frame as jrender_frame
from wurblpt_tpu_torch import SceneStatic, render_frame_wavefront
from wurblpt_tpu_torch.render import wavefront
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import jax_frame_reference as jfr  # noqa: E402

W = H = 24
SSQRT, DEPTH = 2, 3
MAX_PARTED = 2


@pytest.mark.parametrize("name", ["noise_textures", "normalmap", "material_comparison"])
def test_render_frame_matches_jax(name):
    js, (eye, center, vfov) = jfr.jax_example_scene(name, 32)
    cam = jmake_camera(transformation=jfrom_lookat(eye, center), vfov_deg=vfov, width=W,
                       height=H)
    static = JSceneStatic.from_scene(js)
    fn = jax.jit(lambda s, c: jrender_frame(s, static, c, JCameraConfig(), JSensorRGB(), W, H,
                                            SSQRT, params=JRenderParams(max_path_components=DEPTH),
                                            samples_per_pass=SSQRT ** 2, return_stats=True))
    jimg, jstats = (np.asarray(x) for x in fn(js, cam))
    scene = scenes.normalmap(32, "cpu") if name == "normalmap" else None
    img, stats = kc.example_frame(name, "cpu", scene, W, H, SSQRT, DEPTH)()
    img = img.numpy()
    assert stats.tolist() == jstats.tolist()
    np.testing.assert_allclose(img.astype(np.float64).mean(), jimg.astype(np.float64).mean(),
                               rtol=1e-4)
    parted = ~np.isclose(img, jimg, rtol=1e-3, atol=1e-5).all(-1)
    assert int(parted.sum()) <= MAX_PARTED, int(parted.sum())


def test_textured_scenes_leave_k4():
    """A textured scene takes the generic bounce: none of K4's classes takes
    it, and render_frame_wavefront renders it there too (the same counters
    as render_frame's, whose paths are the wavefront's)."""
    scene = scenes.normalmap(16, "cpu")
    static = SceneStatic.from_scene(scene)
    assert static.has_textures
    assert not (wavefront.diffuse_scene(scene, static) or wavefront.env_scene(scene, static)
                or wavefront.lit_scene(scene, static))
    pose, vfov = scenes.normalmap_camera("cpu")
    from wurblpt_tpu_torch import CameraConfig, RenderParams, SensorRGB, make_camera

    cam = make_camera(pose, vfov, 8, 8, device="cpu")
    _, stats = render_frame_wavefront(scene, static, cam, CameraConfig(), SensorRGB(), 8, 8, 1,
                                      params=RenderParams(max_path_components=3),
                                      return_stats=True, device="cpu")
    _, pstats = kc.example_frame("normalmap", "cpu", scene, 8, 8, 1, 3)()
    assert stats.tolist() == pstats.tolist()
