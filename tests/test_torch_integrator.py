"""The port's wavefront render against the JAX package's, pixel by pixel.

Both draw the same counter-based random numbers, so a path can differ only
where f32 rounding flips a discrete decision (a hit, a Russian-roulette
draw): at least 99% of pixels must agree to rtol 1e-3, the image mean to
1e-4 relative, and the cast counters to 0.5%."""

import jax
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig, RenderParams as JRenderParams
from wurblpt_tpu import SceneStatic as JSceneStatic, SensorRGB as JSensorRGB
from wurblpt_tpu import make_camera as jmake_camera
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
from wurblpt_tpu.render.integrator import render_frame_wavefront as jrender
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import (
    CameraConfig,
    RenderParams,
    SceneStatic,
    SensorRGB,
    make_camera,
    render_frame_wavefront,
    scene_from_numpy,
)
from wurblpt_tpu_torch.render.camera import camera_from_numpy
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

W = H = 32
SSQRT = 2
DEPTH = 8


def _port_cornell_ref():
    return scenes.cornell_box_ref("cpu")


def _port_of_jax(jscene):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")


CASES = {
    # the bench scene, built by the port without jax
    "cornell_ref": (lambda: jscenes.cornell_box_ref().build(), jscenes.cornell_ref_camera,
                    lambda j: _port_cornell_ref()),
    # the sphere branch of every kernel (the light stays a triangle)
    "cornell_sphere": (lambda: jscenes.cornell_box(short_object="sphere").build(),
                       jscenes.cornell_camera, _port_of_jax),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wavefront_render_matches_jax_per_pixel(case):
    build, camera, port_scene = CASES[case]
    jscene = build()
    pose, vfov = camera()
    jcam = jmake_camera(transformation=pose, vfov_deg=vfov, width=W, height=H)
    jimg, jstats = jrender(jscene, JSceneStatic.from_scene(jscene), jcam, JCameraConfig(),
                           JSensorRGB(), W, H, SSQRT,
                           params=JRenderParams(max_path_components=DEPTH), return_stats=True)
    jimg, jstats = np.asarray(jimg), np.asarray(jstats)

    scene = port_scene(jscene)
    cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam), "cpu")
    img, stats = render_frame_wavefront(scene, SceneStatic.from_scene(scene), cam,
                                        CameraConfig(), SensorRGB(), W, H, SSQRT,
                                        params=RenderParams(max_path_components=DEPTH),
                                        return_stats=True, device="cpu")
    img, stats = img.numpy(), stats.numpy()

    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    close = np.isclose(img, jimg, rtol=1e-3, atol=1e-7).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() - jimg.mean()) <= 1e-4 * jimg.mean()
    np.testing.assert_allclose(stats, jstats, rtol=5e-3)
    assert stats[1] > stats[0] > W * H * SSQRT * SSQRT


def test_mesh_frame_matches_jax_per_pixel():
    """The mesh path at a small size: terrain_city (2594 triangles, BVH, GGX
    and mirror spheres, importance-sampled sky) built by the port without
    jax, 32 x 24 pixels, 1 spp, 4 path components. Same bars as above, with
    the cast counters equal."""
    small = dict(terrain_res=24, n_buildings=8, sphere_slices=6)
    w, h = 32, 24
    jscene = jscenes.terrain_city(seed=3, **small).build(use_bvh=True)
    jcam = jmake_camera(transformation=jfrom_lookat((14.0, 9.0, 14.0), (0.0, 0.5, 0.0)),
                        vfov_deg=45.0, width=w, height=h)
    jimg, jstats = jrender(jscene, JSceneStatic.from_scene(jscene), jcam, JCameraConfig(),
                           JSensorRGB(), w, h, 1, params=JRenderParams(max_path_components=4),
                           return_stats=True)
    jimg, jstats = np.asarray(jimg), np.asarray(jstats)

    scene = scenes.terrain_city(seed=3, **small)
    cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam), "cpu")
    img, stats = render_frame_wavefront(scene, SceneStatic.from_scene(scene), cam,
                                        CameraConfig(), SensorRGB(), w, h, 1,
                                        params=RenderParams(max_path_components=4),
                                        return_stats=True, device="cpu")
    img, stats = img.numpy(), stats.numpy()

    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    close = np.isclose(img, jimg, rtol=1e-3, atol=1e-7).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img.mean() - jimg.mean()) <= 1e-4 * jimg.mean()
    np.testing.assert_array_equal(stats, jstats)
    # env NEE casts a shadow ray per diffuse/glossy bounce, light NEE none
    assert stats[0] > w * h and stats[0] < stats[1] < 2 * stats[0]


def test_stats_count_the_casts():
    """Closest casts >= paths (one per path per bounce); shadow casts only on
    pdf-sampled bounces, so fewer than closest casts per path."""
    scene = _port_cornell_ref()
    pose, vfov = scenes.cornell_ref_camera()
    cam = make_camera(pose, vfov, 8, 8)
    _, s1 = render_frame_wavefront(scene, SceneStatic.from_scene(scene), cam, CameraConfig(),
                                   SensorRGB(), 8, 8, 1, params=RenderParams(max_path_components=1),
                                   return_stats=True, device="cpu")
    closest, total = s1.tolist()
    assert closest == 64                      # depth 1: one closest cast per pixel
    assert 0 < total - closest <= closest     # one shadow cast per diffuse hit
