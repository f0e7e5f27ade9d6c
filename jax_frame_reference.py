"""Render one bench frame with the JAX package on the CPU and print its mean
radiance and cast counters: the yardsticks the PyTorch port's frames are held
to (``wurblpt_tpu_torch/utils/kernel_check.py``).

    JAX_PLATFORMS=cpu python jax_frame_reference.py city      # tens of minutes
    JAX_PLATFORMS=cpu python jax_frame_reference.py envmap    # under a minute
    JAX_PLATFORMS=cpu python jax_frame_reference.py rtiow     # under a minute

city is bench config city_many_lights (bench.py bench_city_many_lights):
city_night(seed=7), 1920x1080, 360-degree stereo, 1 spp, 4 path components,
in host blocks of 131072 lanes; at 1 spp each pixel has one sample keyed on
(pixel, sample), so the block size does not change the image or the counters.

envmap is bench config envmap_cube_is (bench.py bench_envmap_furnace):
envmap_spheres(cube=True), 128x128, 16 spp, 8 path components. rtiow is
bench config rtiow_distortion (bench.py bench_rtiow): rtiow(), 192x128,
16 spp, 8 path components, OpenCV lens distortion with 8 undistortion steps.
Both call render_frame_wavefront as the port's tests call it, at the default
131072 lanes. bench.py wraps that call in jax.jit with the scene as an
argument: the envmap frame comes out the same, the rtiow frame at mean
0.5212673 and counters [765082, 765082], 0.03 % apart, because XLA then
rounds the re-centred sphere test otherwise and its last bits decide the
self-intersections on the small spheres.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

MAX_LANES = 131072


def _frame(scene, cam, cfg, width, height, ssqrt, depth, host_blocks=False):
    from wurblpt_tpu import RenderParams, SceneStatic, SensorRGB
    from wurblpt_tpu.render.integrator import render_frame_wavefront

    def render():
        return render_frame_wavefront(scene, SceneStatic.from_scene(scene), cam, cfg, SensorRGB(),
                                      width, height, ssqrt,
                                      params=RenderParams(max_path_components=depth),
                                      return_stats=True, host_blocks=host_blocks,
                                      max_lanes=MAX_LANES)

    return render


def _city():
    from wurblpt_tpu import CameraConfig, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.camera import SurroundMode
    from wurblpt_tpu.utils import scenes

    scene = scenes.city_night(seed=7).build(use_bvh=True)
    cam = make_camera(transformation=from_lookat((0.0, 3.5, 14.0), (0.0, 1.5, 0.0)),
                      vfov_deg=50.0, width=1920, height=1080, eye_distance=0.065)
    cfg = CameraConfig(surround=SurroundMode.S360, stereo=True)
    return scene, _frame(scene, cam, cfg, 1920, 1080, 1, 4, host_blocks=True)


def _envmap():
    from wurblpt_tpu import CameraConfig, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.utils import scenes

    scene = scenes.envmap_spheres(cube=True).build()
    cam = make_camera(transformation=from_lookat((0.0, 0.6, 4.0), (0.0, 0.0, 0.0)),
                      vfov_deg=40.0, width=128, height=128)
    return scene, _frame(scene, cam, CameraConfig(), 128, 128, 4, 8)


def _rtiow():
    from wurblpt_tpu import CameraConfig, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.camera import DistortionModel
    from wurblpt_tpu.utils import scenes

    scene = scenes.rtiow().build()
    cam = make_camera(transformation=from_lookat((13.0, 2.0, 3.0), (0.0, 0.0, 0.0)),
                      vfov_deg=30.0, width=192, height=128,
                      dist_k=(-0.1, 0.02, 0.0, 0.0, 0.0, 0.0), dist_p=(0.001, -0.001))
    cfg = CameraConfig(distortion=DistortionModel.OPENCV, undistort_iters=8)
    return scene, _frame(scene, cam, cfg, 192, 128, 4, 8)


FRAMES = {"city": _city, "envmap": _envmap, "rtiow": _rtiow}


def main():
    import numpy as np

    name = sys.argv[1] if len(sys.argv) > 1 else "city"
    if name not in FRAMES:
        raise SystemExit(f"usage: jax_frame_reference.py [{'|'.join(FRAMES)}]")
    t0 = time.perf_counter()
    scene, render = FRAMES[name]()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    img, stats = render()
    img = np.asarray(img)
    print(json.dumps({"frame": name, "n_tris": int(scene.n_tris),
                      "n_spheres": int(scene.n_spheres),
                      "n_lights": int(scene.light_prims.shape[0]),
                      "mean": float(img.astype(np.float64).mean()),
                      "stats": [int(x) for x in np.asarray(stats)], "max_lanes": MAX_LANES,
                      "build_s": t_build, "render_s": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
