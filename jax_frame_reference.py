"""Render the city bench frame with the JAX package on the CPU and print its
mean radiance and cast counters: the yardstick the PyTorch port's city frame
is held to (``wurblpt_tpu_torch/utils/kernel_check.py``).

    JAX_PLATFORMS=cpu python jax_frame_reference.py

The frame is bench config city_many_lights (bench.py bench_city_many_lights):
city_night(seed=7), 1920x1080, 360-degree stereo, 1 spp, 4 path components.
It renders in host blocks of 131072 lanes; at 1 spp each pixel has one
sample keyed on (pixel, sample), so the block size does not change the image
or the counters. Takes tens of minutes.
"""

from __future__ import annotations

import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

MAX_LANES = 131072


def main():
    import numpy as np

    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, SensorRGB, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.camera import SurroundMode
    from wurblpt_tpu.render.integrator import render_frame_wavefront
    from wurblpt_tpu.utils import scenes

    width, height = 1920, 1080
    t0 = time.perf_counter()
    scene = scenes.city_night(seed=7).build(use_bvh=True)
    t_build = time.perf_counter() - t0
    static = SceneStatic.from_scene(scene)
    cam = make_camera(transformation=from_lookat((0.0, 3.5, 14.0), (0.0, 1.5, 0.0)),
                      vfov_deg=50.0, width=width, height=height, eye_distance=0.065)
    cfg = CameraConfig(surround=SurroundMode.S360, stereo=True)
    t0 = time.perf_counter()
    img, stats = render_frame_wavefront(scene, static, cam, cfg, SensorRGB(), width, height, 1,
                                        params=RenderParams(max_path_components=4),
                                        return_stats=True, host_blocks=True,
                                        max_lanes=MAX_LANES)
    img = np.asarray(img)
    print(json.dumps({"frame": "city", "n_tris": int(scene.n_tris),
                      "n_lights": int(scene.light_prims.shape[0]),
                      "mean": float(img.astype(np.float64).mean()),
                      "stats": [int(x) for x in np.asarray(stats)], "max_lanes": MAX_LANES,
                      "build_s": t_build, "render_s": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
