"""Render one bench frame with the JAX package on the CPU and print its mean
radiance and cast counters: the yardsticks the PyTorch port's frames are held
to (``wurblpt_tpu_torch/utils/kernel_check.py``).

    JAX_PLATFORMS=cpu python jax_frame_reference.py city      # tens of minutes
    JAX_PLATFORMS=cpu python jax_frame_reference.py envmap    # under a minute
    JAX_PLATFORMS=cpu python jax_frame_reference.py rtiow     # under a minute
    JAX_PLATFORMS=cpu python jax_frame_reference.py tof       # under a minute
    JAX_PLATFORMS=cpu python jax_frame_reference.py cornell_animated

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

tof is bench config tof_amcw (bench.py bench_tof): tof_box(), 96x96, 16 spp,
6 path components, SensorTofAmcw, under jax.jit with the scene as an
argument as bench.py runs it (the plain call gives mean 1.95638643e-17,
6e-8 apart, with the same counters). It prints one line per phase image (0-3:
the mean energy and the channel means a, b, energy, in float64 and, as
bench.py takes them, numpy's float32 mean; the counters), then the
4-phase distance at 1 path component (direct light only) against
get_ground_truth's distance (the first hit of the pixel-centre rays): the
median, 90th percentile and largest |error| in metres over the lit pixels.

cornell_animated is the port's animated Cornell frame: the reference Cornell
box with the keyframes of the port's `scenes.cornell_animations` (numbers in
``wurblpt_tpu_torch/utils/kernel_check.py``), built here with the JAX
package's builder (`jax_cornell_animated`, also the port's tests' JAX
side), rendered with render_frame_wavefront at t0 = t1 = 0.5 with
bench.py's Cornell settings: 128x128, 16 spp, 8 path components, the
reference camera, SensorRGB, 131072 lanes. The JAX package casts it
through its sweeps with object-space rays (36 triangles, no BVH).
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

MAX_LANES = 131072


def _frame(scene, cam, cfg, width, height, ssqrt, depth, host_blocks=False, t=0.0):
    from wurblpt_tpu import RenderParams, SceneStatic, SensorRGB
    from wurblpt_tpu.render.integrator import render_frame_wavefront

    def render():
        return render_frame_wavefront(scene, SceneStatic.from_scene(scene), cam, cfg, SensorRGB(),
                                      width, height, ssqrt, t, t,
                                      params=RenderParams(max_path_components=depth),
                                      return_stats=True, host_blocks=host_blocks,
                                      max_lanes=MAX_LANES)

    return render


def jax_cornell_animated(spheres=False):
    """The animated Cornell box as the JAX package's builder makes it: the
    reference box (cornell_box_ref) with the port's keyframes
    (wurblpt_tpu_torch.utils.scenes.cornell_animations), animation ids 1-3
    for the short box, the tall box and the light; with `spheres`, the
    port's two spheres (scenes.CORNELL_ANIM_SPHERES). No BVH."""
    import numpy as np

    from wurblpt_tpu.core.transform import Transformation
    from wurblpt_tpu.scene import builder as B
    from wurblpt_tpu.utils import cornell_data as CD
    from wurblpt_tpu_torch.utils import scenes as port_scenes

    scene = B.Scene()
    mats = {name: scene.take_material(B.Lambertian(albedo=CD.ALBEDO[name]), name)
            for name in ("white", "red", "green")}
    mats["tall"] = mats["short"] = mats["white"]
    light = scene.take_material(B.LightDiffuse(radiance=CD.LIGHT_RADIANCE), "light")
    for a in port_scenes.cornell_animations():
        scene.take_animation(B.AnimationKeyframes(list(a.times), [
            Transformation.make(*(np.asarray(x) for x in tf)) for tf in a.transformations]))
    ids = port_scenes.CORNELL_ANIM_ID
    for pos, nrm, mat in CD.QUADS:
        mesh = B.Mesh(np.array(pos, np.float32), np.array(nrm, np.float32), CD.UV,
                      indices=CD.IDX)
        scene.take_mesh_instance(B.MeshInstance(mesh, mats[mat], animation=ids.get(mat)))
    lpos, lnrm = CD.LIGHT_QUAD
    lmesh = B.Mesh(np.array(lpos, np.float32), np.array(lnrm, np.float32), CD.UV_LIGHT,
                   indices=CD.IDX)
    scene.take_mesh_instance(B.MeshInstance(lmesh, light, animation=ids["light"]),
                             hot_spot=True)
    if spheres:
        for c, r, a in port_scenes.CORNELL_ANIM_SPHERES:
            scene.take_sphere(B.SphereObject(c, r, mats["white"], animation=a or None))
    return scene.build(use_bvh=False)


def _cornell_animated():
    from wurblpt_tpu import CameraConfig, make_camera
    from wurblpt_tpu.utils import scenes
    from wurblpt_tpu_torch.utils import kernel_check as kc

    scene = jax_cornell_animated()
    pose, vfov = scenes.cornell_ref_camera()
    cam = make_camera(transformation=pose, vfov_deg=vfov, width=128, height=128)
    return scene, _frame(scene, cam, CameraConfig(), 128, 128, 4, 8, t=kc.ANIM_TIME)


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


def _tof(phase_index=0, depth=6):
    import jax

    from wurblpt_tpu import CameraConfig, RenderParams, SceneStatic, make_camera
    from wurblpt_tpu.core.transform import from_lookat
    from wurblpt_tpu.render.integrator import render_frame_wavefront
    from wurblpt_tpu.render.sensor import SensorTofAmcw
    from wurblpt_tpu.utils import scenes

    scene = scenes.tof_box().build()
    cam = make_camera(transformation=from_lookat((0.0, 0.0, 1.19), (0.0, 0.0, 0.0)),
                      vfov_deg=60.0, width=96, height=96)

    static = SceneStatic.from_scene(scene)
    fn = jax.jit(lambda s, c: render_frame_wavefront(
        s, static, c, CameraConfig(), SensorTofAmcw(phase_index=phase_index), 96, 96, 4,
        params=RenderParams(max_path_components=depth), return_stats=True,
        max_lanes=MAX_LANES))
    return scene, cam, lambda: fn(scene, cam)


def _tof_report():
    import numpy as np

    from wurblpt_tpu import CameraConfig, SceneStatic
    from wurblpt_tpu.render.aov import get_ground_truth
    from wurblpt_tpu.render.sensor import SensorTofAmcw

    for i in range(4):
        t0 = time.perf_counter()
        _, _, render = _tof(i)
        img, stats = render()
        img = np.asarray(img)
        img64 = img.astype(np.float64)
        print(json.dumps({"frame": "tof", "phase_index": i, "mean": float(img64.mean()),
                          "channels": [float(img64[..., c].mean()) for c in range(3)],
                          "mean_f32": float(img.mean()),
                          "channels_f32": [float(img[..., c].mean()) for c in range(3)],
                          "stats": [int(x) for x in np.asarray(stats)],
                          "render_s": time.perf_counter() - t0}))
    phases = []
    for i in range(4):
        scene, cam, render = _tof(i, depth=1)
        phases.append(SensorTofAmcw(phase_index=i).phase(render()[0]))
    dist, _, intensity = SensorTofAmcw().result(phases)
    truth = get_ground_truth(scene, SceneStatic.from_scene(scene), cam, CameraConfig(), 96, 96,
                             aovs=("distance", "hit_mask"))
    lit = (np.asarray(intensity) > 0) & (np.asarray(truth["hit_mask"]) > 0)
    err = np.abs(np.asarray(dist) - np.asarray(truth["distance"]))[lit]
    print(json.dumps({"frame": "tof", "depth": 1, "median_abs_err_m": float(np.median(err)),
                      "p90_abs_err_m": float(np.quantile(err, 0.9)),
                      "max_abs_err_m": float(err.max()), "lit_pixels": int(lit.sum())}))


FRAMES = {"city": _city, "envmap": _envmap, "rtiow": _rtiow, "tof": None,
          "cornell_animated": _cornell_animated}


def main():
    import numpy as np

    name = sys.argv[1] if len(sys.argv) > 1 else "city"
    if name not in FRAMES:
        raise SystemExit(f"usage: jax_frame_reference.py [{'|'.join(FRAMES)}]")
    if name == "tof":
        return _tof_report()
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
