"""Hold each hand-written kernel against its plain PyTorch version on the same
inputs, at the shapes the main path gives it.

Used by ``chip_smoke.py`` and the CUDA tests. Inputs are made with numpy from
a seed. Tolerances, and why (the kernels are built with -fmad=false, so on
the same card they should agree bit for bit; the margins cover what may
still differ, such as atan2f/asinf against PyTorch's):

* K1 closest hit: prim ids equal wherever the runner-up candidate is farther
  than 1e-5 * t (nearer ones are ties up to rounding); t/u/v rtol 1e-5,
  atol 1e-6 where both hit the same prim.
* K2 any hit: equal wherever the nearest candidate is not within 1e-5 *
  t_max of t_max.
* K3 hit assembly: integer fields equal, float fields atol 1e-5 on hit lanes.
* K5 BVH closest hit: prim ids, t, u and v equal bit for bit on every lane
  (kernel and plain version walk the same tree in the same order with the
  same roundings, so ties resolve alike).
* K6 BVH any hit: equal on every lane.
* K8 envmap: radiance rtol 1e-5, atol 1e-6 (the sun is 200, the sky ~1);
  sampled directions atol 1e-6; pdfs equal (a table lookup) on all but
  1e-4 of the lanes (an ulp of atan2f can move a direction across a cell
  edge). The cube and constant branches use no transcendental function:
  their radiance must be bit-equal.
* K7 RGL eval / sample: f*cos and pdf rtol 1e-5, atol 1e-6; `ok` equal on
  every lane, sampled directions atol 1e-6 where ok (kernel and plain
  version take the same row searches in the same order; a margin, not an
  expected difference).
* P0 row gather: equal word for word (a copy).
* KS1/KS2 sweeps (closest and any hit, static or animated): prim ids, t, u,
  v and the occlusion bit equal bit for bit on every lane (the same walk in
  the same order with the same roundings).
* K3a animated hit assembly: as K3 (integer fields equal, float fields
  atol 1e-5 on hit lanes).
* K4 (regeneration, shade, NEE resolve): on a frame's first block after 2
  steps, every output field compared lane by lane (`check_k4`; a lane owns
  rows i and N + i of the lit shade's shadow rays and pending deposits):
  discrete fields (active, bounce, prev_random, sample, k_next, shadow cast
  or not, the loop flag) may differ on at most 0.1 % of the lanes, floats
  within rtol 1e-4 / atol 1e-6 on the others (cosf/sinf in the cosine
  sample, the GGX VNDF and power-cosine samples, the env sample, the
  surround camera, RGL's sample and the ToF phase, powf in ModPhong's lobe,
  expf in the glass's absorption, atan2f/acosf/asinf in the sky's lookup
  and pdf and RGL's frame, are the operations that could part; an ulp of
  atan2f can move a direction across a pdf cell). Outputs a shade does not
  produce (no shadow ray without sky importance) must be absent from both.
  The regenerations and the lit shade write their inputs (the in-place
  contract of render/wavefront.py), so each call, the kernel's and the
  plain version's, gets its own copy of the inputs (`fresh_args`). The lit
  shade computes a shadow row's origin and direction only where the row
  casts: its shadow t_max must be bit-equal on every row, and its origins
  and directions are compared on the rows that cast (t_max > 0), which are
  the only rows K2/K6 read.

Also the seven frames the port renders and their yardsticks: the Cornell
bench frame, the mesh frame (bench config bvh_100k), the city frame (bench
config city_many_lights), the envmap frame (envmap_cube_is), the rtiow
frame (rtiow_distortion), the ToF frame (tof_amcw) and the animated Cornell
frame (cornell_animated, the bench's Cornell settings at t = 0.5), each with the JAX
package's deterministic CPU output at the bench settings, which the port's
render must meet (mean radiance, or mean energy, within 1e-3 relative, cast
counters within 0.5 %); and the ToF distance check at depth 1.

`bound_ms` is the least time an H100 could take for a kernel's work on the
given inputs: the larger of the bytes it must move (each input read once,
each output written once; a table that many lanes read, such as the BVH or
the hit rows, counts once) over 3.35 TB/s and its float32 operations over
67 TFLOP/s (the non-tensor FP32 peak at 700 W). The operation counts are
tallies of each kernel's arithmetic per unit of work, stated beside each
`*_work` function; where the work depends on the data (BVH walks, early
exits) it is counted on these inputs with the plain version.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from ..accel.traverse import (
    bvh_any_hit,
    bvh_any_hit_plain,
    bvh_closest_hit,
    bvh_closest_hit_plain,
    bvh_walk_counts,
)
from ..core import sampler
from ..core.onb import onb_from_normal_tangent, to_local
from ..materials.rgl import rgl_eval, rgl_eval_plain, rgl_sample, rgl_sample_plain
from ..render.bsdf import SceneStatic
from ..render.camera import CameraConfig, DistortionModel, SurroundMode, camera_rays, make_camera
from ..render.gather import row_gather, row_gather_plain
from ..render.envmap import (
    env_pdf,
    env_pdf_plain,
    env_radiance,
    env_radiance_plain,
    env_sample,
    env_sample_plain,
)
from ..render.integrator import RenderParams, frame_anim, prepare_scene, render_frame_wavefront
from ..render.intersect import (
    assemble_hit,
    assemble_hit_plain,
    build_hit_tables,
    scene_any_hit,
    scene_raw_hit,
)
from ..render.intersect_brute import (
    BIG,
    any_hit,
    any_hit_plain,
    build_brute_scene,
    candidate_t,
    closest_hit,
    closest_hit_plain,
)
from ..render.intersect_sweep import (
    any_sweep,
    any_sweep_plain,
    closest_sweep,
    closest_sweep_plain,
    ray_sphere_tile,
    ray_tri_tile,
)
from ..render.lights import light_frames, lights_sample
from ..render.sensor import SensorRGB, SensorTofAmcw
from ..scene.animation import anim_frames, frames_ray_to_object
from ..scene.ir import MaterialType
from . import scenes

MIN_HIT = RenderParams().min_hit_distance
SHADOW_EPS = RenderParams().shadow_identity_eps

# The Cornell bench frame: 128 x 128 pixels, 16 spp, 8 path components; one
# wavefront block holds 8 sample lanes per pixel (131072 lanes).
BENCH_WIDTH = 128
BENCH_SSQRT = 4
BENCH_DEPTH = 8
BENCH_LANES_M = 8
BENCH_LANES = BENCH_WIDTH * BENCH_WIDTH * BENCH_LANES_M
# The JAX package's deterministic CPU output for it: mean radiance and the
# cast counters (closest casts, all casts).
REF_MEAN = 0.0411764
REF_STATS = (1133568, 2080420)

# The mesh frame (bench.py bench_bvh_large): terrain_city(seed=3), 102098
# triangles with a BVH, 160 x 120 pixels, 4 spp (ssqrt 2), 4 path components;
# one wavefront block of 19200 pixels x 4 sample lanes.
MESH_WIDTH = 160
MESH_HEIGHT = 120
MESH_SSQRT = 2
MESH_DEPTH = 4
MESH_LANES_M = 4
MESH_LANES = MESH_WIDTH * MESH_HEIGHT * MESH_LANES_M
# The JAX package's deterministic CPU output for it (float64 mean of the f32
# image; cast counters).
MESH_REF_MEAN = 0.345844278874743
MESH_REF_STATS = (174435, 278267)

# The city frame (bench.py bench_city_many_lights): city_night(seed=7),
# 249218 triangles, 192 light triangles, 1920 x 1080, 360-degree stereo
# (eye distance 0.065), 1 spp, 4 path components. The JAX bench's 65536-lane
# host blocks work around a TPU fault; at 1 spp the image and the counters do
# not depend on the block size, and the port runs blocks of 1048576 lanes
# (two blocks per frame).
CITY_WIDTH = 1920
CITY_HEIGHT = 1080
CITY_SSQRT = 1
CITY_DEPTH = 4
CITY_EYE_DISTANCE = 0.065
CITY_CAMERA = CameraConfig(surround=SurroundMode.S360, stereo=True)
CITY_LANES = 1048576
# The JAX package's CPU output for it (float64 mean of the f32 image; cast
# counters): `JAX_PLATFORMS=cpu python jax_frame_reference.py` (host blocks
# of 131072 lanes).
CITY_REF_MEAN = 0.06086526045745766
CITY_REF_STATS = (3917102, 7996412)

# The envmap frame (bench.py bench_envmap_furnace, bench config
# envmap_cube_is): envmap_spheres(cube=True), 2 triangles and 3 spheres
# (glass, mirror, GGX) under the sky resampled to 32 x 32 cube faces with a
# 64 x 64 importance table, 128 x 128, 16 spp, 8 path components; one
# wavefront block of 16384 pixels x 8 sample lanes.
ENVMAP_WIDTH = 128
ENVMAP_SSQRT = 4
ENVMAP_DEPTH = 8
ENVMAP_LANES_M = 8
ENVMAP_LANES = ENVMAP_WIDTH * ENVMAP_WIDTH * ENVMAP_LANES_M
# The JAX package's CPU output for it (float64 mean of the f32 image; cast
# counters): `JAX_PLATFORMS=cpu python jax_frame_reference.py envmap`.
ENVMAP_REF_MEAN = 0.41563207641555283
ENVMAP_REF_STATS = (549890, 739419)

# The rtiow frame (bench.py bench_rtiow, bench config rtiow_distortion):
# rtiow(), 40 spheres and no triangle under a constant sky, 192 x 128,
# 16 spp, 8 path components, OpenCV lens distortion undistorted in 8
# fixed-point steps; one wavefront block of 24576 pixels x 4 sample lanes.
RTIOW_WIDTH = 192
RTIOW_HEIGHT = 128
RTIOW_SSQRT = 4
RTIOW_DEPTH = 8
RTIOW_LANES_M = 4
RTIOW_LANES = RTIOW_WIDTH * RTIOW_HEIGHT * RTIOW_LANES_M
RTIOW_CAMERA = CameraConfig(distortion=DistortionModel.OPENCV, undistort_iters=8)
RTIOW_LENS = dict(dist_k=(-0.1, 0.02, 0.0, 0.0, 0.0, 0.0), dist_p=(0.001, -0.001))
# The JAX package's CPU output for it: `JAX_PLATFORMS=cpu python
# jax_frame_reference.py rtiow`.
RTIOW_REF_MEAN = 0.5212965367257725
RTIOW_REF_STATS = (764846, 764846)

# The ToF frame (bench.py bench_tof, bench config tof_amcw): tof_box(), 54
# triangles of which 32 are the ToF light's (per-light MIS), 96 x 96, 16 spp,
# 6 path components, SensorTofAmcw at phase 0 (a, b, energy in J); one
# wavefront block of 9216 pixels x 8 sample lanes.
TOF_WIDTH = 96
TOF_SSQRT = 4
TOF_DEPTH = 6
TOF_LANES_M = 8
TOF_LANES = TOF_WIDTH * TOF_WIDTH * TOF_LANES_M
# The JAX package's CPU output for it: `JAX_PLATFORMS=cpu python
# jax_frame_reference.py tof`: the mean energy as bench.py takes it (numpy's
# float32 mean of the image; the float64 mean is 1.9563864290773862e-17),
# the float64 means of the channels a, b and energy, the counters.
TOF_REF_MEAN = 1.9563865388812146e-17
TOF_REF_CHANNELS = (8.513312771280554e-18, 2.083248367137625e-17, 2.934579642966479e-17)
TOF_REF_STATS = (683102, 1279784)
# The 4-phase distance at depth 1 (direct light only) against the first-hit
# distance of the pixel-centre camera rays: the JAX package's median |error|
# is 0.38 mm (p90 1.30 mm); the port must stay under 2 mm.
TOF_DISTANCE_MEDIAN_MAX = 2e-3

# The animated Cornell frame (cornell_animated): the reference box with three
# keyframe animations, keys at t = 0 and t = 1 (scenes.cornell_animations):
# the short box turns about the world's vertical axis (through the origin:
# its corners stay within 0.92 of the axis, inside the walls at 0.99), the
# tall box slides along +x, the ceiling light along +z. Rendered at one
# instant, t0 = t1 = ANIM_TIME, with the Cornell bench settings: 128 x 128,
# 16 spp, 8 path components, one block of 131072 lanes, SensorRGB.
ANIM_SHORT_TURN_DEG = 30.0
ANIM_TALL_SLIDE_X = 0.2
ANIM_LIGHT_SLIDE_Z = 0.2
ANIM_TIME = 0.5
# The JAX package's CPU output for it: `JAX_PLATFORMS=cpu python
# jax_frame_reference.py cornell_animated`.
ANIM_REF_MEAN = 0.043838444905687245
ANIM_REF_STATS = (1130662, 2073670)

# Camera rays over ROADMAP C.1's scenes (scenes.sphere_field,
# scenes.tri_sphere_field): 128 x 96 pixels x 8 sample lanes.
FIELD_WIDTH = 128
FIELD_HEIGHT = 96
FIELD_LANES_M = 8

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM
H100_FP32_PER_S = 67e12      # float32 outside the tensor cores, 700 W


def _frame(scene, camera, width, height, ssqrt, depth, device, cfg=CameraConfig(),
           eye_distance=0.0635, max_lanes=131072, lens=None, sensor=SensorRGB(),
           params=None, t: float = 0.0) -> Callable[[], tuple]:
    static = SceneStatic.from_scene(scene)
    pose, vfov = camera
    cam = make_camera(pose, vfov, width, height, eye_distance=eye_distance, device=device,
                      **(lens or {}))
    params = RenderParams(max_path_components=depth) if params is None else params
    tables = prepare_scene(scene, static)

    def render():
        img, stats = render_frame_wavefront(scene, static, cam, cfg, sensor,
                                            width, height, ssqrt, params=params,
                                            max_lanes=max_lanes, return_stats=True,
                                            device=device, tables=tables, t0=t, t1=t)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return img, stats

    return render


def bench_frame(device, depth: int = BENCH_DEPTH) -> Callable[[], tuple]:
    """A function that renders the Cornell bench frame on `device` through
    render_frame_wavefront and returns (image, stats) once the device is
    done; `depth` replaces the bench's 8 path components."""
    return _frame(scenes.cornell_box_ref(device), scenes.cornell_ref_camera(device),
                  BENCH_WIDTH, BENCH_WIDTH, BENCH_SSQRT, depth, device)


def mesh_frame(device, scene=None, depth: int = MESH_DEPTH) -> Callable[[], tuple]:
    """The same for the mesh frame; `scene` is terrain_city(seed=3) on
    `device`, built here when not given; `depth` replaces the bench's 4 path
    components."""
    scene = scenes.terrain_city(seed=3, device=device) if scene is None else scene
    return _frame(scene, scenes.terrain_camera(device), MESH_WIDTH, MESH_HEIGHT, MESH_SSQRT,
                  depth, device)


def city_frame(device, scene=None, depth: int = CITY_DEPTH) -> Callable[[], tuple]:
    """The same for the city frame; `scene` is city_night(seed=7) on `device`,
    built here when not given; `depth` replaces the bench's 4 path
    components."""
    scene = scenes.city_night(seed=7, device=device) if scene is None else scene
    return _frame(scene, scenes.city_camera(device), CITY_WIDTH, CITY_HEIGHT, CITY_SSQRT,
                  depth, device, CITY_CAMERA, CITY_EYE_DISTANCE, CITY_LANES)


def envmap_frame(device, scene=None, depth: int = ENVMAP_DEPTH) -> Callable[[], tuple]:
    """The same for the envmap frame; `scene` is envmap_spheres(cube=True) on
    `device`, built here when not given; `depth` replaces the bench's 8 path
    components."""
    scene = scenes.envmap_spheres(cube=True, device=device) if scene is None else scene
    return _frame(scene, scenes.envmap_camera(device), ENVMAP_WIDTH, ENVMAP_WIDTH, ENVMAP_SSQRT,
                  depth, device)


def rtiow_frame(device, scene=None, depth: int = RTIOW_DEPTH) -> Callable[[], tuple]:
    """The same for the rtiow frame; `scene` is rtiow() on `device`, built
    here when not given; `depth` replaces the bench's 8 path components."""
    scene = scenes.rtiow(device=device) if scene is None else scene
    return _frame(scene, scenes.rtiow_camera(device), RTIOW_WIDTH, RTIOW_HEIGHT, RTIOW_SSQRT,
                  depth, device, RTIOW_CAMERA, lens=RTIOW_LENS)


def tof_frame(device, scene=None, phase_index: int = 0, depth: int = TOF_DEPTH,
              width: int = TOF_WIDTH, ssqrt: int = TOF_SSQRT,
              randomize: bool = True) -> Callable[[], tuple]:
    """The same for the ToF frame at one phase image; `scene` is tof_box() on
    `device`, built here when not given. `depth`, `width` (= height), `ssqrt`
    and `randomize` (pixel jitter) change the bench settings for the checks
    below and the tests."""
    scene = scenes.tof_box(device=device) if scene is None else scene
    return _frame(scene, scenes.tof_camera(device), width, width, ssqrt, depth, device,
                  sensor=SensorTofAmcw(phase_index=phase_index),
                  params=RenderParams(max_path_components=depth,
                                      randomize_ray_over_pixel=randomize))


def cornell_animated_frame(device, scene=None, depth: int = BENCH_DEPTH,
                           width: int = BENCH_WIDTH, ssqrt: int = BENCH_SSQRT,
                           ) -> Callable[[], tuple]:
    """The same for the animated Cornell frame at t0 = t1 = ANIM_TIME;
    `scene` is cornell_box_animated() on `device`, built here when not
    given; `depth`, `width` (= height) and `ssqrt` change the bench settings
    for the tests."""
    scene = scenes.cornell_box_animated(device) if scene is None else scene
    return _frame(scene, scenes.cornell_ref_camera(device), width, width, ssqrt, depth, device,
                  t=ANIM_TIME)


def pixel_centre_distance(scene, camera, width: int, height: int, device):
    """[H, W] first-hit distance of the pixel-centre camera rays (K1's t; BIG
    on a miss): the ground truth of a ToF distance image."""
    pose, vfov = camera
    cam = make_camera(pose, vfov, width, height, device=device)
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    pxy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(torch.float32) + 0.5
    o, d = camera_rays(cam, CameraConfig(), pxy, width, height)
    n = o.shape[0]
    t, _, _, _ = scene_raw_hit(build_brute_scene(scene), o.contiguous(), d.contiguous(),
                               torch.full((n,), MIN_HIT, device=device),
                               torch.full((n,), BIG, device=device))
    return t.reshape(height, width)


def tof_distance_check(device, scene=None, width: int = TOF_WIDTH, ssqrt: int = TOF_SSQRT,
                       randomize: bool = True) -> Dict[str, float]:
    """The 4-phase ToF reconstruction at depth 1 (direct light only) against
    the first-hit distance of the pixel-centre camera rays: renders the four
    phase images of tof_box, converts them to electrons without noise,
    reconstructs the distance (SensorTofAmcw.result) and returns the median
    and 90th percentile of |distance - t| in metres over the lit pixels;
    raises AssertionError if the median exceeds TOF_DISTANCE_MEDIAN_MAX.
    Without `randomize` every sample takes the pixel centre."""
    scene = scenes.tof_box(device=device) if scene is None else scene
    sensor = SensorTofAmcw()
    phases = [SensorTofAmcw(phase_index=i).phase(
        tof_frame(device, scene, i, depth=1, width=width, ssqrt=ssqrt, randomize=randomize)()[0])
        for i in range(4)]
    dist, _, intensity = sensor.result(phases)
    truth = pixel_centre_distance(scene, scenes.tof_camera(device), width, width, device)
    lit = (intensity > 0) & (truth < BIG)
    err = (dist - truth)[lit].abs().double()
    res = {"median_abs_err_m": float(err.median()), "p90_abs_err_m": float(err.quantile(0.9)),
           "max_abs_err_m": float(err.max()), "lit_pixels": int(lit.sum()),
           "pixels": width * width}
    assert res["lit_pixels"] > 0.9 * res["pixels"], res
    assert res["median_abs_err_m"] <= TOF_DISTANCE_MEDIAN_MAX, res
    return res


def _check_frame(img, stats, shape, ref_mean, ref_stats) -> float:
    assert tuple(img.shape) == shape, img.shape
    assert bool(torch.isfinite(img).all()), "image has non-finite values"
    mean = float(img.double().mean())
    assert abs(mean - ref_mean) <= 1e-3 * ref_mean, f"mean radiance {mean} off {ref_mean}"
    counts = [int(x) for x in stats]
    for got, ref in zip(counts, ref_stats):
        assert abs(got - ref) <= 5e-3 * ref, f"cast counters {counts} off {ref_stats}"
    return mean


def check_bench_frame(img, stats) -> float:
    """Hold a Cornell bench frame to the JAX reference; returns its mean radiance."""
    return _check_frame(img, stats, (BENCH_WIDTH, BENCH_WIDTH, 3), REF_MEAN, REF_STATS)


def check_mesh_frame(img, stats) -> float:
    """Hold a mesh frame to the JAX reference; returns its mean radiance."""
    return _check_frame(img, stats, (MESH_HEIGHT, MESH_WIDTH, 3), MESH_REF_MEAN, MESH_REF_STATS)


def check_city_frame(img, stats) -> float:
    """Hold a city frame to the JAX reference; returns its mean radiance."""
    return _check_frame(img, stats, (CITY_HEIGHT, CITY_WIDTH, 3), CITY_REF_MEAN, CITY_REF_STATS)


def check_envmap_frame(img, stats) -> float:
    """Hold an envmap frame to the JAX reference; returns its mean radiance."""
    return _check_frame(img, stats, (ENVMAP_WIDTH, ENVMAP_WIDTH, 3), ENVMAP_REF_MEAN,
                        ENVMAP_REF_STATS)


def check_rtiow_frame(img, stats) -> float:
    """Hold an rtiow frame to the JAX reference; returns its mean radiance."""
    return _check_frame(img, stats, (RTIOW_HEIGHT, RTIOW_WIDTH, 3), RTIOW_REF_MEAN,
                        RTIOW_REF_STATS)


def check_cornell_animated_frame(img, stats) -> float:
    """Hold an animated Cornell frame to the JAX reference; returns its mean radiance."""
    return _check_frame(img, stats, (BENCH_WIDTH, BENCH_WIDTH, 3), ANIM_REF_MEAN, ANIM_REF_STATS)


def check_tof_frame(img, stats) -> float:
    """Hold a ToF frame (phase 0) to the JAX reference: its mean and counters
    as the other frames, and each channel's mean (a, b, energy) within 1e-3
    relative; returns its mean."""
    mean = _check_frame(img, stats, (TOF_WIDTH, TOF_WIDTH, 3), TOF_REF_MEAN, TOF_REF_STATS)
    for c, ref in enumerate(TOF_REF_CHANNELS):
        got = float(img[..., c].double().mean())
        assert abs(got - ref) <= 1e-3 * ref, f"channel {c} mean {got} off {ref}"
    return mean


def _f32(x, device):
    return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)


def camera_lanes(width: int, height: int, m: int, device, seed: int = 0, camera=None,
                 cfg=CameraConfig(), lens=None):
    """Bounce-0 rays of a bench frame: width x height pixels x m sample lanes
    (the wavefront's block), pixel jitter from numpy; `camera` is (pose,
    vfov), the Cornell bench camera by default; `lens` its distortion
    coefficients (dist_k, dist_p) for `cfg`'s model."""
    pose, vfov = scenes.cornell_ref_camera(device) if camera is None else camera
    cam = make_camera(pose, vfov, width, height, device=device, **(lens or {}))
    n = width * height * m
    pix = np.arange(n) % (width * height)
    jit = np.random.default_rng(seed).uniform(size=(n, 2))
    pxy = np.stack([pix % width, pix // width], -1) + jit
    o, d = camera_rays(cam, cfg, _f32(pxy, device), width, height)
    return (o.contiguous(), d.contiguous(), torch.full((n,), MIN_HIT, device=device),
            torch.full((n,), BIG, device=device))


def random_lanes(n: int, device, seed: int = 1, lo=(-1.2, -0.2, -1.2), hi=(1.2, 2.2, 3.5),
                 t_far: float = 2.5):
    """Rays from the box [lo, hi] (in and around the Cornell box by default)
    in random directions; a third with a finite t_max up to `t_far`, a tenth
    dead (t_max = 0), as later bounces produce them."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(lo, hi, size=(n, 3))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rs.uniform(size=n) < 0.33, rs.uniform(0.05, t_far, size=n), BIG)
    t_max = np.where(rs.uniform(size=n) < 0.1, 0.0, t_max)
    return (_f32(o, device), _f32(d, device), torch.full((n,), MIN_HIT, device=device),
            _f32(t_max, device))


def shadow_lanes(scene, bs, rays, seed: int = 2):
    """NEE shadow rays from the first hits of `rays` toward a sampled light
    point, shortened as the integrator does; lanes without a hit get t_max = 0."""
    o, d, t_min, t_max = rays
    t, prim, _, _ = closest_hit_plain(bs, o, d, t_min, t_max)
    pos = o + torch.where(prim >= 0, t, 1.0)[:, None] * d
    u3 = _f32(np.random.default_rng(seed).uniform(size=(o.shape[0], 3)), o.device)
    ldir, _, ldist, _, _ = lights_sample(scene, pos, u3)
    t_vis = torch.clamp_min(ldist * (1.0 - SHADOW_EPS), MIN_HIT)
    return (pos.contiguous(), ldir.contiguous(), t_min, torch.where(prim >= 0, t_vis, 0.0))


def check_closest_hit(bs, rays) -> Dict[str, float]:
    """K1 against its plain version; raises AssertionError on disagreement."""
    t, prim, u, v = closest_hit(bs, *rays)
    pt, pprim, pu, pv = closest_hit_plain(bs, *rays)
    c = torch.sort(candidate_t(bs, *rays), 1).values
    second = c[:, 1] if c.shape[1] > 1 else torch.full_like(c[:, 0], BIG)
    ok = (second - c[:, 0] > 1e-5 * c[:, 0]) | (c[:, 0] >= BIG)
    bad = int((ok & (prim != pprim)).sum())
    assert bad == 0, f"closest_hit: {bad} prim ids differ outside the tie margin"
    same = (prim == pprim) & (prim >= 0)
    err = 0.0
    for a, b in ((t, pt), (u, pu), (v, pv)):
        a, b = a[same], b[same]
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6), "closest_hit: t/u/v differ"
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
    return {"max_abs_err": err, "lanes": int(prim.shape[0]), "hits": int((prim >= 0).sum()),
            "ties": int((~ok).sum())}


def check_any_hit(bs, rays) -> Dict[str, float]:
    """K2 against its plain version; raises AssertionError on disagreement."""
    occ = any_hit(bs, *rays)
    pocc = any_hit_plain(bs, *rays)
    o, d, t_min, t_max = rays
    near = candidate_t(bs, o, d, t_min, torch.full_like(t_max, BIG)).min(1).values
    ok = ((near - t_max).abs() > 1e-5 * t_max) | (near >= BIG)
    diff = (occ != pocc) & ok
    assert not bool(diff.any()), f"any_hit: {int(diff.sum())} lanes differ outside the margin"
    return {"max_abs_err": float(diff.float().max()), "lanes": int(occ.shape[0]),
            "occluded": int(occ.sum())}


def check_assemble_hit(bs, ht, rays) -> Dict[str, float]:
    """K3 against its plain version on the winners of a plain closest-hit cast."""
    o, d = rays[0], rays[1]
    t, prim, u, v = closest_hit_plain(bs, *rays)
    hr = assemble_hit(ht, o, d, t, prim, u, v)
    ph = assemble_hit_plain(ht, o, d, t, prim, u, v)
    for f in ("hit", "prim", "mat", "backside"):
        assert torch.equal(getattr(hr, f), getattr(ph, f)), f"assemble_hit: {f} differs"
    h = ph.hit
    err = 0.0
    for f in ("position", "normal", "geom_normal", "tangent", "uv"):
        a, b = getattr(hr, f)[h], getattr(ph, f)[h]
        e = float((a - b).abs().max()) if a.numel() else 0.0
        assert e <= 1e-5, f"assemble_hit: {f} differs by {e}"
        err = max(err, e)
    return {"max_abs_err": err, "lanes": int(o.shape[0]), "hits": int(h.sum())}


def frames_at(scene, time: float = ANIM_TIME):
    """The rows of every animation of `scene` at one instant (anim_frames)."""
    return anim_frames(scene.anims, time)


def anim_shadow_lanes(scene, ss, frames, rays, seed: int = 2):
    """NEE shadow rays of an animated scene: from the first hits of `rays`
    (the plain sweep) toward a point sampled on the light where it is at
    the instant of `frames` (`frames_at`), shortened as the integrator does;
    lanes without a hit get t_max = 0."""
    o, d, t_min, t_max = rays
    t, prim, _, _ = closest_sweep_plain(ss, o, d, t_min, t_max, frames)
    pos = o + torch.where(prim >= 0, t, 1.0)[:, None] * d
    u3 = _f32(np.random.default_rng(seed).uniform(size=(o.shape[0], 3)), o.device)
    ldir, _, ldist, _, _ = lights_sample(scene, pos, u3, light_frames(scene, frames))
    t_vis = torch.clamp_min(ldist * (1.0 - SHADOW_EPS), MIN_HIT)
    return (pos.contiguous(), ldir.contiguous(), t_min, torch.where(prim >= 0, t_vis, 0.0))


def field_camera_lanes(device, seed: int = 0):
    """Bounce-0 rays over a C.1 field (98304 lanes)."""
    return camera_lanes(FIELD_WIDTH, FIELD_HEIGHT, FIELD_LANES_M, device, seed,
                        camera=scenes.field_camera(device))


def sky_shadow_lanes(cast, rays, seed: int = 3):
    """Shadow rays from the first hits of `rays` (`cast` gives them: a plain
    closest hit of the scene) toward random upper-hemisphere directions, to
    BIG; lanes without a hit get t_max = 0."""
    o, d, t_min, _ = rays
    t, prim, _, _ = cast(*rays)
    pos = o + torch.where(prim >= 0, t, 1.0)[:, None] * d
    rs = np.random.default_rng(seed)
    w = rs.normal(size=(o.shape[0], 3))
    w[:, 1] = np.abs(w[:, 1])
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    return (pos.contiguous(), _f32(w, o.device), t_min,
            torch.where(prim >= 0, BIG, 0.0).to(torch.float32))


def check_sweep_closest(ss, rays, frames=None) -> Dict[str, float]:
    """KS1 against its plain version, bit for bit on every lane; raises
    AssertionError on disagreement."""
    t, prim, u, v = closest_sweep(ss, *rays, frames)
    pt, pprim, pu, pv = closest_sweep_plain(ss, *rays, frames)
    bad = int((prim != pprim).sum())
    assert bad == 0, f"sweep_closest: {bad} prim ids differ"
    for name, a, b in (("t", t, pt), ("u", u, pu), ("v", v, pv)):
        diff = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        assert diff == 0, f"sweep_closest: {name} differs on {diff} lanes"
    return {"max_abs_err": 0.0, "lanes": int(prim.shape[0]), "hits": int((prim >= 0).sum()),
            "sphere hits": int((prim >= ss.n_tris).sum())}


def check_sweep_any(ss, rays, frames=None) -> Dict[str, float]:
    """KS2 against its plain version on every lane."""
    occ = any_sweep(ss, *rays, frames)
    pocc = any_sweep_plain(ss, *rays, frames)
    diff = int((occ != pocc).sum())
    assert diff == 0, f"sweep_any: {diff} lanes differ"
    return {"max_abs_err": 0.0, "lanes": int(occ.shape[0]), "occluded": int(occ.sum())}


def check_assemble_hit_sweep(ss, ht, rays, frames=None) -> Dict[str, float]:
    """K3 (K3a with `frames`) against its plain version on the winners of a
    plain sweep; the tolerances of K3."""
    o, d = rays[0], rays[1]
    t, prim, u, v = closest_sweep_plain(ss, *rays, frames)
    hr = assemble_hit(ht, o, d, t, prim, u, v, frames)
    ph = assemble_hit_plain(ht, o, d, t, prim, u, v, frames)
    for f in ("hit", "prim", "mat", "backside"):
        assert torch.equal(getattr(hr, f), getattr(ph, f)), f"assemble_hit: {f} differs"
    h = ph.hit
    err = 0.0
    for f in ("position", "normal", "geom_normal", "tangent", "uv"):
        a, b = getattr(hr, f)[h], getattr(ph, f)[h]
        e = float((a - b).abs().max()) if a.numel() else 0.0
        assert e <= 1e-5, f"assemble_hit: {f} differs by {e}"
        err = max(err, e)
    return {"max_abs_err": err, "lanes": int(o.shape[0]), "hits": int(h.sum()),
            "sphere hits": int((prim >= ss.n_tris).sum())}


def mesh_camera_lanes(device, seed: int = 0):
    """Bounce-0 rays of the mesh frame's block (76800 lanes)."""
    return camera_lanes(MESH_WIDTH, MESH_HEIGHT, MESH_LANES_M, device, seed,
                        camera=scenes.terrain_camera(device))


def terrain_random_lanes(n: int, device, seed: int = 1):
    """Random rays from above and below the terrain_city ground."""
    return random_lanes(n, device, seed, lo=(-20.0, -2.0, -20.0), hi=(20.0, 6.0, 20.0),
                        t_far=30.0)


def env_shadow_lanes(scene, rays, bs=None, seed: int = 2):
    """Env-NEE shadow rays from the first hits of `rays`, toward sky directions
    that env_sample draws, to BIG; lanes without a hit get t_max = 0. The
    hits come from the scene's BVH, or from its BruteScene `bs`."""
    o, d, t_min, _ = rays
    t, prim, _, _ = (bvh_closest_hit_plain(scene.bvh, *rays) if bs is None
                     else closest_hit_plain(bs, *rays))
    pos = o + torch.where(prim >= 0, t, 1.0)[:, None] * d
    u3 = _f32(np.random.default_rng(seed).uniform(size=(o.shape[0], 3)), o.device)
    edir, _ = env_sample_plain(scene.envmap, u3)
    return (pos.contiguous(), edir.contiguous(), t_min,
            torch.where(prim >= 0, BIG, 0.0).to(torch.float32))


def check_bvh_closest_hit(bvh, rays) -> Dict[str, float]:
    """K5 against its plain version, bit for bit on every lane; raises
    AssertionError on disagreement."""
    t, prim, u, v = bvh_closest_hit(bvh, *rays)
    pt, pprim, pu, pv = bvh_closest_hit_plain(bvh, *rays)
    bad = int((prim != pprim).sum())
    assert bad == 0, f"bvh_closest_hit: {bad} prim ids differ"
    for name, a, b in (("t", t, pt), ("u", u, pu), ("v", v, pv)):
        diff = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        assert diff == 0, f"bvh_closest_hit: {name} differs on {diff} lanes"
    hit = prim >= 0
    return {"max_abs_err": 0.0, "lanes": int(prim.shape[0]), "live": int((rays[3] > rays[2]).sum()),
            "hits": int(hit.sum())}


def check_bvh_any_hit(bvh, rays) -> Dict[str, float]:
    """K6 against its plain version; raises AssertionError on disagreement."""
    occ = bvh_any_hit(bvh, *rays)
    pocc = bvh_any_hit_plain(bvh, *rays)
    diff = int((occ != pocc).sum())
    assert diff == 0, f"bvh_any_hit: {diff} lanes differ"
    return {"max_abs_err": 0.0, "lanes": int(occ.shape[0]), "live": int((rays[3] > rays[2]).sum()),
            "occluded": int(occ.sum())}


def envmap_camera_lanes(device, seed: int = 0):
    """Bounce-0 rays of the envmap frame's block (131072 lanes)."""
    return camera_lanes(ENVMAP_WIDTH, ENVMAP_WIDTH, ENVMAP_LANES_M, device, seed,
                        camera=scenes.envmap_camera(device))


def rtiow_camera_lanes(device, seed: int = 0):
    """Bounce-0 rays of the rtiow frame's block (98304 lanes), OpenCV lens."""
    return camera_lanes(RTIOW_WIDTH, RTIOW_HEIGHT, RTIOW_LANES_M, device, seed,
                        camera=scenes.rtiow_camera(device), cfg=RTIOW_CAMERA, lens=RTIOW_LENS)


def random_directions(n: int, device, seed: int = 5):
    """Unit directions uniform on the sphere."""
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return _f32(d / np.linalg.norm(d, axis=-1, keepdims=True), device)


def cube_edge_directions(device, face_res: int = 32, seed: int = 6):
    """Directions where a cube lookup decides by ties and edges: the 6 axes,
    the 12 edge and 8 corner diagonals (|x| = |y| and the like), directions
    on the face edges (|x| = |z| > |y|, ...) and on every texel boundary of
    each face (u * F - 0.5 an integer), in both signs."""
    rs = np.random.default_rng(seed)
    axes = np.eye(3)
    pm = np.array([-1.0, 1.0])
    diag = [np.array([a, b, 0.0])[list(p)] for a in pm for b in pm for p in
            ((0, 1, 2), (0, 2, 1), (2, 0, 1))]
    corners = [np.array([a, b, c]) for a in pm for b in pm for c in pm]
    t = rs.uniform(-1, 1, 64)
    edges = [np.array([s1, v, s2])[list(p)] for v in t for s1 in pm for s2 in pm
             for p in ((0, 1, 2), (1, 0, 2), (0, 2, 1))]
    k = (np.arange(face_res + 1) + 0.5) / face_res * 2.0 - 1.0      # texel centres in (sc, tc)
    sc, tc = np.meshgrid(np.concatenate([k, np.linspace(-1, 1, face_res + 1)]),
                         rs.uniform(-1, 1, 8))
    grid = np.stack([sc.ravel(), tc.ravel(), np.ones(sc.size)], -1)
    faces = [grid[:, list(p)] * s for p in ((2, 0, 1), (0, 2, 1), (0, 1, 2)) for s in pm]
    d = np.concatenate([axes, -axes, np.array(diag), np.array(corners), np.array(edges), *faces])
    return _f32(d / np.linalg.norm(d, axis=-1, keepdims=True), device)


def check_envmap(env, dirs, u3=None) -> Dict[str, float]:
    """K8 against its plain versions: radiance on directions `dirs` [N, 3],
    and where the map has importance tables, sample on uniforms `u3` [N, 3]
    and pdf on `dirs`; raises AssertionError on disagreement."""
    rad, prad = env_radiance(env, dirs), env_radiance_plain(env, dirs)
    if env.kind == 1:
        assert torch.allclose(rad, prad, rtol=1e-5, atol=1e-6), "env_radiance differs"
    else:
        assert torch.equal(rad, prad), f"env_radiance (kind {env.kind}) is not bit-equal"
    if not env.importance:
        return {"max_abs_err": float((rad - prad).abs().max()), "lanes": int(dirs.shape[0])}
    (sd, spdf), (psd, pspdf) = env_sample(env, u3), env_sample_plain(env, u3)
    assert torch.allclose(sd, psd, rtol=0.0, atol=1e-6), "env_sample directions differ"
    pdf, ppdf = env_pdf(env, dirs), env_pdf_plain(env, dirs)
    n = dirs.shape[0]
    for name, a, b in (("env_sample", spdf, pspdf), ("env_pdf", pdf, ppdf)):
        off = int((a != b).sum())
        assert off <= 1e-4 * n, f"{name}: {off} of {n} pdfs differ"
    err = max(float((a - b).abs().max()) for a, b in ((rad, prad), (sd, psd), (spdf, pspdf),
                                                      (pdf, ppdf)))
    return {"max_abs_err": err, "lanes": n, "pdf_lanes_off": int((pdf != ppdf).sum()),
            "sample_pdf_lanes_off": int((spdf != pspdf).sum())}


def city_rgl_lanes(scene, device):
    """K7's inputs at the city frame's block width: (mid, wi, wo, u2), CITY_LANES
    lanes made from numpy seed 4.

    Half of the lanes (at most) are hits of the city frame's camera rays (every
    other pixel, 360-degree stereo), in the hit's tangent frame: wi toward the
    camera, wo a cosine-sampled bounce direction. The rest are random
    tangent-space lanes: wi and wo uniform on the sphere (below-horizon ones
    included). u2 is uniform; every lane uses material 0."""
    n = CITY_LANES
    rs = np.random.default_rng(4)
    pose, vfov = scenes.city_camera(device)
    cam = make_camera(pose, vfov, CITY_WIDTH, CITY_HEIGHT, eye_distance=CITY_EYE_DISTANCE,
                      device=device)
    pix = np.arange(0, CITY_WIDTH * CITY_HEIGHT, 2)
    pxy = np.stack([pix % CITY_WIDTH, pix // CITY_WIDTH], -1) + rs.uniform(size=(len(pix), 2))
    o, d = camera_rays(cam, CITY_CAMERA, _f32(pxy, device), CITY_WIDTH, CITY_HEIGHT)
    m = o.shape[0]
    t, prim, u, v = scene_raw_hit(scene.bvh, o.contiguous(), d.contiguous(),
                                  torch.full((m,), MIN_HIT, device=device),
                                  torch.full((m,), BIG, device=device))
    hr = assemble_hit(build_hit_tables(scene), o.contiguous(), d.contiguous(), t, prim, u, v)
    keep = torch.nonzero(hr.hit)[: n // 2, 0]
    tb = onb_from_normal_tangent(hr.normal[keep], hr.tangent[keep])
    nrm = hr.normal[keep]
    bounce = sampler.cosine_direction(nrm, _f32(rs.uniform(size=(keep.shape[0], 2)), device))
    wi_c = to_local(-d[keep], *tb, nrm)
    wo_c = to_local(bounce, *tb, nrm)

    def sphere(k):
        x = rs.normal(size=(k, 3))
        return _f32(x / np.linalg.norm(x, axis=-1, keepdims=True), device)

    k = n - keep.shape[0]
    wi = torch.cat([wi_c, sphere(k)]).contiguous()
    wo = torch.cat([wo_c, sphere(k)]).contiguous()
    u2 = _f32(rs.uniform(size=(n, 2)), device)
    return torch.zeros((n,), dtype=torch.int32, device=device), wi, wo, u2


def city_env_lanes(device, seed: int = 8):
    """K8's inputs on the city frame's first block: the bounce-0 directions
    of its CITY_LANES pixels (360-degree stereo, pixel jitter from numpy),
    which the sky is looked up and its pdf taken at where they escape, and
    CITY_LANES uniforms [N, 3] for the sky's sample."""
    rs = np.random.default_rng(seed)
    pose, vfov = scenes.city_camera(device)
    cam = make_camera(pose, vfov, CITY_WIDTH, CITY_HEIGHT, eye_distance=CITY_EYE_DISTANCE,
                      device=device)
    pix = np.arange(CITY_LANES)
    pxy = np.stack([pix % CITY_WIDTH, pix // CITY_WIDTH], -1) + rs.uniform(size=(CITY_LANES, 2))
    _, d = camera_rays(cam, CITY_CAMERA, _f32(pxy, device), CITY_WIDTH, CITY_HEIGHT)
    return d.contiguous(), _f32(rs.uniform(size=(CITY_LANES, 3)), device)


def check_rgl(tables, lanes) -> Dict[str, float]:
    """K7's two entry points against their plain versions on lanes (mid, wi, wo, u2)."""
    mid, wi, wo, u2 = lanes
    (f, p), (pf, pp) = rgl_eval(tables, mid, wi, wo), rgl_eval_plain(tables, mid, wi, wo)
    sd, sf, sp, ok = rgl_sample(tables, mid, wi, u2)
    psd, psf, psp, pok = rgl_sample_plain(tables, mid, wi, u2)
    off = int((ok != pok).sum())
    assert off == 0, f"rgl_sample: ok differs on {off} lanes"
    for name, a, b in (("rgl_eval f*cos", f, pf), ("rgl_eval pdf", p, pp),
                       ("rgl_sample f*cos", sf, psf), ("rgl_sample pdf", sp, psp)):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6), f"{name} differs"
    assert torch.allclose(sd[ok], psd[ok], rtol=0.0, atol=1e-6), "rgl_sample directions differ"
    err = max(float((a - b).abs().max()) for a, b in ((f, pf), (p, pp), (sf, psf), (sp, psp),
                                                       (sd[ok], psd[ok])))
    return {"max_abs_err": err, "lanes": int(mid.shape[0]), "eval_nonzero": int((p > 0).sum()),
            "sample_ok": int(ok.sum())}


def check_row_gather(table, idx) -> Dict[str, float]:
    """P0 against its plain version: equal word for word."""
    out, ref = row_gather(table, idx), row_gather_plain(table, idx)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), "row_gather differs"
    return {"max_abs_err": 0.0, "rows": int(idx.shape[0]), "cols": int(table.shape[1])}


def probe_gather_inputs(device):
    """The Pallas probe's own shapes (tools/probe_pallas_gather.py): a [512, 128]
    f32 table with 256 row indices, and a [512] vector (as [512, 1]) with
    [8, 128] indices (flattened), from numpy seed 0."""
    rs = np.random.RandomState(0)
    table = _f32(rs.randn(512, 128), device)
    idx = rs.randint(0, 512, (8, 128)).astype(np.int32)
    rows = rs.randint(0, 512, (256,)).astype(np.int32)
    vec = _f32(rs.randn(512, 1), device)
    return ((table, torch.as_tensor(rows, device=device)),
            (vec, torch.as_tensor(idx.reshape(-1), device=device)))


class K4Inputs(NamedTuple):
    """Identical inputs of K4's three entry points, from one frame's first block."""

    regen: tuple      # regen_pinhole(*regen) or regen_surround(*regen)
    shade: tuple      # shade_diffuse / shade_env / shade_lit(*shade), st.stats replaced per call
    resolve: tuple    # nee_resolve(*resolve)


def k4_route(inputs: K4Inputs):
    """The regeneration and the shade of `inputs`' class and camera
    (wavefront.K4Route)."""
    from ..render import wavefront as wf

    return wf.k4_route(inputs.shade[0], inputs.regen[4])


def regenerated_lanes(inputs: K4Inputs) -> int:
    """How many lanes the regeneration on `inputs` refills: dead lanes whose
    pixel has samples left. A check or a time of the regeneration on inputs
    where none is means a copy of the state, not a regeneration."""
    st, _, k_next, _, _, lanes, _ = inputs.regen
    return int(((~st.active) & (k_next < lanes.P) & lanes.valid).sum())


def k4_inputs(device, frame: str = "cornell", steps: int = 2, width: int = 0, ssqrt: int = 0,
              m: int = 0, height: int = 0, scene=None, sensor=None, cfg=None) -> K4Inputs:
    """The inputs of K4's kernels on the first block of the Cornell bench
    frame (131072 lanes), the animated Cornell frame (cornell_animated, the
    same lanes at t = ANIM_TIME: the sweeps' casts, K3a, the moving light
    in the step tables), the ToF frame (phase 0, 73728 lanes), the mesh
    frame (76800 lanes), the envmap frame (131072 lanes), the rtiow frame
    (98304 lanes, through its OpenCV lens) or the city frame (1048576 of its
    2073600 pixels at 1 spp, 360-degree stereo), after `steps` wavefront
    steps of the plain route (regen_plain, the scene's closest-hit cast, K3,
    the class's plain shade, the scene's any-hit cast where the shade casts
    shadow rays, nee_resolve_plain): lanes live, dead and (with more than
    one sample per lane) due for regeneration side by side. The
    regeneration's inputs are that state; the shade's, the state after one
    more plain regeneration and its casts; the resolve's, the plain shade's
    pending deposits and their shadow casts. `width`, `height` (= width
    when only `width` is given), `ssqrt`, `m` (sample lanes per pixel),
    `scene`, `sensor` and the camera config `cfg` (the lens model) replace
    the frame's own where given; a block holds at most the frame's lanes
    (131072, the city's 1048576) over m."""
    from ..render import wavefront as wf

    lens = None
    own_cfg = CameraConfig()
    eye_distance, max_lanes = 0.0635, 131072
    if frame in ("cornell", "cornell_animated"):
        own = ((scenes.cornell_box_ref if frame == "cornell" else scenes.cornell_box_animated),
               scenes.cornell_ref_camera)
        size = (BENCH_WIDTH, BENCH_WIDTH, BENCH_SSQRT, BENCH_LANES_M)
        depth, own_sensor = BENCH_DEPTH, SensorRGB()
    elif frame == "tof":
        own = (lambda dev: scenes.tof_box(device=dev)), scenes.tof_camera
        size = (TOF_WIDTH, TOF_WIDTH, TOF_SSQRT, TOF_LANES_M)
        depth, own_sensor = TOF_DEPTH, SensorTofAmcw()
    elif frame == "mesh":
        own = (lambda dev: scenes.terrain_city(seed=3, device=dev)), scenes.terrain_camera
        size = (MESH_WIDTH, MESH_HEIGHT, MESH_SSQRT, MESH_LANES_M)
        depth, own_sensor = MESH_DEPTH, SensorRGB()
    elif frame == "envmap":
        own = (lambda dev: scenes.envmap_spheres(cube=True, device=dev)), scenes.envmap_camera
        size = (ENVMAP_WIDTH, ENVMAP_WIDTH, ENVMAP_SSQRT, ENVMAP_LANES_M)
        depth, own_sensor = ENVMAP_DEPTH, SensorRGB()
    elif frame == "rtiow":
        own = (lambda dev: scenes.rtiow(device=dev)), scenes.rtiow_camera
        size = (RTIOW_WIDTH, RTIOW_HEIGHT, RTIOW_SSQRT, RTIOW_LANES_M)
        depth, own_sensor, own_cfg, lens = RTIOW_DEPTH, SensorRGB(), RTIOW_CAMERA, RTIOW_LENS
    elif frame == "city":
        own = (lambda dev: scenes.city_night(seed=7, device=dev)), scenes.city_camera
        size = (CITY_WIDTH, CITY_HEIGHT, CITY_SSQRT, 1)
        depth, own_sensor, own_cfg = CITY_DEPTH, SensorRGB(), CITY_CAMERA
        eye_distance, max_lanes = CITY_EYE_DISTANCE, CITY_LANES
    else:
        raise ValueError(f"k4_inputs: no frame {frame!r}")
    scene = own[0](device) if scene is None else scene
    sensor = own_sensor if sensor is None else sensor
    cfg = own_cfg if cfg is None else cfg
    camera = own[1](device)
    height = height or (width if width else size[1])
    width, ssqrt, m = (given or mine for given, mine in zip((width, ssqrt, m),
                                                             (size[0], *size[2:])))
    static = SceneStatic.from_scene(scene)
    assert (wf.diffuse_class(scene, static, cfg) or wf.env_class(scene, static, cfg)
            or wf.lit_class(scene, static, cfg))
    params = RenderParams(max_path_components=depth)
    cam = make_camera(camera[0], camera[1], width, height, eye_distance=eye_distance,
                      device=device, **(lens or {}))
    B = min(width * height, max_lanes // m)
    L = B * m
    lanes = wf.block_lanes(0, B, m, ssqrt * ssqrt // m, width, height, ssqrt, device)
    prepared = prepare_scene(scene, static)
    anim = frame_anim(scene, static, ANIM_TIME)
    frames = None if anim is None else anim.frames
    accel, ht = prepared.accel, prepared.hit
    tables = wf.step_tables_at(prepared.step, None if anim is None else anim.lights)
    route = wf.k4_route(tables, cfg)
    f32 = dict(dtype=torch.float32, device=device)
    z = lambda *shape: torch.zeros(shape, **f32)  # noqa: E731
    st = wf.LoopState(
        bounce=torch.zeros((L,), dtype=torch.int64, device=device), o=z(L, 3),
        d=torch.tensor([0.0, 0.0, 1.0], **f32).expand(L, 3).contiguous(), ior=z(L, 4) + 1.0,
        throughput=z(L, 4), active=torch.zeros((L,), dtype=torch.bool, device=device),
        acc=z(L, 3), geom_len=z(L), opt_len=z(L, 4), prev_pdf=z(L),
        prev_random=torch.zeros((L,), dtype=torch.bool, device=device), prev_light_pdf=z(L),
        stats=torch.zeros((2,), dtype=torch.int64, device=device))
    sample = torch.zeros((L,), dtype=torch.int64, device=device)
    k_next = torch.zeros_like(sample)
    t_min = torch.full((route.shadow_rows * L,), MIN_HIT, **f32)

    for k in range(steps + 1):
        regen_args = (st, sample, k_next, cam, cfg, lanes, True)
        st, sample, k_next, t_max = wf.regen_plain(*regen_args)
        t, prim, u, v = scene_raw_hit(accel, st.o, st.d, t_min[:L], t_max, frames)
        hr = assemble_hit(ht, st.o, st.d, t, prim, u, v, frames)
        shade_args = (tables, sensor, params, st, lanes.pixel, sample, t, prim, hr)
        st, so, sd, stmax, pending = route.shade_plain(*shade_args)
        occ = None if stmax is None else scene_any_hit(accel, so, sd, t_min, stmax, frames)
        resolve_args = (st.acc, pending, occ, st.active, k_next, lanes)
        if k == steps:
            break
        acc, _ = wf.nee_resolve_plain(*resolve_args)
        st = st._replace(acc=acc)
    return K4Inputs(regen_args, shade_args, resolve_args)


def _named(out, names):
    """name -> tensor of a kernel's outputs; a LoopState contributes its
    fields; an output that is None (no shadow ray) none."""
    named = {}
    for name, x in zip(names, out):
        if x is None:
            continue
        if isinstance(x, tuple):
            named.update({f"{name}.{f}": v for f, v in zip(x._fields, x) if f != "stats"})
        else:
            named[name] = x
    return named


def _rows_per_lane(f, a, n) -> int:
    """How many rows of output `f` each of the n lanes owns: 1 for a lane
    field [n, ...], 2 for the lit shade's shadow rays and pending deposits
    [2 n, ...] (rows i and n + i are lane i's), 0 for the counters and the
    loop flag."""
    if f in ("stats", "work") or a.dim() == 0:
        return 0
    return a.shape[0] // n if a.shape[0] in (n, 2 * n) else 0


def _compare(got, ref, n) -> Dict[str, float]:
    """Per output field: max |error| of a float field (NaN equal to NaN),
    the number of rows on which a bool or integer field differs; and
    `lanes_discrete_differ`, the lanes on which any discrete field differs
    (a lane owns its rows in every field: `_rows_per_lane`). Raises
    AssertionError if those exceed 0.1 % of the lanes, or a float field
    exceeds rtol 1e-4 / atol 1e-6 on the other lanes' rows."""
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    res, discrete = {}, torch.zeros((n,), dtype=torch.bool, device=next(iter(got.values())).device)
    for f, a in got.items():
        b = ref[f]
        assert a.shape == b.shape and a.dtype == b.dtype, (f, a.shape, b.shape)
        if not a.dtype.is_floating_point:
            k = _rows_per_lane(f, a, n)
            diff = (a != b).reshape(a.shape[0], -1).any(-1) if k else (a != b)
            res[f] = int(diff.sum())
            if k:
                discrete |= diff.reshape(k, n).any(0)
    res["lanes_discrete_differ"] = int(discrete.sum())
    assert res["lanes_discrete_differ"] <= 1e-3 * n, res
    for f, a in got.items():
        b = ref[f]
        if a.dtype.is_floating_point:
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            res[f] = float((a - b).abs()[~same].max()) if bool((~same).any()) else 0.0
            k = _rows_per_lane(f, a, n)
            keep = (~discrete).repeat(k) if k else torch.ones(a.shape[:1], dtype=torch.bool,
                                                             device=a.device)
            ok = torch.isclose(a[keep], b[keep], rtol=1e-4, atol=1e-6, equal_nan=True)
            assert bool(ok.all()), f"{f} differs beyond rtol 1e-4 on {int((~ok).sum())} lanes"
    return res


def fresh_args(args) -> tuple:
    """A copy of a K4 call's arguments whose lane state (the LoopState and
    each tensor argument: sample ids, next sample indices, pixels, the cast)
    is cloned, so that an in-place kernel writes the copy and not `args`."""
    from ..render.wavefront import LoopState

    def copy(x):
        if isinstance(x, LoopState):
            return LoopState(*(v.clone() for v in x))
        return x.clone() if isinstance(x, torch.Tensor) else x
    return tuple(copy(x) for x in args)


def restore_args(dst, src) -> None:
    """Copy the lane state of `src` (a `fresh_args` copy) back into `dst`."""
    from ..render.wavefront import LoopState

    for a, b in zip(dst, src):
        if isinstance(a, LoopState):
            for x, y in zip(a, b):
                x.copy_(y)
        elif isinstance(a, torch.Tensor):
            a.copy_(b)


REGEN_OUT = ("state", "sample", "k_next", "t_max")
SHADE_OUT = ("state", "shadow_o", "shadow_d", "shadow_tmax", "pending", "stats")


def check_call(kernel, plain, args, lit_rows: bool = False,
               exact_rows: bool = True) -> Dict[str, float]:
    """`kernel` against `plain` (a regeneration or a shade and their plain
    versions), each on its own copy of `args` (see `_compare`). A shade's
    counters are compared too; with `lit_rows` (the lit shade) the shadow
    t_max must be bit-equal on every row (`exact_rows`; else it is held as
    any float field, for a build whose libm is not the card's) and the
    shadow origins and directions are compared on the rows that cast only."""
    regen = len(args) == 7
    names = REGEN_OUT if regen else SHADE_OUT

    def run(fn):
        a = fresh_args(args)
        out = fn(*a)
        return _named(out if regen else out + (a[3].stats,), names)

    got, ref = run(kernel), run(plain)
    if "shadow_tmax" in got:
        if lit_rows and exact_rows:
            same = ((got["shadow_tmax"] == ref["shadow_tmax"])
                    | (torch.isnan(got["shadow_tmax"]) & torch.isnan(ref["shadow_tmax"])))
            assert bool(same.all()), f"shadow t_max differs on {int((~same).sum())} rows"
        if lit_rows:
            cast = ((ref["shadow_tmax"] > 0) & (got["shadow_tmax"] > 0))[:, None]
            for f in ("shadow_o", "shadow_d"):
                got[f], ref[f] = torch.where(cast, got[f], 0.0), torch.where(cast, ref[f], 0.0)
        for out in (got, ref):
            out["shadow_cast"] = out["shadow_tmax"] > 0
    return _compare(got, ref, args[0].active.shape[0] if regen else args[3].active.shape[0])


def check_k4(inputs: K4Inputs) -> Dict[str, Dict[str, float]]:
    """Each of K4's kernels against its plain version on `inputs` (see
    `check_call`, `_compare`): {kernel: {field: max |error| or differing
    lanes}}, the regeneration and the shade of `inputs`' class and camera
    (`k4_route`). Every call gets its own copy of the inputs, which stay as
    they were. Bit equality shows as 0 everywhere."""
    from ..render import wavefront as wf

    n = inputs.regen[0].active.shape[0]
    route = k4_route(inputs)
    res = {route.regen.__name__: check_call(route.regen, wf.regen_plain, inputs.regen),
           route.shade.__name__: check_call(route.shade, route.shade_plain, inputs.shade,
                                            lit_rows=route.shade is wf.shade_lit)}
    names = ("acc", "work")
    res["nee_resolve"] = _compare(_named(wf.nee_resolve(*inputs.resolve), names),
                                  _named(wf.nee_resolve_plain(*inputs.resolve), names), n)
    return res


def _lane_bytes(*tensors) -> int:
    """Bytes one lane holds in the lane-major tensors `tensors` ([N, ...])."""
    return sum(x.element_size() * (x.numel() // x.shape[0]) for x in tensors)


# Float operations per regenerated lane of the lens models' inverses: the
# closed form, the 4-term series, one fixed-point step of the OpenCV model.
LENS_FLOPS = {DistortionModel.NONE: 0.0, DistortionModel.RADIAL_AND_PLANAR: 40.0,
              DistortionModel.RADIAL_ONLY: 35.0, DistortionModel.OPENCV: 30.0}
# Float operations per escaped lane of the sky's lookup, by kind (equirect,
# cube, constant), and of its importance pdf.
SKY_LOOKUP_FLOPS = {1: 60.0, 2: 60.0, 3: 0.0}
SKY_PDF_FLOPS = 60.0


def k4_work(inputs: K4Inputs, kernel: str, in_place: bool = True):
    """(bytes, flops) of one K4 kernel on `inputs`: what each lane's branch
    reads, each input once, each output written once, the small tables once;
    the sizes are those of the tensors the kernel takes. The regenerations
    and the lit shade update the lane state in place: a lane pays only the
    fields its branch reads and changes (`in_place=False`: the bound of the
    earlier kernels, which wrote every lane's whole state anew; the
    regeneration: each lane's flags and its old state where it is kept).
    The regeneration in place reads every lane's active flag and a dead
    lane's next sample index, writes every lane's t_max and a regenerated
    lane's state, sample id and next sample index. Flops are tallies of
    the code per lane: the regeneration ~60 per regenerated lane (jitter, the
    pinhole ray, its rotation) plus the lens model's inverse (`LENS_FLOPS`,
    per step of the OpenCV fixed point); the diffuse shade ~250 per lane
    (emission, the cosine sample, light sample and pdf, the roulette) and 2 x
    70 per light on RANDOM lanes of a mixture scene (counted with the plain
    version); the env shade ~170 per lane (emission, the roulette) and 80
    more for the sky sample where the sky is importance-sampled, per escaped
    lane the sky's lookup (`SKY_LOOKUP_FLOPS`) and its pdf
    (`SKY_PDF_FLOPS`, importance only), ~60 per Lambertian, ~350 per GGX
    (the VNDF sample and two evaluations) and ~100 per glass hit (Fresnel,
    refraction, four absorption exponentials), ~80 per RANDOM lane with
    importance (the sky's lookup toward the sample, the weight); the lit
    shade as `_lit_shade_work` says; the surround regeneration ~180 per
    regenerated lane (four sines and cosines, two rotations); the resolve
    one add per accumulator channel on each unoccluded row."""
    if kernel in ("regen_pinhole", "regen_surround"):
        st, sample, k_next, cam, cfg, lanes, _ = inputs.regen
        n = st.active.shape[0]
        n_need = regenerated_lanes(inputs)
        state = [getattr(st, f) for f in st._fields if f not in ("acc", "stats")]
        kept = [getattr(st, f) for f in st._fields
                if f not in ("acc", "stats", "active", "prev_random")]
        tf = cam.transformation
        if kernel == "regen_surround":
            camera, per_lane = [tf.translation, tf.rotation, tf.scale, cam.eye_distance], 180.0
        else:
            camera = [cam.center_px, cam.focal_px, tf.translation, tf.rotation]
            per_lane = 60.0 + LENS_FLOPS[cfg.distortion] * (
                cfg.undistort_iters if cfg.distortion == DistortionModel.OPENCV else 1)
            if cfg.distortion != DistortionModel.NONE:
                camera += [cam.dist_k, cam.dist_p]
        if in_place:
            n_dead = int((~st.active).sum())
            n_bytes = (n * _lane_bytes(st.active, st.geom_len)          # geom_len: t_max
                       + n_dead * _lane_bytes(k_next)
                       + n_need * _lane_bytes(*state, sample, k_next))
            return n_bytes + _table_bytes(camera), per_lane * n_need
        read = (n * _lane_bytes(st.active, k_next, st.prev_random)
                + (n - n_need) * _lane_bytes(sample, *kept))
        written = n * _lane_bytes(*state, sample, k_next, st.geom_len)      # geom_len: t_max
        return read + written + _table_bytes(camera), per_lane * n_need
    if kernel == "shade_lit":
        return _lit_shade_work(inputs) if in_place else _lit_shade_copy_work(inputs)
    if kernel == "shade_diffuse":
        tables, _, _, st, pixel, sample, t, prim, hr = inputs.shade
        n = st.active.shape[0]
        hit = (prim >= 0) & st.active
        weighted = hit & st.prev_random
        every_lane = [st.active, st.bounce, st.d, st.throughput, st.acc, st.geom_len,
                      st.opt_len, pixel, sample, hr.position]        # position: the shadow ray
        read = (n * _lane_bytes(*every_lane) + int(st.active.sum()) * _lane_bytes(prim)
                + int((~hit).sum()) * _lane_bytes(st.o)
                + int(hit.sum()) * _lane_bytes(t, st.ior, hr.normal, hr.backside, hr.mat,
                                               st.prev_random)
                + int(weighted.sum()) * _lane_bytes(st.prev_pdf, hr.geom_normal
                                                    if tables.per_light else st.prev_light_pdf))
        written = n * _lane_bytes(*(getattr(st, f) for f in st._fields
                                    if f not in ("ior", "stats")),
                                  hr.position, t, st.acc)          # shadow d, t_max, pending
        rows = [tables.mat, tables.light_tri, tables.light_mat, tables.light_w,
                tables.alias_prob, tables.alias_idx]
        if tables.per_light:
            rows.append(tables.pick_area)
        per_light = 0.0
        if not tables.per_light:
            args = list(inputs.shade)
            args[3] = st._replace(stats=st.stats.clone())
            from ..render import wavefront as wf

            rnd = float(wf.shade_diffuse_plain(*args)[0].prev_random.sum())
            per_light = 140.0 * tables.n_lights * rnd
        return read + written + _table_bytes(rows) + 16, 250.0 * n + per_light
    if kernel == "shade_env":
        from ..render import wavefront as wf

        tables, _, _, st, pixel, sample, t, prim, hr = inputs.shade
        env = tables.env
        imp = env.importance
        glass = MaterialType.GLASS in tables.mat_types
        n = st.active.shape[0]
        hit = (prim >= 0) & st.active
        escaped = st.active & (prim < 0)
        typ = tables.mat[:, 20].contiguous().view(torch.int32)[hr.mat.long()]
        ggx = hit & (typ == MaterialType.GGX)
        lamb = hit & (typ == MaterialType.LAMBERTIAN)
        n_glass = int((hit & (typ == MaterialType.GLASS)).sum())
        args = list(inputs.shade)
        args[3] = st._replace(stats=st.stats.clone())
        n_random = float(wf.shade_env_plain(*args)[0].prev_random.sum()) if imp else 0.0
        # The ray IOR: read on hit lanes (the optical path length); with glass
        # on every lane, and written back.
        every_lane = [st.active, st.bounce, st.d, st.throughput, st.acc, st.geom_len,
                      st.opt_len, pixel, sample] + ([st.ior] if glass else [])
        on_hit = [t, hr.position, hr.normal, hr.backside, hr.mat] + ([] if glass else [st.ior])
        read = (n * _lane_bytes(*every_lane) + int(st.active.sum()) * _lane_bytes(prim)
                + int((~hit).sum()) * _lane_bytes(st.o) + int(hit.sum()) * _lane_bytes(*on_hit)
                + int(ggx.sum()) * _lane_bytes(hr.tangent))
        if imp:     # the previous bsdf sample's flag and pdf: the MIS weight of a miss
            read += (int(escaped.sum()) * _lane_bytes(st.prev_random)
                     + int((escaped & st.prev_random).sum()) * _lane_bytes(st.prev_pdf))
        out = [getattr(st, f) for f in st._fields
               if f not in ("ior", "prev_light_pdf", "stats")] + ([st.ior] if glass else [])
        if imp:
            out += [hr.position, t, st.acc]                   # shadow d, t_max, pending
        rows = ([env.const_radiance] if env.kind == 3 else [env.image, env.rotation])
        if imp:
            rows += [env.pdf_table, env.alias_prob, env.alias_idx]
        escaped_flops = SKY_LOOKUP_FLOPS[env.kind] + (SKY_PDF_FLOPS if imp else 0.0)
        flops = ((170.0 + 80.0 * imp) * n + escaped_flops * int(escaped.sum())
                 + 60.0 * int(lamb.sum()) + 350.0 * int(ggx.sum()) + 100.0 * n_glass
                 + 80.0 * n_random)
        return (read + n * _lane_bytes(*out) + _table_bytes([tables.mat] + rows) + 16, flops)
    acc, pending, occluded, active, k_next, _ = inputs.resolve
    n, n_acc = acc.shape
    if pending is None:         # the loop condition alone
        return n * _lane_bytes(active) + int((~active).sum()) * _lane_bytes(k_next) + 4, 0.0
    n_open = int((~occluded).sum())       # unoccluded rows (two per lane in the lit class)
    read = (n * _lane_bytes(acc, active) + occluded.numel() * occluded.element_size()
            + n_open * _lane_bytes(pending) + int((~active).sum()) * _lane_bytes(k_next))
    return read + n * _lane_bytes(acc) + 4, float(n_open * n_acc)


# Float operations of the lit shade: per hit lane of each material type
# (the sample: Lambertian's cosine, GGX's VNDF sample and evaluation,
# mirror, glass's Fresnel term and refraction, ModPhong's lobe pick and
# mixture, RGL's two warps and reflectance), and per RANDOM lane of each
# type of one bsdf evaluation (two per lane: toward the light and the sky).
LIT_SAMPLE_FLOPS = {1: 60.0, 2: 350.0, 3: 100.0, 4: 10.0, 5: 150.0, 10: 900.0}
LIT_EVAL_FLOPS = {1: 10.0, 2: 100.0, 5: 50.0, 10: 450.0}


def _lit_lanes(inputs: K4Inputs):
    """(dead, escaped, hit, RANDOM, scattering, material type) lanes of the
    lit shade's inputs: the plain version's bsdf sample of every hit lane."""
    from ..core.rng import Salt, uniform4
    from ..render.bsdf import ScatterKind, bsdf_sample, gather_material_rows

    tables, _, _, st, pixel, sample, t, prim, hr = inputs.shade
    hit = (prim >= 0) & st.active
    mrow = gather_material_rows(tables.mat, hr.mat)
    u4 = uniform4(pixel, sample, st.bounce, Salt.BSDF)
    u_aux = uniform4(pixel, sample, st.bounce, Salt.BSDF_AUX)
    sr = bsdf_sample(hr, st.d, st.ior, u4, u_aux[:, 0], u_aux[:, 1], mrow, tables.mat_types,
                     rgl=tables.rgl)
    random = hit & (sr.kind == ScatterKind.RANDOM) & (sr.pdf > 0.0)
    cont = random | (hit & (sr.kind == ScatterKind.EXPLICIT))
    typ = tables.mat[:, 20].contiguous().view(torch.int32)[hr.mat.long()]
    return ~st.active, st.active & (prim < 0), hit, random, cont, typ


def _lit_shade_work(inputs: K4Inputs):
    """(bytes, flops) of the lit shade in place on `inputs`, by branch.
    Every lane reads its active flag. A dead lane writes its previous
    sample's pdf and flag and its two idle shadow rows (t_max and pending
    deposit): 38 B. An active lane reads its primitive id, bounce index,
    direction, deposits and throughput. An escaped lane reads its previous
    sample's flag and optical path length (and the pdf where the flag is
    set: the sky's MIS weight) and writes its deposits, bounce index, end,
    flag and pdf and its idle rows. A hit lane reads t, the normal, the
    position, the ray IOR, backside, material, path lengths, the flag,
    pixel and sample id (and where the flag is set the pdf, the geometric
    normal and the hit prim's (pick, 1 / area) row; the tangent on GGX and
    RGL hits) and writes its deposits, bounce index, origin, path lengths,
    end, flag, pdf and mixture pdf, where it scatters its direction,
    throughput and ray IOR, and on a RANDOM lane two shadow rays (origin,
    direction, t_max) and two pending deposits, else its idle rows. The
    material, light and sky rows and the RGL tables once. Flops: ~160 per
    hit lane (two uniforms, emission, the roulette), the sky's lookup and
    pdf per escaped lane, the sample per hit lane and type
    (`LIT_SAMPLE_FLOPS`), per RANDOM lane ~360 (two uniforms, the light's
    sample and emission, the sky's sample and lookup toward it, two
    weights) and two bsdf evaluations of its type (`LIT_EVAL_FLOPS`)."""
    tables, _, _, st, pixel, sample, t, prim, hr = inputs.shade
    env = tables.env
    n = st.active.shape[0]
    dead, escaped, hit, random, cont, typ = _lit_lanes(inputs)
    framed = hit & ((typ == MaterialType.GGX) | (typ == MaterialType.RGL))
    count = lambda m: int(m.sum())  # noqa: E731
    idle_rows = 2 * _lane_bytes(t, st.acc)                    # t_max and pending, both rows
    n_bytes = (n * _lane_bytes(st.active)
               + count(dead) * (_lane_bytes(st.prev_pdf, st.prev_random) + idle_rows)
               + count(st.active) * _lane_bytes(prim, st.bounce, st.d, st.acc, st.throughput)
               + count(escaped) * (_lane_bytes(st.prev_random, st.opt_len)
                                   + _lane_bytes(st.acc, st.bounce, st.active, st.prev_pdf,
                                                 st.prev_random) + idle_rows)
               + count(escaped & st.prev_random) * _lane_bytes(st.prev_pdf)
               + count(hit) * (_lane_bytes(t, hr.normal, hr.position, st.ior, hr.backside,
                                           hr.mat, st.geom_len, st.opt_len, st.prev_random,
                                           pixel, sample)
                               + _lane_bytes(st.acc, st.bounce, st.o, st.opt_len, st.active,
                                             st.geom_len, st.prev_pdf, st.prev_random,
                                             st.prev_light_pdf))
               + count(hit & st.prev_random) * (_lane_bytes(st.prev_pdf, hr.geom_normal)
                                                + _lane_bytes(tables.pick_area))
               + count(framed) * _lane_bytes(hr.tangent)
               + count(cont) * _lane_bytes(st.d, st.throughput, st.ior)
               + count(random) * 2 * _lane_bytes(hr.position, hr.position, t, st.acc)
               + count(hit & ~random) * idle_rows)
    rows = [tables.mat, tables.light_tri, tables.light_mat, tables.light_w,
            tables.alias_prob, tables.alias_idx, env.image, env.rotation, env.pdf_table,
            env.alias_prob, env.alias_idx]
    if tables.rgl is not None:
        rows += list(tables.rgl)
    n_bytes += _table_bytes(rows) + 16
    flops = (160.0 * count(hit) + (SKY_LOOKUP_FLOPS[env.kind] + SKY_PDF_FLOPS) * count(escaped)
             + 360.0 * count(random))
    for mt, f in LIT_SAMPLE_FLOPS.items():
        flops += f * count(hit & (typ == mt))
    for mt, f in LIT_EVAL_FLOPS.items():
        flops += 2.0 * f * count(random & (typ == mt))
    return n_bytes, flops


def _lit_shade_copy_work(inputs: K4Inputs):
    """(bytes, flops) of the lit shade that wrote new state (the kernel
    before the in-place contract) on `inputs`. Bytes: every lane's
    state, the sample ids, the ray IOR (read and written back) and the hit
    position (its two shadow rays' origin); the primitive id and the
    previous sample's flag on active lanes; t, normal, backside and material
    on hit lanes; the origin where the ray missed; the previous pdf where
    that flag is set (the MIS weight of a miss or of an emitter), with the
    geometric normal and the hit prim's (pick, 1 / area) row on hit lanes;
    the tangent on GGX and RGL hits; out the next state, two shadow rays (origin,
    direction, t_max) and two pending deposits per lane; the material,
    light and sky rows and the RGL tables once. Flops: ~330 per lane (four
    uniforms, emission, the light's sample and pdf, the sky's sample, the
    roulette), the sky's lookup and pdf per escaped lane, the sample per hit
    lane and type (`LIT_SAMPLE_FLOPS`), per RANDOM lane ~160 (the light's
    emission, the sky's lookup toward its sample, two weights) and two bsdf
    evaluations of its type (`LIT_EVAL_FLOPS`), counted with the plain
    version."""
    from ..render import wavefront as wf

    tables, _, _, st, pixel, sample, t, prim, hr = inputs.shade
    env = tables.env
    n = st.active.shape[0]
    hit = (prim >= 0) & st.active
    escaped = st.active & (prim < 0)
    typ = tables.mat[:, 20].contiguous().view(torch.int32)[hr.mat.long()]
    args = list(inputs.shade)
    args[3] = st._replace(stats=st.stats.clone())
    random = wf.shade_lit_plain(*args)[0].prev_random
    framed = hit & ((typ == MaterialType.GGX) | (typ == MaterialType.RGL))
    weighted = st.active & st.prev_random
    every_lane = [st.active, st.bounce, st.d, st.throughput, st.ior, st.acc, st.geom_len,
                  st.opt_len, pixel, sample, hr.position]
    read = (n * _lane_bytes(*every_lane)
            + int(st.active.sum()) * _lane_bytes(prim, st.prev_random)
            + int(hit.sum()) * _lane_bytes(t, hr.normal, hr.backside, hr.mat)
            + int((~hit).sum()) * _lane_bytes(st.o)
            + int(weighted.sum()) * _lane_bytes(st.prev_pdf)
            + int((hit & st.prev_random).sum()) * (_lane_bytes(hr.geom_normal)
                                                    + _lane_bytes(tables.pick_area))
            + int(framed.sum()) * _lane_bytes(hr.tangent))
    out = [getattr(st, f) for f in st._fields if f != "stats"]
    # two shadow rays (origin, direction, t_max) and two pending deposits
    shadow = 2 * _lane_bytes(hr.position, hr.position, t, st.acc)
    rows = [tables.mat, tables.light_tri, tables.light_mat, tables.light_w,
            tables.alias_prob, tables.alias_idx, env.image, env.rotation, env.pdf_table,
            env.alias_prob, env.alias_idx]
    if tables.rgl is not None:
        rows += list(tables.rgl)
    n_bytes = read + n * _lane_bytes(*out) + n * shadow + _table_bytes(rows) + 16
    flops = (330.0 * n + (SKY_LOOKUP_FLOPS[env.kind] + SKY_PDF_FLOPS) * int(escaped.sum())
             + 160.0 * int(random.sum()))
    for mt, f in LIT_SAMPLE_FLOPS.items():
        flops += f * int((hit & (typ == mt)).sum())
    for mt, f in LIT_EVAL_FLOPS.items():
        flops += 2.0 * f * int((random & (typ == mt)).sum())
    return n_bytes, flops


def bound_ms(n_bytes: float, flops: float):
    """(least time in ms on an H100 at 700 W, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / H100_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _table_bytes(tensors):
    """Bytes of the tensors among `tensors` (a NamedTuple of tables), each read once."""
    return sum(x.numel() * x.element_size() for x in tensors if isinstance(x, torch.Tensor))


def closest_hit_work(bs, rays):
    """K1: rays in (o, d, t_min, t_max) and hits out; 40 flops per ray and
    triangle (four linear functionals of the ray and the division-free
    predicates), 20 per ray and sphere; the primitive rows read once."""
    n = rays[0].shape[0]
    return n * 32 + n * 16 + _table_bytes(bs), n * (40 * bs.n_tris + 20 * bs.n_spheres)


def any_hit_work(bs, rays):
    """K2: as K1 with a bool out, and each lane tests primitives only up to
    its first blocker (counted on these rays)."""
    blocked = candidate_t(bs, *rays) < BIG
    first = torch.where(blocked.any(1), blocked.to(torch.int8).argmax(1) + 1, blocked.shape[1])
    n = rays[0].shape[0]
    return n * 33 + _table_bytes(bs), 40 * float(first.sum())


def assemble_hit_work(ht, n: int, frames=None):
    """K3: o, d, t, prim, u, v in; position, normal, geometric normal,
    tangent, uv, material, backside out; the hit tables read once (rows
    shared by many lanes stay in cache); about 120 flops per lane. K3a
    (`frames`): also the animation ids and the frame rows once, and per lane
    the object-space ray (30 flops) and the three vectors back to world with
    their normalizations (3 x 22 flops)."""
    tables = _table_bytes(ht[:4])
    if frames is None:
        return n * 40 + n * (4 * 14 + 4 + 1) + tables, n * 120.0
    tables += _table_bytes((ht.tri_anim, ht.sph_anim, frames))
    return n * 40 + n * (4 * 14 + 4 + 1) + tables, n * (120.0 + 30.0 + 66.0)


SWEEP_TRI_FLOPS = 46.0     # two crosses, four dots, a division, the predicates
SWEEP_SPHERE_FLOPS = 31.0  # three dots, the discriminant, a root, two divisions
OBJECT_RAY_FLOPS = 30.0    # r_inv (o - t_inv) and r_inv d


def _anim_runs(ss) -> int:
    """Runs of one animation id along a lane's walk (triangles, then
    spheres): the object rays it computes."""
    ids = torch.cat([ss.tri_anim, ss.sph_anim])
    return int((ids[1:] != ids[:-1]).sum()) + 1 if ids.numel() else 0


def sweep_work(ss, rays, frames=None, any_hit: bool = False):
    """KS1/KS2: per lane t_min and t_max in (8 B), o and d (24 B) on live
    lanes (t_max > t_min; a dead lane reads no more), the result out (16 B;
    1 B of occlusion); the primitive rows (36 B of floats and a 4-B
    animation id per triangle, 20 B per sphere) and the frame rows read
    once. Per live lane SWEEP_TRI_FLOPS per triangle and SWEEP_SPHERE_FLOPS
    per sphere tested, and OBJECT_RAY_FLOPS per run of one animation along
    the walk (animated). KS2's lanes stop at their first blocker, counted on
    these rays with the plain tests."""
    o, d, t_min, t_max = rays
    n = o.shape[0]
    live = t_max > t_min
    n_live = int(live.sum())
    tables = 40 * ss.n_tris + 20 * ss.n_spheres + (0 if frames is None else _table_bytes([frames]))
    n_bytes = n * 8 + n_live * 24 + (n if any_hit else n * 16) + tables
    obj = 0.0 if frames is None else OBJECT_RAY_FLOPS * _anim_runs(ss) * n_live
    if not any_hit:
        return n_bytes, n_live * (SWEEP_TRI_FLOPS * ss.n_tris
                                  + SWEEP_SPHERE_FLOPS * ss.n_spheres) + obj
    # prims tested per lane: up to and including its first blocker
    tested = torch.zeros((n,), dtype=torch.float64, device=o.device)
    done = ~live
    for kind, rows, aid, flops in (("tri", ss.tri, ss.tri_anim, SWEEP_TRI_FLOPS),
                                   ("sph", ss.sph, ss.sph_anim, SWEEP_SPHERE_FLOPS)):
        for s in range(0, rows.shape[0], 64):
            r, a = rows[s:s + 64], aid[s:s + 64]
            if frames is None:
                oi, di = o, d
            else:
                oi, di, _ = frames_ray_to_object(frames, a[None, :].expand(n, -1), o, d)
            valid = (ray_tri_tile(oi, di, r[:, 0:3], r[:, 4:7], r[:, 8:11], t_min, t_max)[3]
                     if kind == "tri" else ray_sphere_tile(oi, di, r[:, 0:3], r[:, 3], t_min,
                                                           t_max)[1])
            first = torch.where(valid.any(1), valid.to(torch.int8).argmax(1) + 1, valid.shape[1])
            tested += torch.where(done, 0, first).double() * flops
            done = done | valid.any(1)
    return n_bytes, float(tested.sum()) + obj


def bvh_work(bvh, rays, any_hit: bool):
    """K5/K6: per lane t_min and t_max in (8 B) and the result out (16 B of t,
    prim, u, v; 1 B of occlusion); o and d in (24 B) only on live lanes
    (t_max > t_min: a dead lane reads no more); the node table and 40 B per
    triangle (nine vertex floats and the prim id, not the row's pad words)
    read once (rows visited by many rays stay in cache); two slab tests (48
    flops) for each inner-node visit of the walk and 60 flops (the watertight
    test) for each leaf triangle test, counted with the plain walk on these
    rays."""
    c = bvh_walk_counts(bvh, *rays, any_hit=any_hit)
    n = rays[0].shape[0]
    live = int((rays[3] > rays[2]).sum())
    tables = _table_bytes([bvh.nodes]) + 40 * bvh.tri_v.shape[0]
    n_bytes = live * 24 + n * 8 + (n if any_hit else n * 16) + tables
    return n_bytes, 48.0 * c["nodes"] + 60.0 * c["tri_tests"]


def envmap_work(env, n: int):
    """K8, one call of each entry point: directions and uniforms in, radiance,
    sampled directions and pdfs out, the image (a 64 x 128 equirect map, or
    six 32 x 32 cube faces: 96 KiB) and tables read once; about 60 flops per
    lane and entry point."""
    return n * (12 + 16) + n * (12 + 12 + 4) + n * (12 + 4) + _table_bytes(env[1:]), n * 180.0


def env_radiance_work(env, n: int):
    """K8 radiance alone: 12 B of direction in and 16 B of radiance out per
    lane, the image read once; about 60 flops per lane on the cube map (the
    rotation, the face pick and the bilinear blend of four texels). The
    constant map reads no direction and no image: its 16 B radiance once,
    16 B out per lane, no arithmetic."""
    if env.kind == 3:
        return n * 16 + env.const_radiance.numel() * 4, 0.0
    return n * (12 + 16) + _table_bytes(env[1:]), n * 60.0


def rgl_work(tables, n: int, sample: bool):
    """K7: mid and wi in, with wo (eval) or u2 (sample), f*cos and pdf out
    (and wo, ok for sample); the tables read once. About 450 flops per lane
    for eval (two parameter searches, the vndf inversion, 16 rgb, 8 ndf/sigma
    and 8 luminance corner fetches) and 900 for sample (two full warps with
    their marginal and conditional row searches)."""
    t_bytes = _table_bytes(tables)
    if sample:
        return n * (4 + 12 + 8) + n * (12 + 16 + 4 + 1) + t_bytes, n * 900.0
    return n * (4 + 12 + 12) + n * (16 + 4) + t_bytes, n * 450.0


def row_gather_work(table, idx):
    """P0: the table and the indices read once, the rows written; no arithmetic."""
    return table.numel() * 4 + idx.numel() * 4 + idx.numel() * table.shape[1] * 4, 0.0


def time_restored_ms(fn: Callable, args, device, n: int = 20, warmup: int = 3) -> float:
    """Mean time of one call fn(*args) of an in-place kernel over `n` calls
    after `warmup`, each on the same inputs: the lane state of `args` is
    restored from a copy before every call, outside the timed window. On a
    GPU each call is timed by its own pair of CUDA events, and the card is
    kept busy (torch.cuda._sleep, ~2 ms, longer than the wrapper's host
    work) while the host enqueues the call, so the time is the device's;
    on a CPU the host clock."""
    saved = fresh_args(args)
    cuda = torch.device(device).type == "cuda"
    total = 0.0
    for k in range(warmup + n):
        restore_args(args, saved)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(4_000_000)
            start.record()
            fn(*args)
            stop.record()
            stop.synchronize()
            dt = start.elapsed_time(stop)
        else:
            t0 = time.perf_counter()
            fn(*args)
            dt = (time.perf_counter() - t0) * 1e3
        if k >= warmup:
            total += dt
    restore_args(args, saved)
    return total / n


def time_ms(fn: Callable[[], object], device, n: int = 20, warmup: int = 3) -> float:
    """Mean time of one call over `n` calls after `warmup`, by CUDA events on a
    GPU (a host clock would time the enqueue), by the host clock otherwise."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n
