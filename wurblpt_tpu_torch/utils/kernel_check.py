"""Hold each hand-written kernel against its plain PyTorch version on the same
inputs, at the shapes the main path gives it.

Used by ``chip_smoke.py`` and the CUDA tests. Inputs are made with numpy from
a seed. Tolerances, and why (the kernels are built with -fmad=false, so on
the same card they should agree bit for bit; the margins cover what may
still differ, such as atan2f/asinf against PyTorch's):

* K1 closest hit: prim ids equal wherever the runner-up candidate is farther
  than 1e-5 * t (nearer ones are ties up to rounding); t/u/v rtol 1e-5,
  atol 1e-6 where both hit the same prim. The check also counts the lanes
  whose prim, t, u or v differ in any bit (`differ`): on the card kernel
  and plain version walk the table in the same order with the same
  roundings, and `chip_smoke.py` and the CUDA tests hold that count at 0.
* K2 any hit: equal wherever the nearest candidate is not within 1e-5 *
  t_max of t_max; `differ` counts every lane that differs.
* K3 hit assembly: integer fields equal, float fields atol 1e-5 on hit lanes.
* K5 BVH closest hit: prim ids, t, u and v equal bit for bit on every lane
  (kernel and plain version walk the same tree in the same order with the
  same roundings, so ties resolve alike), every instantiation: triangle
  and sphere rows, world rays and (with the animations' `frames`)
  object-space rays.
* K6 BVH any hit: equal on every lane, every instantiation.
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
* K3's K4 form (K3a's with animation rows): on hit lanes every field of
  its set bit-equal to the plain version's (the sets hold no uv, the only
  field atan2f/asinf reach); on miss lanes every output as it was before
  the launch (`check_assemble_hit_k4`).
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

Also the nine frames the port renders and their yardsticks: the Cornell
bench frame, the mesh frame (bench config bvh_100k), the city frame (bench
config city_many_lights), the envmap frame (envmap_cube_is), the rtiow
frame (rtiow_distortion), the ToF frame (tof_amcw), the animated Cornell
frame (cornell_animated, the bench's Cornell settings at t = 0.5), the
rtiow_bvh frame (the reference's full RTIOW field, 488 spheres in a BVH,
with rtiow's settings) and the cornell_animated_bvh frame (the animated box
with two spheres in a BVH swept at t = 0.5, cornell_animated's settings), each with the JAX
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

import hashlib
import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

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
from ..materials import rgl as rgl_module
from ..materials.rgl import (
    load_rgl_material,
    rgl_eval,
    rgl_eval_plain,
    rgl_sample,
    rgl_sample_plain,
    stack_rgl_tables,
)
from ..render.aov import ALL_AOVS, get_ground_truth
from ..render.bsdf import SceneStatic
from ..render.camera import CameraConfig, DistortionModel, SurroundMode, camera_rays, make_camera
from ..render.gather import row_gather, row_gather_plain
from ..render.envmap import (
    env_miss_plain,
    env_miss_raw,
    env_nee_plain,
    env_nee_raw,
    env_pdf,
    env_pdf_plain,
    env_radiance,
    env_radiance_plain,
    env_radiance_raw,
    env_sample,
    env_sample_plain,
    env_sample_raw,
    skipped_direction,
)
from ..render.integrator import (
    RenderParams,
    accumulate_passes,
    frame_anim,
    prepare_scene,
    render_frame,
    render_frame_wavefront,
)
from ..render.intersect import (
    HitRecord,
    HitTables,
    assemble_hit,
    assemble_hit_k4,
    assemble_hit_plain,
    build_hit_tables,
    hit_buffers,
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
    build_sweep_scene,
    closest_sweep,
    closest_sweep_plain,
    ray_sphere_tile,
    ray_tri_tile,
)
from ..render.lights import light_frames, lights_sample
from ..render.sensor import SensorRGB, SensorTofAmcw
from ..scene.animation import anim_frames, anim_frames_per_ray, frames_ray_to_object
from ..scene.ir import BVHArrays, MaterialType, Spheres
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

# The rtiow_bvh frame: the reference's RTIOW field at its own size,
# scenes.rtiow(seed=7, n=22) (484 small spheres, the ground and three large
# ones: 488 spheres), built with a BVH (use_bvh=True, as the C++ reference
# always traverses one), seen as the rtiow frame: RTIOW_* settings, lens
# and camera. The JAX package's CPU output for the same scene through its
# BVH route: `JAX_PLATFORMS=cpu python jax_frame_reference.py rtiow_bvh`.
RTIOW_BVH_N = 22
RTIOW_BVH_REF_MEAN = 0.4680541570162044
RTIOW_BVH_REF_STATS = (925885, 925885)

# The cornell_animated_bvh frame: scenes.cornell_box_animated(spheres=True)
# (36 triangles and two spheres, one riding the short box's turn) built
# with a BVH whose boxes are swept over [ANIM_TIME, ANIM_TIME], rendered as
# cornell_animated. The JAX package's CPU output for it through its BVH
# route (`jax_frame_reference.py cornell_animated_bvh`).
ANIM_BVH_REF_MEAN = 0.042729496972403025
ANIM_BVH_REF_STATS = (1130169, 2075217)

# The example apps' scenes through the port's Scene (scenes.noise_textures,
# scenes.normalmap, scenes.material_comparison; the two with media,
# MEDIA_FRAMES), rendered by render_frame on the generic bounce at the apps'
# sizes: (width, height, samples_sqrt, path components, samples per pass;
# examples/_common.py's pick: the most that divides spp within 2^20 lanes). Their
# JAX yardsticks, the JAX package's CPU render_frame of the same scenes
# (`JAX_PLATFORMS=cpu python jax_frame_reference.py <name>`): (mean, stats).
EXAMPLE_FRAMES = {"noise_textures": (480, 200, 4, 5, 8), "normalmap": (320, 320, 4, 4, 8),
                  "material_comparison": (560, 180, 4, 8, 8),
                  "participating_media": (256, 192, 4, 12, 16),
                  "stagelights": (480, 270, 5, 8, 5)}
EXAMPLE_REFS = {"noise_textures": (0.24381244771883304, (3227255, 4971874)),
                "normalmap": (0.03950897025361127, (3268027, 4897654)),
                "material_comparison": (0.3714994989917606, (3569889, 5225797)),
                "participating_media": (0.22651895224798638, (1756053, 2746622)),
                "stagelights": (1.0317688785405104, (23099677, 44681968))}
# The material_comparison frame on an H100 as K7 rendered it before it
# skipped the lanes without an RGL material (every lane computed at a
# clamped id): `frame_digest` of its image and stats, which the skip must
# keep bit for bit. A change that means to move the generic bounce's
# rounding (a PyTorch op or another kernel on its path) re-pins it from its
# own run, after tools/k7_turns.py has shown the digests of it and of its
# parent in turns and the frame still meets EXAMPLE_REFS.
EXAMPLE_DIGESTS = {
    "material_comparison": "9d1311a1e11d3a53c7dcfe482e5a329c0e407ac570244fe1acc2ca7d5477ad7c"}

# The example apps with participating media (examples/participating_media.py,
# stagelights.py; in EXAMPLE_FRAMES): render_frame on the generic bounce, KM
# after every closest cast.
MEDIA_FRAMES = ("participating_media", "stagelights")

# The ground-truth AOVs (render/aov.py get_ground_truth with every channel of
# ALL_AOVS): the normalmap scene at 320 x 320 from its app's camera, and the
# animated Cornell box at 128 x 128 from the reference camera at t = 0.5 with
# the flows to 0.25 and 0.75: (width = height, t, t_prev, t_next). Their JAX
# yardsticks (`jax_frame_reference.py aov_<name>`): each channel's mean and
# the hit count. AOV_PARTS pixels may part from the JAX call's (the normal
# map's bilinear lookups under XLA's contracted FMAs; a tie at a seam
# between two primitives, whose records differ in every channel but the
# position): a channel's mean within 1e-5 relative plus that many pixels'
# share of the channel's span, the hit count within that many pixels.
AOV_FRAMES = {"normalmap": (320, 0.0, None, None), "cornell_animated": (128, 0.5, 0.25, 0.75)}
AOV_PARTS = 8
AOV_REFS = {
    "normalmap": {"hits": 101760, "means": {
        "hit_mask": 0.99375,
        "world_position": 0.004653822676627897,
        "camera_position": -0.8021404836392321,
        "geometry_normal": 0.33125,
        "geometry_tangent": 0.33125,
        "tangent": 0.33125,
        "material_normal": 0.22547157976692403,
        "material_tangent": 0.28112664910375507,
        "camera_geometry_normal": 0.38120008781552317,
        "camera_geometry_tangent": 0.33125,
        "camera_material_normal": 0.2617565066639077,
        "camera_material_tangent": 0.28116889395010036,
        "depth": 2.420193416788243,
        "distance": 2.534604288903065,
        "texcoords": 0.5003653723838909,
        "material_index": 0.9875,
    }},
    "cornell_animated": {"hits": 15375, "means": {
        "hit_mask": 0.93841552734375,
        "world_position": 0.34036083033485437,
        "camera_position": -0.9734209228621088,
        "geometry_normal": 0.089563074269269,
        "geometry_tangent": 0.08397933445435803,
        "tangent": 0.08397933445435803,
        "material_normal": 0.08927341990962578,
        "material_tangent": 0.08397933450628568,
        "camera_geometry_normal": 0.089563074269269,
        "camera_geometry_tangent": 0.08397933445435803,
        "camera_material_normal": 0.08927341990962578,
        "camera_material_tangent": 0.08397933450628568,
        "depth": 2.9198399517918006,
        "distance": 3.090626951729064,
        "texcoords": 0.45151302013207545,
        "material_index": 0.46539306640625,
        "world_flow_prev": -0.0022034928124412545,
        "camera_flow_prev": -0.0022034928246436416,
        "pixel_flow_prev": -0.18982259824406356,
        "world_flow_next": 0.0018365958042068087,
        "camera_flow_next": 0.0018365956038148095,
        "pixel_flow_next": 0.1677989203017205,
    }},
}

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


def rtiow_bvh_frame(device, scene=None, depth: int = RTIOW_DEPTH) -> Callable[[], tuple]:
    """The same for the rtiow_bvh frame; `scene` is rtiow(n=22,
    use_bvh=True) on `device`, built here when not given; `depth` replaces
    the bench's 8 path components."""
    scene = scenes.rtiow(n=RTIOW_BVH_N, device=device, use_bvh=True) if scene is None else scene
    return _frame(scene, scenes.rtiow_camera(device), RTIOW_WIDTH, RTIOW_HEIGHT, RTIOW_SSQRT,
                  depth, device, RTIOW_CAMERA, lens=RTIOW_LENS)


def cornell_animated_bvh_frame(device, scene=None, depth: int = BENCH_DEPTH,
                               width: int = BENCH_WIDTH, ssqrt: int = BENCH_SSQRT,
                               ) -> Callable[[], tuple]:
    """The same for the cornell_animated_bvh frame at t0 = t1 = ANIM_TIME;
    `scene` is cornell_box_animated(spheres=True, use_bvh=True) on
    `device`, built here when not given; `depth`, `width` (= height) and
    `ssqrt` change the bench settings for the tests."""
    scene = (scenes.cornell_box_animated(device, spheres=True, use_bvh=True) if scene is None
             else scene)
    return _frame(scene, scenes.cornell_ref_camera(device), width, width, ssqrt, depth, device,
                  t=ANIM_TIME)


def example_frame(name: str, device, scene=None, width=None, height=None, ssqrt=None,
                  depth=None) -> Callable[[], tuple]:
    """A function that renders an example app's frame (EXAMPLE_FRAMES[name])
    on `device` through render_frame, the scene's tables built once, and
    returns (image, stats) once the device is done (with `one_pass`, the
    frame's first pass alone: its raw accumulator and counters); `scene` is
    built here when not given; the other arguments replace the app's
    settings for the tests."""
    w0, h0, s0, d0, per_pass = EXAMPLE_FRAMES[name]
    width, height = width or w0, height or h0
    ssqrt, depth = ssqrt or s0, depth or d0
    scene = getattr(scenes, name)(device=device) if scene is None else scene
    pose, vfov = getattr(scenes, f"{name}_camera")(device)
    cam = make_camera(pose, vfov, width, height, device=device)
    static = SceneStatic.from_scene(scene)
    tables = prepare_scene(scene, static, step=False)
    params = RenderParams(max_path_components=depth)
    per_pass = math.gcd(per_pass, ssqrt * ssqrt)

    def render(one_pass: bool = False):
        if one_pass:   # the frame's first pass alone, its raw accumulator
            acc = torch.zeros((width * height, 3), dtype=torch.float32, device=device)
            out = accumulate_passes(scene, static, cam, CameraConfig(), SensorRGB(), width,
                                    height, ssqrt, 0.0, 0.0, params, per_pass, acc, 0, 1,
                                    return_stats=True, device=device, tables=tables)
        else:
            out = render_frame(scene, static, cam, CameraConfig(), SensorRGB(), width, height,
                               ssqrt, params=params, samples_per_pass=per_pass,
                               return_stats=True, device=device, tables=tables)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return out

    return render


# The motion-blurred frames: render_frame over a shutter [t0, t1], each ray at
# its own time (the per-ray rows of every animation: scene/animation.py
# anim_frames_per_ray, N A 120 bytes a pass), on the generic bounce:
# rolling_marbles (examples/rolling_marbles.py) frame 0 at the app's size,
# 9 spp, 8 path components, its 180-degree shutter [0, 1 / 48], one pass of
# 9 samples (518400 rays, 373 MB of rows: A = 6); animations
# (examples/animations.py) frame 0 at the app's size, 16 spp, 6 path
# components, shutter [0, 0.02], one pass (442368 rays, 106 MB: A = 2); and
# cornell_animated_blur, the animated box with its spheres in a BVH whose
# boxes are swept over [0, 1], at the Cornell bench's settings over [0, 1]
# in one pass (262144 rays, 126 MB: A = 4; K5/K6 with per-ray rows).
# (width, height, samples_sqrt, path components, samples per pass, t0, t1).
MOTION_FRAMES = {"rolling_marbles": (320, 180, 3, 8, 9, 0.0, 0.5 / 24.0),
                 "animations": (192, 144, 4, 6, 16, 0.0, 0.5 / 25.0),
                 "cornell_animated_blur": (128, 128, 4, 8, 16, 0.0, 1.0)}
# Their JAX yardsticks: the JAX package's CPU render_frame of the same
# scenes (`JAX_PLATFORMS=cpu python jax_frame_reference.py <name>`): (mean, stats).
MOTION_REFS = {"rolling_marbles": (0.04478351063669762, (927527, 1337928)),
               "animations": (0.04735957091448981, (775463, 1109927)),
               "cornell_animated_blur": (0.0428153183674251, (1129378, 2073276))}


def motion_scene(name: str, device):
    """The scene of a MOTION_FRAMES frame on `device`."""
    t0, t1 = MOTION_FRAMES[name][5:]
    if name == "cornell_animated_blur":
        return scenes.cornell_box_animated(device, spheres=True, use_bvh=True, t0=t0, t1=t1)
    if name == "animations":
        return scenes.animations(t0, t1, device=device)
    return scenes.rolling_marbles(device=device)


def motion_camera(name: str, device):
    """(pose, vfov_deg) of a MOTION_FRAMES frame."""
    if name == "cornell_animated_blur":
        return scenes.cornell_ref_camera(device)
    return getattr(scenes, f"{name}_camera")(device)


def motion_frame(name: str, device, scene=None, width=None, height=None, ssqrt=None,
                 depth=None, per_pass=None, wavefront: bool = False) -> Callable[[], tuple]:
    """A function that renders a motion-blurred frame (MOTION_FRAMES[name]) on
    `device` through render_frame over its shutter, the scene's tables
    built once, and returns (image, stats) once the device is done; with
    `wavefront`, through render_frame_wavefront, which hands such a frame
    to render_frame. The other arguments replace the frame's settings for
    the tests."""
    w0, h0, s0, d0, p0, t0, t1 = MOTION_FRAMES[name]
    width, height = width or w0, height or h0
    ssqrt, depth = ssqrt or s0, depth or d0
    per_pass = math.gcd(per_pass or p0, ssqrt * ssqrt)
    scene = motion_scene(name, device) if scene is None else scene
    pose, vfov = motion_camera(name, device)
    cam = make_camera(pose, vfov, width, height, device=device)
    static = SceneStatic.from_scene(scene)
    tables = prepare_scene(scene, static, step=wavefront)
    params = RenderParams(max_path_components=depth)

    def render():
        if wavefront:
            out = render_frame_wavefront(scene, static, cam, CameraConfig(), SensorRGB(), width,
                                         height, ssqrt, params, return_stats=True,
                                         device=device, tables=tables, t0=t0, t1=t1,
                                         max_lanes=width * height * per_pass)
        else:
            out = render_frame(scene, static, cam, CameraConfig(), SensorRGB(), width, height,
                               ssqrt, t0, t1, params, per_pass, return_stats=True,
                               device=device, tables=tables)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return out

    return render


def check_motion_frame(name: str, img, stats) -> float:
    """Hold a motion-blurred frame (MOTION_FRAMES) to its JAX yardstick
    (MOTION_REFS); returns its mean radiance."""
    w, h = MOTION_FRAMES[name][:2]
    return _check_frame(img, stats, (h, w, 3), *MOTION_REFS[name])


# The depth-of-field frame (examples/rtiow.py): rtiow() at the app's 320 x
# 200, 16 spp, 8 path components, its thin lens (aperture 0.08, focus 10,
# 25 degrees), through render_frame_wavefront: K4's env class around K1/K3
# with the lens in the pinhole regeneration. Its JAX yardstick
# (`jax_frame_reference.py rtiow_dof`, render_frame_wavefront).
DOF_WIDTH, DOF_HEIGHT, DOF_SSQRT, DOF_DEPTH = 320, 200, 4, 8
DOF_LANES_M = 2     # sample lanes per pixel of its 131072-lane blocks (one block)
DOF_APERTURE, DOF_FOCUS = 0.08, 10.0
DOF_REF_MEAN = 0.49140949322620764
DOF_REF_STATS = (2166768, 2166768)


def rtiow_dof_frame(device, scene=None, depth: int = DOF_DEPTH, width: int = DOF_WIDTH,
                    height: int = DOF_HEIGHT, ssqrt: int = DOF_SSQRT) -> Callable[[], tuple]:
    """The rtiow_dof frame on `device` through render_frame_wavefront (as
    bench_frame); `scene` is rtiow() on `device`, built here when not given;
    the other arguments change the app's settings for the tests."""
    scene = scenes.rtiow(device=device) if scene is None else scene
    cam, cfg = scenes.rtiow_dof_camera(width, height, DOF_APERTURE, DOF_FOCUS, device)
    static = SceneStatic.from_scene(scene)
    params = RenderParams(max_path_components=depth)
    tables = prepare_scene(scene, static)

    def render():
        img, stats = render_frame_wavefront(scene, static, cam, cfg, SensorRGB(), width, height,
                                            ssqrt, params=params, return_stats=True,
                                            device=device, tables=tables)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return img, stats

    return render


def check_rtiow_dof_frame(img, stats) -> float:
    """Hold the rtiow_dof frame to its JAX yardstick; returns its mean radiance."""
    return _check_frame(img, stats, (DOF_HEIGHT, DOF_WIDTH, 3), DOF_REF_MEAN, DOF_REF_STATS)


def tof_distance_check(device, scene=None, width: int = TOF_WIDTH, ssqrt: int = TOF_SSQRT,
                       randomize: bool = True) -> Dict[str, float]:
    """The 4-phase ToF reconstruction at depth 1 (direct light only) against
    the first-hit distance of the pixel-centre camera rays: renders the four
    phase images of tof_box, converts them to electrons without noise,
    reconstructs the distance (SensorTofAmcw.result) and returns the median
    and 90th percentile of |distance - t| in metres over the lit pixels, t
    the pixel-centre rays' first-hit distance (get_ground_truth's
    "distance"); raises AssertionError if the median exceeds
    TOF_DISTANCE_MEDIAN_MAX. Without `randomize` every sample takes the
    pixel centre."""
    scene = scenes.tof_box(device=device) if scene is None else scene
    sensor = SensorTofAmcw()
    phases = [SensorTofAmcw(phase_index=i).phase(
        tof_frame(device, scene, i, depth=1, width=width, ssqrt=ssqrt, randomize=randomize)()[0])
        for i in range(4)]
    dist, _, intensity = sensor.result(phases)
    pose, vfov = scenes.tof_camera(device)
    gt = get_ground_truth(scene, SceneStatic.from_scene(scene),
                          make_camera(pose, vfov, width, width, device=device), CameraConfig(),
                          width, width, aovs=("distance", "hit_mask"), device=device)
    truth = gt["distance"]
    lit = (intensity > 0) & (gt["hit_mask"] > 0)
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


def frame_digest(img, stats) -> str:
    """sha256 of a frame's image (float32 words) and stats (int64): equal
    digests, equal bits."""
    h = hashlib.sha256(img.detach().to("cpu", torch.float32).contiguous().numpy().tobytes())
    h.update(np.asarray([int(x) for x in stats], np.int64).tobytes())
    return h.hexdigest()


def check_example_frame(name: str, img, stats) -> float:
    """Hold an example app's frame (EXAMPLE_FRAMES) to its JAX yardstick
    (EXAMPLE_REFS); returns its mean radiance."""
    w, h = EXAMPLE_FRAMES[name][:2]
    return _check_frame(img, stats, (h, w, 3), *EXAMPLE_REFS[name])


def aov_frame(name: str, device, scene=None) -> Callable[[], dict]:
    """A function that takes get_ground_truth with every channel of ALL_AOVS
    of an AOV frame (AOV_FRAMES[name]) on `device`, the scene's tables built
    once, and returns the channels once the device is done; `scene` is built
    here when not given."""
    width, t, t_prev, t_next = AOV_FRAMES[name]
    if name == "normalmap":
        scene = scenes.normalmap(device=device) if scene is None else scene
        pose, vfov = scenes.normalmap_camera(device)
    else:
        scene = scenes.cornell_box_animated(device) if scene is None else scene
        pose, vfov = scenes.cornell_ref_camera(device)
    cam = make_camera(pose, vfov, width, width, device=device)
    static = SceneStatic.from_scene(scene)
    tables = prepare_scene(scene, static, step=False)

    def run():
        gt = get_ground_truth(scene, static, cam, CameraConfig(), width, width, t=t,
                              t_prev=t_prev, t_next=t_next, aovs=ALL_AOVS, device=device,
                              tables=tables)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return gt

    return run


def check_aov_frame(name: str, gt) -> Dict[str, float]:
    """Hold an AOV frame's channels to the JAX call's (AOV_REFS[name]): the
    same channels (ALL_AOVS, the flows only where the frame has t_prev and
    t_next), each finite, its mean within 1e-5 relative
    plus AOV_PARTS pixels' share of its span (the channel's largest minus
    its smallest value over the frame), the hit count within AOV_PARTS;
    returns each channel's |mean - JAX's| over its tolerance (at most 1)."""
    ref = AOV_REFS[name]
    width = AOV_FRAMES[name][0]
    n_pix = width * width
    hits = int(gt["hit_mask"].sum())
    assert abs(hits - ref["hits"]) <= AOV_PARTS, f"{name}: {hits} hits, JAX {ref['hits']}"
    assert set(gt) == set(ref["means"]), sorted(set(gt) ^ set(ref["means"]))
    out = {}
    for k in ref["means"]:
        x = gt[k].double()
        assert x.shape[:2] == (width, width) and bool(torch.isfinite(x).all()), k
        span = float(x.max() - x.min())
        tol = 1e-5 * max(1.0, abs(ref["means"][k])) + AOV_PARTS * span / n_pix
        err = abs(float(x.mean()) - ref["means"][k])
        assert err <= tol, f"{name} {k}: mean {float(x.mean())!r} off JAX's {ref['means'][k]!r}"
        out[k] = err / tol
    return out


def media_lanes(name: str, device, scene=None, calls: int = 2):
    """The inputs of KM's first `calls` launches in the first pass of an
    example frame with media (EXAMPLE_FRAMES[name] through render_frame):
    bounce 0's closest cast (salt_ctx 0) and its light NEE's shadow cast
    (salt_ctx 1), each (scene, o, d, t_min, t, prim, u, v, pixel, sample,
    bounce, salt_ctx) as render/integrator.py hands them to apply_media."""
    from ..render import integrator as it_mod

    rec, apply = [], it_mod.apply_media

    def spy(*args):
        if len(rec) < calls:
            rec.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return apply(*args)

    it_mod.apply_media = spy
    try:
        example_frame(name, device, scene)(one_pass=True)
    finally:
        it_mod.apply_media = apply
    return rec


def media_random_lanes(scene, n: int = 1000, seed: int = 23):
    """n segments around participating_media's fog sphere (centre (0.4, 0,
    -0.8), radius 1): a third starting inside it (the exit-only branch), the
    rest from a box around it in random directions, random solid hits (a
    quarter none: t BIG, prim -1), random counter words and salt_ctx 1."""
    dev = scene.device
    rs = np.random.default_rng(seed)
    c = np.array([0.4, 0.0, -0.8])
    inside = rs.uniform(size=n) < 1.0 / 3.0
    v = rs.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    o = np.where(inside[:, None], c + v * rs.uniform(0.0, 0.95, size=(n, 1)),
                 c + rs.uniform(-3.0, 3.0, size=(n, 3)))
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    none = rs.uniform(size=n) < 0.25
    t = np.where(none, BIG, rs.uniform(0.05, 6.0, size=n))
    prim = np.where(none, -1, rs.integers(0, scene.n_tris + scene.n_spheres, size=n))
    i64 = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev)  # noqa: E731
    return (scene, _f32(o, dev), _f32(d, dev), torch.full((n,), MIN_HIT, device=dev),
            _f32(t, dev), torch.as_tensor(prim, dtype=torch.int32, device=dev),
            _f32(rs.uniform(size=n), dev), _f32(rs.uniform(size=n), dev),
            i64(rs.integers(0, 1 << 20, size=n)), i64(rs.integers(0, 64, size=n)),
            i64(rs.integers(0, 12, size=n)), 1)


def check_apply_media(args) -> Dict[str, float]:
    """KM against its plain version on the same lanes (apply_media's
    arguments): every output bit-equal but where log1pf and PyTorch's CUDA
    log1p round a free path differently, which moves that lane's t by an ulp
    or two and, only where the scatter point sits that close to the exit or
    the solid hit, flips the lane's scatter decision. Returns the lanes whose
    outputs differ in a bit (`differ`), the flipped decisions (`flips`, held
    to at most 1e-5 of the lanes), and the largest |t| difference relative
    to t on the lanes that agree in their decision (`max_abs_err`, held to
    4e-7: a couple of ulps)."""
    from ..render.media import apply_media, apply_media_plain

    n = args[1].shape[0]
    words = [torch.as_tensor(x, device=args[1].device).to(torch.int64).expand(n)
             for x in args[8:11]]
    return compare_media(apply_media(*args), apply_media_plain(*args[:8], *words, args[11]))


def compare_media(got, ref) -> Dict[str, float]:
    """KM's outputs (t, prim, u, v, med_mask, med_mat) against the plain
    version's, with check_apply_media's tolerances."""
    n = got[0].shape[0]
    flips = got[4] != ref[4]
    differ = flips.clone()
    for a, b in zip(got, ref):
        a, b = a.reshape(n, -1), b.reshape(n, -1)
        differ |= (a.view(torch.int32) != b.view(torch.int32)).any(-1) if a.dtype == torch.float32 \
            else (a != b).any(-1)
    same = ~flips
    rel = ((got[0] - ref[0]).abs() / torch.clamp_min(ref[0].abs(), 1e-20))[same]
    res = {"lanes": n, "medium_lanes": int(ref[4].sum()), "differ": int(differ.sum()),
           "flips": int(flips.sum()),
           "max_abs_err": float(rel.max()) if rel.numel() else 0.0}
    assert res["flips"] <= max(1, int(1e-5 * n)), res
    assert res["max_abs_err"] <= 4e-7, res
    for a, b in zip(got[1:], ref[1:]):   # prim, u, v, mask, mat: equal where the decision is
        assert torch.equal(a[same], b[same]), res
    return res


def media_work(args):
    """KM's (bytes, float32 operations) on these lanes: per lane o, d, t_min,
    the solid hit and three int64 counter words in (68 B), the hit, mask and
    phase material out (21 B), the boundary tables once; per lane and
    medium two probes of 46 operations a boundary triangle and 31 a
    boundary sphere, the free path's ~30."""
    scene, n = args[0], args[1].shape[0]
    md = scene.media
    table = sum(x.numel() * x.element_size() for x in md)
    flops = n * (2 * (46 * md.tri_p0.shape[0] + 31 * md.sph_center.shape[0]) + 30 * md.count)
    return n * (68 + 21) + table, flops


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


def check_rtiow_bvh_frame(img, stats) -> float:
    """Hold an rtiow_bvh frame to the JAX reference; returns its mean radiance."""
    return _check_frame(img, stats, (RTIOW_HEIGHT, RTIOW_WIDTH, 3), RTIOW_BVH_REF_MEAN,
                        RTIOW_BVH_REF_STATS)


def check_cornell_animated_bvh_frame(img, stats) -> float:
    """Hold a cornell_animated_bvh frame to the JAX reference; returns its mean radiance."""
    return _check_frame(img, stats, (BENCH_WIDTH, BENCH_WIDTH, 3), ANIM_BVH_REF_MEAN,
                        ANIM_BVH_REF_STATS)


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
    o, d, _ = camera_rays(cam, cfg, _f32(pxy, device), width, height)
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


def scatter_dead(rays, share: float, seed: int = 7):
    """`rays` with `share` of the lanes dead, scattered from numpy `seed`:
    t_max 0, equal to t_min or NaN, a third each (the brute-force casts'
    live test is t_max > t_min)."""
    o, d, t_min, t_max = rays
    rs = np.random.default_rng(seed)
    n = o.shape[0]
    dead = torch.as_tensor(rs.permutation(n) < round(share * n), device=o.device)
    how = torch.as_tensor(rs.integers(0, 3, n), device=o.device)
    killed = torch.where(how == 0, 0.0, torch.where(how == 1, t_min, float("nan")))
    return o, d, t_min, torch.where(dead, killed, t_max).contiguous()


def last_blocker_lanes(scene, n: int, device, seed: int = 14):
    """Shadow rays whose blocker is the last primitive of `scene`'s table
    (its last sphere, or its last triangle where it has no sphere), so that
    an any-hit walk in table order meets it last: toward the sphere's
    centre from 0.05 to 0.5 outside it, ending at the centre, or from
    random points inside the Cornell box toward inner points of the
    triangle, ending just past it. [n] lanes, all live."""
    rs = np.random.default_rng(seed)
    if scene.n_spheres:
        c = scene.spheres.center[-1].cpu().double().numpy()
        r = float(scene.spheres.radius[-1])
        w = rs.normal(size=(n, 3))
        w /= np.linalg.norm(w, axis=-1, keepdims=True)
        o = c + w * rs.uniform(r + 0.05, r + 0.5, size=(n, 1))
        d, reach = c - o, 1.0
    else:
        p0, e1, e2 = (x[-1].cpu().double().numpy() for x in (scene.tris.p0, scene.tris.e1,
                                                             scene.tris.e2))
        a, b = rs.uniform(0.1, 0.4, size=(2, n, 1))
        o = rs.uniform((-0.9, 0.1, -0.9), (0.9, 1.8, 0.9), size=(n, 3))
        d, reach = p0 + a * e1 + b * e2 - o, 1.001
    dist = np.linalg.norm(d, axis=-1)
    return (_f32(o, device), _f32(d / dist[:, None], device),
            torch.full((n,), MIN_HIT, device=device), _f32(dist * reach, device))


def _aimed(rs, p0, e1, e2, ab, tris):
    """Rays from random points toward p0 + a e1 + b e2 of triangles `tris`
    ((a, b) per lane in `ab`), at a random distance from 0.3 to 2, from the
    side of each triangle's plane that its random direction sees it from."""
    n = len(tris)
    target = p0[tris] + ab[:, :1] * e1[tris] + ab[:, 1:] * e2[tris]
    nrm = np.cross(e1[tris], e2[tris])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    along = np.sum(d * nrm, -1, keepdims=True)
    d = np.where(np.abs(along) < 0.2, d + np.sign(along + 1e-9) * 0.5 * nrm, d)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return target - rs.uniform(0.3, 2.0, size=(n, 1)) * d, d


def edge_lanes(p0, e1, e2, cast, n: int, device, seed: int = 15):
    """Rays at the edges of the casts' exact tests, toward the
    triangles of p0, e1, e2 (world space, [T, 3] each), in four families of
    n / 4 lanes: aimed at points on the triangles' edges and corners (u_num
    or v_num zero, or within a rounding of it); grazing, nearly in the plane
    of those whose plane is axis-aligned (|det| from 0.5e-12 to 4e-12,
    either sign; aimed like the first family where no plane is); and aimed
    at inner points with t_max, then t_min, at the distance of the hit that
    `cast` (a plain closest hit (o, d, t_min, t_max) -> (t, prim, u, v))
    finds, or one float either side of it."""
    rs = np.random.default_rng(seed)
    p0, e1, e2 = (x.detach().cpu().double().numpy() for x in (p0, e1, e2))
    m = n // 4
    lanes = []
    # 1. edges and corners, exactly or within a few roundings
    r = rs.uniform(0.05, 0.95, m)
    on = {0: (0.0 * r, r), 1: (r, 0.0 * r), 2: (1.0 - r, r),    # the three edges
          3: (0.0 * r, 0.0 * r), 4: (1.0 + 0.0 * r, 0.0 * r), 5: (0.0 * r, 1.0 + 0.0 * r)}
    which = rs.integers(0, 6, m)
    ab = np.stack([np.choose(which, [on[k][c] for k in range(6)]) for c in (0, 1)], -1)
    ab += rs.choice([0.0, 1e-7, -1e-7, 1e-6, -1e-6], size=(m, 2))
    lanes.append(_aimed(rs, p0, e1, e2, ab, rs.integers(0, len(p0), m)))
    # 2. grazing: |det| = |d_axis n_axis| near 1e-12 where the plane is axis-aligned
    flat = [(j, ax) for j in range(len(p0)) for ax in range(3)
            if e1[j, ax] == 0.0 and e2[j, ax] == 0.0]
    if flat:
        pick = [flat[k] for k in rs.integers(0, len(flat), m)]
        tris = np.array([j for j, _ in pick])
        axis = np.array([ax for _, ax in pick])
        nrm = np.abs(np.cross(e1[tris], e2[tris])[np.arange(m), axis])
        ab = rs.uniform(0.1, 0.4, size=(m, 2))
        target = p0[tris] + ab[:, :1] * e1[tris] + ab[:, 1:] * e2[tris]
        theta = rs.uniform(0, 2 * np.pi, m)
        d = np.zeros((m, 3))
        d[np.arange(m), (axis + 1) % 3] = np.cos(theta)
        d[np.arange(m), (axis + 2) % 3] = np.sin(theta)
        d[np.arange(m), axis] = (rs.choice([-1.0, 1.0], m) * np.geomspace(0.5, 4.0, m)
                                 * 1e-12 / nrm)
        lanes.append((target - rs.uniform(0.2, 1.0, size=(m, 1)) * d, d))
    else:
        lanes.append(_aimed(rs, p0, e1, e2, rs.uniform(0.0, 0.5, size=(m, 2)),
                            rs.integers(0, len(p0), m)))
    o = np.concatenate([x for x, _ in lanes])
    d = np.concatenate([x for _, x in lanes])
    k = len(o)
    rays = [(o, d, np.full(k, MIN_HIT), np.full(k, BIG))]
    # 3, 4. inner points, t_max or t_min at the hit's distance or a float either side
    for bound in (3, 2):
        ao, ad = _aimed(rs, p0, e1, e2, rs.uniform(0.1, 0.4, size=(m, 2)),
                        rs.integers(0, len(p0), m))
        t_min, t_max = np.full(m, MIN_HIT, np.float32), np.full(m, BIG, np.float32)
        t = cast(_f32(ao, device), _f32(ad, device), _f32(t_min, device),
                 _f32(t_max, device))[0].cpu().numpy()
        step = rs.integers(-1, 2, m)
        at = np.where(step == 0, t, np.nextafter(t, np.where(step > 0, np.inf, -np.inf),
                                                 dtype=np.float32))
        hit = t < BIG
        if bound == 3:
            t_max = np.where(hit, at, t_max)
        else:
            t_min = np.where(hit, at, t_min)
        rays.append((ao, ad, t_min, t_max))
    return tuple(_f32(np.concatenate([r[i] for r in rays]), device) for i in range(4))


def _one_live(rays, hit):
    """`rays` with every lane dead (t_max 0) but the middle one of those
    where `hit` ([N] bool) is true, which keeps its t_max."""
    o, d, t_min, t_max = rays
    lanes = torch.nonzero(hit)[:, 0]
    keep = torch.arange(o.shape[0], device=o.device) == lanes[lanes.shape[0] // 2]
    return o, d, t_min, torch.where(keep, t_max, 0.0).to(torch.float32)


def k2_edge_sets(device, n: int = 4096):
    """{label: (BruteScene, shadow rays)}: the edges of K2's live-lane queue
    and range-first walk on the Cornell box: every lane dead, one live lane
    (an occluded one),
    blockers that are the table's last triangle (the light's) or its last
    primitive, a sphere in the air above the boxes (`last_blocker_lanes`),
    and the tests' edges (`edge_lanes`: edges and corners, |det| about
    1e-12, t_max and t_min at a hit's distance or a float either side)."""
    ref = scenes.cornell_box_ref(device)
    f = dict(dtype=torch.float32, device=device)
    air = ref._replace(spheres=Spheres(torch.tensor([[-0.3, 1.3, 0.4]], **f),
                                       torch.tensor([0.2], **f),
                                       torch.tensor([0], dtype=torch.int32, device=device)))
    bs, air_bs = build_brute_scene(ref), build_brute_scene(air)
    rnd = random_lanes(n, device, seed=3)
    t = ref.tris
    return {"every lane dead": (bs, rnd[:3] + (torch.zeros_like(rnd[3]),)),
            "one live lane": (bs, _one_live(rnd, any_hit_plain(bs, *rnd))),
            "blocker last, triangle": (bs, last_blocker_lanes(ref, n, device)),
            "blocker last, sphere": (air_bs, last_blocker_lanes(air, n, device)),
            "edges": (bs, edge_lanes(t.p0, t.e1, t.e2,
                                     lambda *r: closest_hit_plain(bs, *r), n, device))}


def ks1_edge_sets(device, n: int = 4096):
    """{label: (SweepScene, rays, frames or None)}: the edges of KS1's queue,
    split walk and object rays on the animated Cornell box at
    ANIM_TIME: every lane dead, one live lane (one that hits), rays down
    onto the floor where the static box's bottom face lies in its plane
    (every lane ties;
    7 of 8 dead, so 8 threads to a ray), a table whose animation ids change
    at every primitive, 12 animation rows, and the tests' edges on the static
    walls (`edge_lanes`)."""
    anim = scenes.cornell_box_animated(device)
    ss, fr = build_sweep_scene(anim), frames_at(anim)
    rnd = random_lanes(n, device, seed=6)
    rs = np.random.default_rng(5)
    down = (_f32(np.c_[rs.uniform(0.2, 0.4, n), np.full(n, 0.5), rs.uniform(0.25, 0.45, n)],
                 device), _f32(np.tile([0.0, -1.0, 0.0], (n, 1)), device),
            torch.full((n,), 1e-4, device=device),
            torch.where(torch.arange(n, device=device) % 8 == 0, BIG, 0.0).to(torch.float32))
    ids = (torch.arange(ss.n_tris, dtype=torch.int32, device=device) * 3) % ss.n_anims
    many = ss._replace(tri_anim=(torch.arange(ss.n_tris, dtype=torch.int32, device=device)
                                 % 12).contiguous(), n_anims=12)
    walls = ss.tri[ss.tri_anim == 0]
    return {"every lane dead": (ss, rnd[:3] + (torch.zeros_like(rnd[3]),), fr),
            "one live lane": (ss, _one_live(rnd, closest_sweep_plain(ss, *rnd, fr)[1] >= 0), fr),
            "ties across split threads": (build_sweep_scene(scenes.cornell_box_ref(device)),
                                          down, None),
            "interleaved animation ids": (ss._replace(tri_anim=ids.contiguous()),
                                          scatter_dead(rnd, 0.5, 11), fr),
            "12 animation rows": (many, scatter_dead(rnd, 0.5, 12), fr.repeat(3, 1)),
            "edges": (ss, edge_lanes(walls[:, 0:3], walls[:, 4:7], walls[:, 8:11],
                                     lambda *r: closest_sweep_plain(ss, *r, fr), n, device),
                      fr)}


def _only_last(ss, rays, frames):
    """`rays` with t_max 0 on the lanes that a primitive other than the
    table's last one blocks: each live lane's only blocker is then the last
    primitive (or none)."""
    o, d, t_min, t_max = rays
    if ss.n_spheres:
        rest = ss._replace(sph=ss.sph[:-1], sph_anim=ss.sph_anim[:-1], n_spheres=ss.n_spheres - 1)
    else:
        rest = ss._replace(tri=ss.tri[:-1], tri_anim=ss.tri_anim[:-1], n_tris=ss.n_tris - 1)
    others = any_sweep_plain(rest, o, d, t_min, t_max, frames)
    return o, d, t_min, torch.where(others, 0.0, t_max).contiguous()


def _world_rows(ss, frames):
    """The triangle rows' p0, e1, e2 in world space at the frames' instant
    (float64 numpy, [T, 3] each): m_fwd p + t_inv of each row's animation."""
    f = frames.double().cpu().numpy()[ss.tri_anim.long().cpu().numpy()]
    m, t = f[:, 12:21].reshape(-1, 3, 3), f[:, 9:12]
    rows = ss.tri.double().cpu().numpy()
    p0, e1, e2 = (np.einsum("tij,tj->ti", m, rows[:, c:c + 3]) for c in (0, 4, 8))
    return p0 + t, e1, e2


def ks2_edge_sets(device, n: int = 4096):
    """{label: (SweepScene, rays, frames or None)}: the edges of KS2's queue,
    split walk and early stop, on the animated Cornell box with its two
    spheres at ANIM_TIME unless said: rays whose only blocker is the
    table's last primitive (the reference box's light triangle, static; a
    sphere in the air appended to the animated table, `last_blocker_lanes`);
    rays aimed through the short box where its animation has turned it
    (blocked in that animation's object space, many of them not at rest);
    one live lane of the launch (an occluded one: 8 threads to its ray);
    grazing rays (`edge_lanes`' edges, corners and |det| about 1e-12 on the
    static walls, and rays tangent to the static sphere within a relative
    1e-6); t_max and t_min at a wall hit's distance or a float either side;
    and rows with t_max <= t_min (0, t_min or NaN) whose directions are
    stale ones that would be blocked (NaN on a fifth of them)."""
    anim = scenes.cornell_box_animated(device, spheres=True)
    ss, fr = build_sweep_scene(anim), frames_at(anim)
    ref = scenes.cornell_box_ref(device)
    ref_ss = build_sweep_scene(ref)
    f = dict(dtype=torch.float32, device=device)
    sph = anim.spheres
    air = anim._replace(spheres=Spheres(
        torch.cat([sph.center, torch.tensor([[-0.3, 1.3, 0.4]], **f)]),
        torch.cat([sph.radius, torch.tensor([0.2], **f)]),
        torch.cat([sph.mat, sph.mat[:1]]),
        torch.cat([sph.anim, torch.zeros((1,), dtype=torch.int32, device=device)])))
    air_ss = build_sweep_scene(air)
    rs = np.random.default_rng(16)
    m = n // 4
    # through the short box (animation 1) as it stands at the frames' instant
    p0, e1, e2 = _world_rows(ss, fr)
    tris = rs.choice(np.nonzero(ss.tri_anim.cpu().numpy() == 1)[0], n)
    ab = rs.uniform(0.1, 0.4, size=(n, 2))
    _, ad = _aimed(rs, p0, e1, e2, ab, tris)
    reach = rs.uniform(0.02, 0.2, size=(n, 1))
    ao = p0[tris] + ab[:, :1] * e1[tris] + ab[:, 1:] * e2[tris] - reach * ad
    turned = (_f32(ao, device), _f32(ad, device), torch.full((n,), MIN_HIT, **f),
              _f32(reach[:, 0] * 1.001, device))
    # tangent to the static sphere (row 1), the distance from its centre a
    # relative 0 or 1e-7 or 1e-6 either side of its radius
    c, r = ss.sph[1, :3].double().cpu().numpy(), float(ss.sph[1, 3])
    td = rs.normal(size=(m, 3))
    td /= np.linalg.norm(td, axis=-1, keepdims=True)
    w = rs.normal(size=(m, 3))
    w -= np.sum(w * td, -1, keepdims=True) * td
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    eps = rs.choice([-1e-6, -1e-7, 0.0, 1e-7, 1e-6], size=(m, 1))
    to = c + w * r * (1.0 + eps) - td * rs.uniform(0.5, 1.5, size=(m, 1))
    walls = ss.tri[ss.tri_anim == 0]
    edges = edge_lanes(walls[:, 0:3], walls[:, 4:7], walls[:, 8:11],
                       lambda *q: closest_sweep_plain(ss, *q, fr), n, device)
    k = 2 * (n // 4)
    grazing = tuple(torch.cat([a[:k], b]) for a, b in zip(
        edges, (_f32(to, device), _f32(td, device), torch.full((m,), MIN_HIT, **f),
                torch.full((m,), BIG, **f))))
    # stale rows: dead lanes whose rays the sweep would find blocked
    rnd = random_lanes(n, device, seed=17)
    occ = any_sweep_plain(ss, *rnd, fr).cpu().numpy()
    dead = occ & (rs.uniform(size=n) < 0.7)
    how = rs.integers(0, 3, n)
    t_min = rnd[2].cpu().numpy()
    t_max = np.where(dead, np.choose(how, [np.zeros(n), t_min, np.full(n, np.nan)]),
                     rnd[3].cpu().numpy())
    d = np.where((dead & (rs.uniform(size=n) < 0.2))[:, None], np.nan, rnd[1].cpu().numpy())
    stale = (rnd[0], _f32(d, device), rnd[2], _f32(t_max, device))
    return {"blocker last, triangle, static": (ref_ss, _only_last(
                ref_ss, last_blocker_lanes(ref, n, device), None), None),
            "blocker last, sphere": (air_ss, _only_last(
                air_ss, last_blocker_lanes(air, n, device), fr), fr),
            "blocker in one animation's object space": (ss, turned, fr),
            "one live lane": (ss, _one_live(rnd, torch.as_tensor(occ, device=device)), fr),
            "edges, grazing": (ss, grazing, fr),
            "t a float inside or outside (t_min, t_max)": (
                ss, tuple(x[k:].contiguous() for x in edges), fr),
            "t_max <= t_min, stale directions": (ss, stale, fr)}


def _bits_differ(*pairs):
    """Lanes where any pair of [N] float32 or int32 tensors differs in a bit."""
    out = torch.zeros_like(pairs[0][0], dtype=torch.bool)
    for a, b in pairs:
        out |= a.view(torch.int32) != b.view(torch.int32)
    return int(out.sum())


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
            "ties": int((~ok).sum()),
            "differ": _bits_differ((t, pt), (prim, pprim), (u, pu), (v, pv))}


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
            "occluded": int(occ.sum()), "differ": int((occ != pocc).sum())}


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


def frames_per_ray_at(scene, n: int, seed: int = 13, t0: float = 0.0, t1: float = 1.0):
    """The rows of every animation of `scene` at n ray times uniform in [t0,
    t1) from a seed (anim_frames_per_ray, [n, A, 30]): a motion-blurred
    cast's rows."""
    u = np.random.default_rng(seed).uniform(size=n).astype(np.float32)
    times = _f32(np.float32(t0) + u * np.float32(t1 - t0), scene.anims.times.device)
    return anim_frames_per_ray(scene.anims, times)


def anim_shadow_lanes(scene, accel, frames, rays, seed: int = 2):
    """NEE shadow rays of an animated scene: from the first hits of `rays`
    (the plain cast of `accel`, the scene's SweepScene or BVHArrays) toward
    a point sampled on the light where it is at the instant of `frames`
    (`frames_at`, or each lane's own with per-ray rows), shortened as the
    integrator does; lanes without a hit get t_max = 0."""
    o, d, t_min, t_max = rays
    cast = bvh_closest_hit_plain if isinstance(accel, BVHArrays) else closest_sweep_plain
    t, prim, _, _ = cast(accel, o, d, t_min, t_max, frames)
    pos = o + torch.where(prim >= 0, t, 1.0)[:, None] * d
    u3 = _f32(np.random.default_rng(seed).uniform(size=(o.shape[0], 3)), o.device)
    lf = light_frames(scene, frames, SceneStatic.from_scene(scene).sphere_lights)
    ldir, _, ldist, _, _ = lights_sample(scene, pos, u3, lf)
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


# What a miss lane of the K4 form must leave as it was: the fill of each
# output before the launch (float fields NaN).
K4_FILL_MAT = -123456789
K4_FILL_BACKSIDE = 0x5A


def check_assemble_hit_k4(ht, args, frames, fields) -> Dict[str, float]:
    """K3's K4 form (`assemble_hit_k4`, K3a's with `frames`) against its
    plain version on the winners `args` (o, d, t, prim, u, v): its buffers
    for the field set `fields` are filled first (NaN, K4_FILL_MAT, bytes of
    K4_FILL_BACKSIDE); then on hit lanes each field of the set must be
    bit-equal to assemble_hit_plain's, and on every miss lane each must
    still hold its fill; the record has no hit mask and no field outside
    the set. Raises AssertionError otherwise. On CUDA tensors (the CPU
    wrapper copies the plain version's every lane)."""
    o, prim = args[0], args[3]
    out = hit_buffers(fields, o.shape[0], o.device)
    for f in fields:
        x = getattr(out, f)
        if f == "mat":
            x.fill_(K4_FILL_MAT)
        elif f == "backside":
            x.view(torch.uint8).fill_(K4_FILL_BACKSIDE)
        else:
            x.fill_(float("nan"))
    rec = assemble_hit_k4(ht, *args, frames, out)
    ref = assemble_hit_plain(ht, *args, frames)
    assert rec.hit is None, "assemble_hit_k4: the record has a hit mask"
    for f in set(HitRecord._fields) - set(fields) - {"t", "hit", "prim"}:
        assert getattr(rec, f) is None, f"assemble_hit_k4: {f} is outside the set"
    hit = prim >= 0
    miss = ~hit
    for f in fields:
        got, want = getattr(rec, f), getattr(ref, f)
        if got.dtype.is_floating_point:
            bad = int((got.view(torch.int32) != want.view(torch.int32))[hit].sum())
            kept = bool(torch.isnan(got[miss]).all())
        elif f == "backside":
            bad = int((got != want)[hit].sum())
            kept = bool((got.view(torch.uint8)[miss] == K4_FILL_BACKSIDE).all())
        else:
            bad = int((got != want)[hit].sum())
            kept = bool((got[miss] == K4_FILL_MAT).all())
        assert bad == 0, f"assemble_hit_k4: {f} differs on {bad} hit lanes"
        assert kept, f"assemble_hit_k4: {f} written on a miss lane"
    return {"max_abs_err": 0.0, "lanes": int(o.shape[0]), "hits": int(hit.sum()),
            "sphere hits": int((prim >= ht.n_tris).sum()), "fields": len(fields)}


def k3_edge_sets(device, seed: int = 0):
    """{label: (HitTables, (o, d, t, prim, u, v), frames)}: the edges of K3's
    K4 form on synthetic tables (48 triangles, 8 spheres, every row's
    animation id one of the animated Cornell box with spheres' rows, whose
    frames at ANIM_TIME come along: pass None for a static launch): a set
    with no hit lane, one with a single hit lane, one where every lane hit,
    triangle and sphere winners alternating lane by lane, degenerate
    tangents (the ONB fallback: a row without the tangent flag, a row with
    zero tangents) and sphere hits at the poles, backside hits, winners of
    different animations side by side, and 1111 lanes (no multiple of a
    tile). At these sizes a tile holds 32 lanes on the card (hundreds of
    blocks) and 352 or 512 in the host build (tests/cuda_host, two blocks),
    so the first three sets give tiles without a hit, with one and where
    all hit on both."""
    rs = np.random.default_rng(seed)
    n_t, n_s = 48, 8

    def unit(k):
        x = rs.normal(size=(k, 3))
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    base = unit(n_t)
    rows = np.concatenate([base + 0.2 * unit(n_t), base + 0.2 * unit(n_t), base + 0.2 * unit(n_t),
                           rs.uniform(0, 1, (n_t, 6)), unit(n_t), unit(n_t), unit(n_t), base],
                          -1)
    rows[5, 15:24] = 0.0                       # zero tangents with the tangent flag
    flags = np.where(np.arange(n_t) % 2 == 0, 2, 0)   # odd rows: no tangent (ONB)
    flags[5] = 2
    tri_i = np.stack([rs.integers(0, 6, n_t), flags], -1)
    centres = rs.uniform(-2, 2, (n_s, 3))
    centres[0] = 0.0                           # sphere 0: the unit sphere, at rest
    sph = np.concatenate([centres, rs.uniform(0.3, 1.0, (n_s, 1))], -1)
    sph[0, 3] = 1.0
    frames = frames_at(scenes.cornell_box_animated(device, spheres=True))
    a = frames.shape[0]
    tri_anim = np.arange(n_t) % a
    sph_anim = np.arange(n_s) % a              # sphere 0 in row 0, the identity
    i32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.int32), device=device)  # noqa: E731
    ht = HitTables(_f32(rows, device), i32(tri_i), _f32(sph, device), i32(rs.integers(0, 6, n_s)),
                   n_t, n_s, i32(tri_anim), i32(sph_anim), a)

    def lanes(prim, o=None, d=None, t=None):
        n = prim.shape[0]
        o = rs.uniform(-3, 3, (n, 3)) if o is None else o
        d = unit(n) if d is None else d
        t = rs.uniform(0.1, 5.0, n) if t is None else t
        u, v = rs.uniform(0, 1, n), rs.uniform(0, 1, n)
        fold = u + v > 1
        u, v = np.where(fold, 1 - u, u), np.where(fold, 1 - v, v)
        return (_f32(o, device), _f32(d, device), _f32(t, device), i32(prim), _f32(u, device),
                _f32(v, device))

    def winners(n, hit_share=1.0):
        return np.where(rs.uniform(size=n) < hit_share, rs.integers(0, n_t + n_s, n), -1)

    one = np.full(700, -1)
    one[300] = 7
    mixed = np.where(np.arange(512) % 2 == 0, rs.integers(0, n_t, 512),
                     n_t + rs.integers(0, n_s, 512))
    # degenerate tangents (rows 5 and 3) and the unit sphere's poles
    k = 256
    degen = np.where(np.arange(k) % 4 == 0, 5, np.where(np.arange(k) % 4 == 1, 3, n_t))
    pole_o = np.zeros((k, 3))
    pole_o[:, 1] = np.where(np.arange(k) % 8 < 4, 2.0, -2.0)
    pole_d = -np.sign(pole_o)
    pole = degen == n_t
    o_dg = np.where(pole[:, None], pole_o, rs.uniform(-3, 3, (k, 3)))
    d_dg = np.where(pole[:, None], pole_d, unit(k))
    t_dg = np.where(pole, 1.0, rs.uniform(0.1, 5.0, k))
    # backside: along a triangle's geometric normal, or out of a sphere from its centre
    back = winners(512)
    sph_i = np.clip(back - n_t, 0, n_s - 1)
    inside = back >= n_t
    d_bk = np.where(inside[:, None], unit(512), rows[np.clip(back, 0, n_t - 1), 24:27])
    o_bk = np.where(inside[:, None], sph[sph_i, :3], rs.uniform(-3, 3, (512, 3)))
    t_bk = np.where(inside, sph[sph_i, 3], rs.uniform(0.1, 5.0, 512))
    side = np.arange(512) % (n_t + n_s)        # every lane's neighbour in another animation
    return {"no hit lane": (ht, lanes(np.full(700, -1)), frames),
            "one hit lane": (ht, lanes(one), frames),
            "every lane hit": (ht, lanes(winners(1024)), frames),
            "triangles and spheres interleaved": (ht, lanes(mixed), frames),
            "degenerate tangents, sphere poles": (ht, lanes(degen, o_dg, d_dg, t_dg), frames),
            "backside hits": (ht, lanes(back, o_bk, d_bk, t_bk), frames),
            "animations side by side": (ht, lanes(side), frames),
            "1111 lanes": (ht, lanes(winners(1111, 0.7)), frames)}


def mesh_camera_lanes(device, seed: int = 0):
    """Bounce-0 rays of the mesh frame's block (76800 lanes)."""
    return camera_lanes(MESH_WIDTH, MESH_HEIGHT, MESH_LANES_M, device, seed,
                        camera=scenes.terrain_camera(device))


def terrain_random_lanes(n: int, device, seed: int = 1):
    """Random rays from above and below the terrain_city ground."""
    return random_lanes(n, device, seed, lo=(-20.0, -2.0, -20.0), hi=(20.0, 6.0, 20.0),
                        t_far=30.0)


def rtiow_bvh_random_lanes(n: int, device, seed: int = 1):
    """Random rays over the RTIOW field, from below the small spheres' tops
    to above the large ones, a third with a finite t_max, a tenth dead."""
    return random_lanes(n, device, seed, lo=(-11.0, 0.0, -11.0), hi=(11.0, 2.5, 11.0),
                        t_far=8.0)


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


def check_bvh_closest_hit(bvh, rays, frames=None, branch=None) -> Dict[str, float]:
    """K5 against its plain version, bit for bit on every lane (with
    `frames`: object-space rays; `branch`: the walk's branch, by the tree's
    size when None); raises AssertionError on disagreement."""
    t, prim, u, v = bvh_closest_hit(bvh, *rays, frames, branch=branch)
    pt, pprim, pu, pv = bvh_closest_hit_plain(bvh, *rays, frames)
    bad = int((prim != pprim).sum())
    assert bad == 0, f"bvh_closest_hit: {bad} prim ids differ"
    for name, a, b in (("t", t, pt), ("u", u, pu), ("v", v, pv)):
        diff = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        assert diff == 0, f"bvh_closest_hit: {name} differs on {diff} lanes"
    hit = prim >= 0
    return {"max_abs_err": 0.0, "lanes": int(prim.shape[0]), "live": int((rays[3] > rays[2]).sum()),
            "hits": int(hit.sum()), "sphere hits": int((prim >= bvh.n_tris).sum())}


def check_bvh_any_hit(bvh, rays, frames=None, branch=None) -> Dict[str, float]:
    """K6 against its plain version (`branch` as check_bvh_closest_hit);
    raises AssertionError on disagreement."""
    occ = bvh_any_hit(bvh, *rays, frames, branch=branch)
    pocc = bvh_any_hit_plain(bvh, *rays, frames)
    diff = int((occ != pocc).sum())
    assert diff == 0, f"bvh_any_hit: {diff} lanes differ"
    return {"max_abs_err": 0.0, "lanes": int(occ.shape[0]), "live": int((rays[3] > rays[2]).sum()),
            "occluded": int(occ.sum())}


def static_bvh(v0, v1, v2, center, radius, device):
    """A static BVH (build.build_bvh's tree) over triangles given by their
    absolute vertices [T, 3] and spheres [S, 3], [S] (numpy)."""
    from ..accel import build

    v0, v1, v2, center, radius = (np.ascontiguousarray(x, np.float32)
                                  for x in (v0, v1, v2, center, radius))
    boxes = [np.concatenate(x) for x in zip(build.prim_aabbs(v0, v1, v2),
                                            build.sphere_aabbs(center, radius))]
    rows = build.leaf_rows(v0, v1, v2, center, radius, np.zeros(v0.shape[0], np.int32),
                           np.zeros(center.shape[0], np.int32))
    nodes, prim_v, depth = build.pack_bvh(build._sah_build(*boxes, build.LEAF_SIZE), rows)
    return BVHArrays(torch.as_tensor(nodes, device=device), torch.as_tensor(prim_v, device=device),
                     depth, v0.shape[0], center.shape[0], 1)


def tie_bvh(device, side: int = 6):
    """A side x side grid of unit spheres (centres (2i, 0, 2j)), each under
    a triangle in the plane y = 1 that touches its top: a ray straight down
    through a centre meets both at one t (t_tie_lanes)."""
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), -1).reshape(-1, 2)
    c = np.stack([2.0 * g[:, 0], np.zeros(len(g)), 2.0 * g[:, 1]], -1)
    v0, v1, v2 = (c + np.array(off) for off in ((-0.5, 1, -0.5), (0.5, 1, -0.5), (0, 1, 0.5)))
    return static_bvh(v0, v1, v2, c, np.ones(len(g)), device)


def sphere_tree_past(budget: int, frames_bytes, device, seed: int = 21, start: int = 16):
    """The smallest random field of small spheres (a static BVH) whose
    staged layout (`frames_bytes(bvh)`: traverse.layout_bytes with the
    staged flag) passes `budget` bytes: the L2 walk's smallest tree."""
    rs = np.random.default_rng(seed)
    pts = rs.uniform(-8.0, 8.0, size=(4096, 3))
    rad = rs.uniform(0.3, 1.0, size=4096)
    lo, hi = start, 4096
    while lo < hi:   # staged bytes grow with the spheres, up to the tree's depth
        mid = (lo + hi) // 2
        bvh = static_bvh(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), pts[:mid],
                         rad[:mid], device)
        if frames_bytes(bvh) > budget:
            hi = mid
        else:
            lo = mid + 1
    return static_bvh(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), pts[:lo], rad[:lo],
                      device)


def _lanes(o, d, device, t_max=None, t_min=None):
    o, d = np.asarray(o, np.float32), np.asarray(d, np.float64)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    n = o.shape[0]
    t_min = torch.full((n,), MIN_HIT, device=device) if t_min is None else t_min
    t_max = torch.full((n,), BIG, device=device) if t_max is None else t_max
    return _f32(o, device), _f32(d, device), t_min, t_max


def _row_world_points(bvh, frames):
    """Each leaf row's centroid (a sphere's centre) in world space at the
    frame's instant, and its animation id: m_fwd p + t_inv."""
    rows = bvh.prim_v.cpu()
    ids = rows.view(torch.int32)
    sph = ids[:, 3] >= bvh.n_tris
    p = torch.where(sph[:, None], rows[:, 0:3], (rows[:, 0:3] + rows[:, 4:7] + rows[:, 8:11]) / 3)
    aid = ids[:, 7].long()
    if frames is None:
        return p, aid
    fr = frames.cpu()[aid]
    m = fr[:, 12:21].reshape(-1, 3, 3)
    return (m @ p[:, :, None])[:, :, 0] + fr[:, 9:12], aid


def signed_zero_lanes(device, frames, seed: int = 0):
    """(tree, rays, frames): twelve static triangles with a corner at
    (-0, -0, -0) and legs of +-1 in the planes x, y, z = -0, walked in object
    space (`frames`: every row the identity), and rays along each axis at
    that corner and the legs' midpoints, their zero origin and direction
    components of both signs. Only here do the identity's signed zeros reach
    the outputs: a product with row 0 turns some -0 components of o and d
    into +0, and -0 vertex words then give u and v zeros of other signs."""
    z = np.float32(-0.0)
    v0, v1, v2 = [], [], []
    for ax in range(3):
        a1, a2 = (ax + 1) % 3, (ax + 2) % 3
        for s1 in (-1.0, 1.0):
            for s2 in (-1.0, 1.0):
                p = [np.full(3, z, np.float32) for _ in range(3)]
                p[1][a1] = s1
                p[2][a2] = s2
                v0.append(p[0])
                v1.append(p[1])
                v2.append(p[2])
    bvh = static_bvh(np.array(v0), np.array(v1), np.array(v2), np.zeros((0, 3)), np.zeros(0),
                     device)
    rs = np.random.default_rng(seed)
    n = 768
    ax = rs.integers(0, 3, size=n)
    side = rs.choice([-1.0, 1.0], size=n)
    at = np.zeros((n, 3))
    leg = rs.integers(0, 3, size=n)           # 0: the corner, 1-2: a leg's midpoint
    other = (ax + leg) % 3
    at[leg > 0, other[leg > 0]] = rs.choice([-0.5, 0.5], size=int((leg > 0).sum()))
    zs = rs.choice([-1.0, 1.0], size=(n, 3))
    o = np.where(at == 0.0, np.copysign(0.0, zs), at).astype(np.float32)
    o[np.arange(n), ax] = side * rs.uniform(0.5, 3.0, size=n)
    zd = rs.choice([-1.0, 1.0], size=(n, 3))
    d = np.copysign(np.zeros((n, 3)), zd).astype(np.float32)
    d[np.arange(n), ax] = -side
    return bvh, (_f32(o, device), _f32(d, device), torch.full((n,), MIN_HIT, device=device),
                 torch.full((n,), BIG, device=device)), frames


def bvh_leaf_edge_sets(rt, an, frames, device, waves=(), budget=None, frames_bytes=None,
                       seed: int = 0, n: int = 1024):
    """{name: (tree, rays, frames or None)}: K5/K6's leaf branches at their
    edges, each set held bit for bit against the plain walk. `rt` is an
    RTIOW field's BVH (sphere rows, the radius-1000 ground sphere first),
    `an` the animated box with spheres (cornell_box_animated(spheres=True,
    use_bvh=True)) with its frame rows `frames`:
    - grazing rays on the ground sphere, where c cancels to its last bits;
    - rays from inside spheres (the exit distance); tangent rays (disc
      about 0);
    - rays aimed at every leaf row of the animated box (leaves that
      alternate animation 0 with moving rows);
    - axis-aligned rays at the static rows' vertices with +0 and -0 in
      their zero direction and origin components, and `signed_zero_lanes`
      (signed zeros of the identity);
    - a triangle and a sphere tied at one t (`tie_bvh`);
    - t_max one float beyond the plain hit, and at it;
    - one live lane, and every lane dead;
    - for each of `waves` (a launch's resident threads), lane counts 37
      below, at and 1013 above it;
    - with `budget`, a tree just past the staging budget
      (`sphere_tree_past` with `frames_bytes`)."""
    rs = np.random.default_rng(seed)
    sets = {}
    # RTIOW: grazing rays on the ground sphere (centre (0, -1000, 0), r 1000)
    xz = rs.uniform(-10.0, 10.0, size=(n, 2))
    y = -1000.0 + np.sqrt(1e6 - (xz ** 2).sum(1))
    h = rs.choice([0.0, 1e-4, -1e-4, 1e-3, 3e-3], size=n)
    phi = rs.uniform(0, 2 * np.pi, size=n)
    tilt = rs.choice([0.0, 1e-3, -1e-3, 1e-4, -1e-4, 3e-2], size=n)
    o = np.stack([xz[:, 0], y + h, xz[:, 1]], -1)
    d = np.stack([np.cos(phi), tilt, np.sin(phi)], -1)
    sets["rtiow grazing the ground sphere"] = (rt, _lanes(o, d, device), None)
    sph = rt.prim_v.cpu().numpy()
    c, r = sph[:, 0:3].astype(np.float64), sph[:, 4].astype(np.float64)
    k = rs.integers(0, len(sph), size=n)
    off = rs.normal(size=(n, 3))
    off *= (0.5 * r[k] * rs.uniform(0, 1, size=n) / np.linalg.norm(off, axis=-1))[:, None]
    sets["rtiow from inside spheres"] = (rt, _lanes(c[k] + off, rs.normal(size=(n, 3)), device),
                                         None)
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = np.cross(d, rs.normal(size=(n, 3)))
    p /= np.linalg.norm(p, axis=-1, keepdims=True)
    s = r[k] + rs.uniform(0.5, 3.0, size=n)
    sets["rtiow tangent rays"] = (rt, _lanes(c[k] + r[k, None] * p - s[:, None] * d, d, device),
                                  None)
    # The animated box: rays aimed at every leaf row, from inside the box
    pw, aid = _row_world_points(an, frames)
    k = rs.integers(0, pw.shape[0], size=n)
    o = rs.uniform((-1.0, 0.0, -1.0), (1.0, 2.0, 3.0), size=(n, 3))
    target = pw.numpy()[k] + rs.normal(scale=0.02, size=(n, 3))
    sets["animated box aimed at every row"] = (an, _lanes(o, target - o, device), frames)
    # the same rays past the object-ray cache's slots: every other moving
    # row takes its animation 8 rows further on, moved by 0.01 (the boxes
    # stay the tree's: both walks walk it alike), so two animations share
    # each slot
    a = frames.shape[0]
    moved = frames[1:].clone()
    moved[:, 9:12] += 0.01
    wide = torch.cat([frames, frames[:1].expand(9 - a, -1), moved]).contiguous()
    rows = an.prim_v.clone()
    ids = rows.view(torch.int32)[:, 7]
    ids[torch.nonzero(ids > 0)[:, 0][::2]] += 8
    sets["animated box, animations sharing cache slots"] = (
        an._replace(prim_v=rows, n_anims=8 + a), _lanes(o, target - o, device), wide)
    # axis-aligned rays at the static rows' vertices, zeros of both signs
    rows = an.prim_v.cpu().numpy()
    static_tri = np.nonzero((rows.view(np.int32)[:, 3] < an.n_tris) & (aid.numpy() == 0))[0]
    verts = np.tile(rows[static_tri][:, [0, 1, 2, 4, 5, 6, 8, 9, 10]].reshape(-1, 3), (16, 1))
    m = verts.shape[0]
    axis = rs.integers(0, 3, size=m)
    sign = rs.choice([-1.0, 1.0], size=m)
    dz = np.zeros((m, 3), np.float32)
    dz[np.arange(m), axis] = -sign
    zero_sign = rs.choice([-1.0, 1.0], size=(m, 3)).astype(np.float32)
    dz = np.where(dz == 0.0, np.copysign(np.float32(0.0), zero_sign), dz).astype(np.float32)
    o = verts.astype(np.float32).copy()
    o[np.arange(m), axis] += (sign * rs.uniform(0.5, 2.0, size=m)).astype(np.float32)
    o = np.where(o == 0.0, np.copysign(np.float32(0.0), -zero_sign), o).astype(np.float32)
    sets["animated box vertices, signed zeros"] = (
        an, (_f32(o, device), _f32(dz, device), torch.full((m,), MIN_HIT, device=device),
             torch.full((m,), BIG, device=device)), frames)
    sets["identity rows at -0, signed zeros"] = signed_zero_lanes(device, frames, seed)
    # a triangle and a sphere tied at one t
    tie = tie_bvh(device)
    g = tie.prim_v.cpu().numpy()[tie.prim_v.cpu().numpy().view(np.int32)[:, 3] >= tie.n_tris]
    k = rs.integers(0, g.shape[0], size=n)
    heights = rs.choice([3.0, 5.0, 9.0, 17.0], size=n)
    o = g[k, 0:3] + np.stack([np.zeros(n), heights, np.zeros(n)], -1)
    jit = rs.random(n) < 0.25
    o[jit, 0] += rs.uniform(-0.3, 0.3, size=int(jit.sum()))
    sets["a triangle and a sphere tied"] = (tie, _lanes(o, np.tile([0.0, -1.0, 0.0], (n, 1)),
                                                        device), None)
    # t_max one float beyond the hit, and at it
    for name, bvh, fr, rays in (("rtiow", rt, None, rtiow_camera_lanes(device)),
                                ("animated box", an, frames,
                                 camera_lanes(32, 32, 1, device))):
        pick = torch.linspace(0, rays[0].shape[0] - 1, n, device=device).long()
        rays = tuple(x[pick].contiguous() for x in rays)
        t, prim, _, _ = bvh_closest_hit_plain(bvh, *rays, fr)
        hit = prim >= 0
        beyond = torch.where(hit, torch.nextafter(t, torch.full_like(t, float("inf"))), rays[3])
        sets[f"{name}, t_max a float beyond the hit"] = (bvh, rays[:3] + (beyond,), fr)
        sets[f"{name}, t_max at the hit"] = (bvh, rays[:3] + (torch.where(hit, t, rays[3]),), fr)
    rnd = random_lanes(n, device, seed=seed + 5)
    hits = torch.nonzero(bvh_closest_hit_plain(an, *rnd, frames)[1] >= 0)[:, 0]
    one = torch.zeros_like(rnd[3])
    one[hits[hits.shape[0] // 2]] = rnd[3][hits[hits.shape[0] // 2]]   # a lane that hits
    sets["animated box, one live lane"] = (an, rnd[:3] + (one,), frames)
    sets["rtiow, every lane dead"] = (rt, rnd[:3] + (torch.zeros_like(rnd[3]),), None)
    for w in waves:
        for m in (w - 37, w, w + 1013):
            rays = random_lanes(m, device, seed=seed + m)
            sets[f"animated box, {m} lanes (a wave of {w})"] = (an, rays, frames)
    if budget is not None:
        past = sphere_tree_past(budget, frames_bytes, device)
        rays = random_lanes(n, device, seed=seed + 9, lo=(-8.0, -8.0, -8.0), hi=(8.0, 8.0, 8.0),
                            t_far=8.0)
        sets["a tree just past the staging budget"] = (past, rays, None)
    return sets


def check_bvh_edge_sets(sets, branch=None) -> Dict[str, float]:
    """K5 and K6 on every set of bvh_leaf_edge_sets, bit for bit (`branch`
    as check_bvh_closest_hit)."""
    out = {"sets": len(sets), "lanes": 0, "hits": 0, "occluded": 0}
    for name, (bvh, rays, fr) in sets.items():
        try:
            c = check_bvh_closest_hit(bvh, rays, fr, branch)
            a = check_bvh_any_hit(bvh, rays, fr, branch)
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
        out["lanes"] += c["lanes"]
        out["hits"] += c["hits"]
        out["occluded"] += a["occluded"]
    out["max_abs_err"] = 0.0
    return out


def envmap_camera_lanes(device, seed: int = 0):
    """Bounce-0 rays of the envmap frame's block (131072 lanes)."""
    return camera_lanes(ENVMAP_WIDTH, ENVMAP_WIDTH, ENVMAP_LANES_M, device, seed,
                        camera=scenes.envmap_camera(device))


def rtiow_camera_lanes(device, seed: int = 0):
    """Bounce-0 rays of the rtiow frame's block (98304 lanes), OpenCV lens."""
    return camera_lanes(RTIOW_WIDTH, RTIOW_HEIGHT, RTIOW_LANES_M, device, seed,
                        camera=scenes.rtiow_camera(device), cfg=RTIOW_CAMERA, lens=RTIOW_LENS)


def lane_mask(n: int, share: float, device, seed: int = 8):
    """A bool mask [n] with `share` of the lanes set, scattered from numpy `seed`."""
    return torch.as_tensor(np.random.default_rng(seed).permutation(n) < round(share * n),
                           device=device)


def check_env_lanes(env, x, active, sample: bool) -> Dict[str, float]:
    """K8's pair of a bounce in one launch, under the mask `active` [N] (or
    None): env_nee_raw on uniforms x (`sample`), else env_miss_raw on
    directions x (with the pdf where the map has importance tables). Held
    bit for bit to the single entry points launched in turn under the same
    mask (env_sample then env_radiance of its directions; env_radiance and
    env_pdf), the lanes outside the mask to their fixed values (radiance
    and pdf 0, the sample's direction `skipped_direction`), and to the plain
    version (`env_nee_plain` / `env_miss_plain`) bit for bit (on the CPU
    the wrappers run the plain version); raises AssertionError. Returns
    the largest difference from the plain version and the lanes that
    differ from it in any bit (0)."""
    pdf = env.importance
    if sample:
        got = env_nee_raw(env, x, active)
        d, p = env_sample_raw(env, x, active)
        single = (d, p, env_radiance_raw(env, d, active))
        ref = env_nee_plain(env, x, active)
        names = ("direction", "pdf", "radiance")
    else:
        got = env_miss_raw(env, x, active, pdf)
        single = (env_radiance_raw(env, x, active), env_pdf(env, x, active) if pdf else None)
        ref = env_miss_plain(env, x, active, pdf)
        names = ("radiance", "pdf")
    n = x.shape[0]
    err, differ = 0.0, torch.zeros(n, dtype=torch.bool, device=x.device)
    for name, a, b, r in zip(names, got, single, ref):
        if a is None:
            assert b is None and r is None, f"env lanes: {name} missing"
            continue
        assert torch.equal(a, b), f"env lanes: {name} differs from the single entry point's"
        if active is not None:
            off = ~active
            want = (skipped_direction(env).expand(n, 3) if name == "direction"
                    else torch.zeros_like(a))
            assert torch.equal(a[off], want[off]), f"env lanes: masked lanes' {name} not fixed"
        err = max(err, float((a - r).abs().max()) if n else 0.0)
        differ |= (a != r).reshape(n, -1).any(-1)
    assert not bool(differ.any()), (f"env lanes: {int(differ.sum())} of {n} lanes differ from "
                                    f"the plain version (largest {err})")
    live = n if active is None else int(active.sum())
    return {"max_abs_err": err, "lanes": n, "live": live, "lanes_differ": int(differ.sum())}


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
    o, d, _ = camera_rays(cam, CITY_CAMERA, _f32(pxy, device), CITY_WIDTH, CITY_HEIGHT)
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
    _, d, _ = camera_rays(cam, CITY_CAMERA, _f32(pxy, device), CITY_WIDTH, CITY_HEIGHT)
    return d.contiguous(), _f32(rs.uniform(size=(CITY_LANES, 3)), device)


def lanes_differ(a, b) -> int:
    """Lanes (rows) of a and b whose words differ in a bit (a NaN matches
    any NaN)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
    if a.is_floating_point():
        same = same & (torch.signbit(a) == torch.signbit(b))
    return int((~same.reshape(a.shape[0], -1).all(-1)).sum())


def check_rgl(tables, lanes) -> Dict[str, float]:
    """K7's two entry points against their plain versions on lanes (mid, wi,
    wo, u2): every output bit-equal on every lane (a lane with a negative
    id: zeros, sample's ok false)."""
    mid, wi, wo, u2 = lanes
    got = rgl_eval(tables, mid, wi, wo) + rgl_sample(tables, mid, wi, u2)
    ref = rgl_eval_plain(tables, mid, wi, wo) + rgl_sample_plain(tables, mid, wi, u2)
    for name, a, b in zip(("eval f*cos", "eval pdf", "sample wo", "sample f*cos", "sample pdf",
                           "sample ok"), got, ref):
        off = lanes_differ(a, b)
        assert off == 0, f"rgl {name}: {off} lanes differ from the plain version"
    live = mid >= 0
    err = max(float((a - b).abs().nan_to_num(0.0).max()) if a.numel() else 0.0
              for a, b in zip(got[:5], ref[:5]))   # NaN only where both are (checked above)
    p, ok = got[1], got[5]
    return {"max_abs_err": err, "lanes": int(mid.shape[0]), "live": int(live.sum()),
            "eval_nonzero": int((p > 0).sum()), "sample_ok": int(ok.sum())}


def wide_rgl_lanes(device, n: int = 262144, seed: int = 31):
    """K7's inputs on wide warps: two synthetic materials from numpy `seed`,
    the first with 128 x 128 vndf and luminance tables over a 2 x 3
    parameter grid (four corners), the second 33 x 33 and 16 x 16 over 1 x
    2 (the stack pads it to the first's: its rows masked by its widths), and
    n lanes: ids -1 (no RGL material), 0 or 1, wi and wo on the sphere
    (mostly above the surface), u2 uniform. (tables, mid, wi, wo, u2)."""
    rs = np.random.default_rng(seed)

    def fields(k, P, T, hv, hl, hn):
        return dict(phi_i=np.linspace(-np.pi, np.pi, P).astype(np.float32),
                    theta_i=np.linspace(0.0, np.pi / 2, T).astype(np.float32),
                    ndf=scenes._smooth_positive((hn, hn), seed + 10 * k + 1),
                    sigma=scenes._smooth_positive((hn, hn), seed + 10 * k + 2, 0.2, 0.4),
                    vndf=scenes._smooth_positive((P, T, hv, hv), seed + 10 * k + 3),
                    luminance=scenes._smooth_positive((P, T, hl, hl), seed + 10 * k + 4),
                    rgb=scenes._smooth_positive((P, T, 3, hl, hl), seed + 10 * k + 5))

    tables = stack_rgl_tables([load_rgl_material(fields(0, 2, 3, 128, 128, 32)),
                               load_rgl_material(fields(1, 1, 2, 33, 16, 16))], device)

    def dirs():
        x = rs.standard_normal((n, 3))
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        x[:, 2] = np.abs(x[:, 2]) * np.where(rs.uniform(size=n) < 0.1, -1.0, 1.0)
        return _f32(x, device)

    mid = torch.as_tensor(rs.choice(np.array([-1, 0, 1], np.int32), n, p=[0.2, 0.4, 0.4]),
                          device=device)
    wi, wo = dirs(), dirs()
    return tables, mid, wi, wo, _f32(rs.uniform(size=(n, 2)), device)


def capture_rgl_calls(render) -> List[Tuple[str, object, torch.Tensor, torch.Tensor,
                                            torch.Tensor]]:
    """Runs render() with K7's wrappers watched: each call's (kind, tables,
    mid, wi, x), its inputs cloned, x wo (eval) or u2 (sample), in call
    order."""
    calls = []
    eval_raw, sample_raw = rgl_module.rgl_eval_raw, rgl_module.rgl_sample_raw

    def watch(kind, raw):
        def call(tables, mid, wi, x):
            calls.append((kind, tables, mid.clone(), wi.clone(), x.clone()))
            return raw(tables, mid, wi, x)
        return call

    rgl_module.rgl_eval_raw = watch("eval", eval_raw)
    rgl_module.rgl_sample_raw = watch("sample", sample_raw)
    try:
        render()
    finally:
        rgl_module.rgl_eval_raw, rgl_module.rgl_sample_raw = eval_raw, sample_raw
    return calls


def check_row_gather(table, idx) -> Dict[str, float]:
    """P0 against its plain version: equal word for word."""
    out, ref = row_gather(table, idx), row_gather_plain(table, idx)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), "row_gather differs"
    return {"max_abs_err": 0.0, "rows": int(idx.shape[0]), "cols": int(table.shape[1])}


def gather_words(cols: int, device, seed: int = 0, rows: int = 37, n: int = 1001):
    """A [rows, cols] float32 table whose words are random floats and, on a
    fifth of them, quiet and signalling NaNs with payloads, and n indices
    [n] from 5 below the table to 5 past its end (P0 clamps them)."""
    rs = np.random.default_rng(seed)
    words = rs.standard_normal((rows, cols)).astype(np.float32).view(np.int32)
    nan = rs.random((rows, cols)) < 0.2
    words[nan] = rs.choice(np.array([0x7FC00001, 0x7FA00000, -0x00400001, 0x7F800001],
                                    dtype=np.int64), int(nan.sum())).astype(np.int32)
    table = torch.as_tensor(words, device=device).view(torch.float32)
    return table, torch.as_tensor(rs.integers(-5, rows + 5, n), dtype=torch.int32, device=device)


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

    regen: tuple      # regen_pinhole(*regen) or regen_surround(*regen), the step
                      # before's pending deposits and occlusion last (None at the start)
    shade: tuple      # shade_diffuse / shade_env / shade_lit(*shade), st.stats replaced per call
    resolve: tuple    # nee_resolve(*resolve)
    assemble: Optional[tuple] = None   # K3's K4 form before the shade: (hit tables,
                                        # (o, d, t, prim, u, v), frames, field set)


def k4_route(inputs: K4Inputs):
    """The regeneration and the shade of `inputs`' class and camera
    (wavefront.K4Route)."""
    from ..render import wavefront as wf

    return wf.k4_route(inputs.shade[0], inputs.regen[4])


def regenerated_lanes(inputs: K4Inputs) -> int:
    """How many lanes the regeneration on `inputs` refills: dead lanes whose
    pixel has samples left. A check or a time of the regeneration on inputs
    where none is means a copy of the state, not a regeneration."""
    st, _, k_next, _, _, lanes = inputs.regen[:6]
    return int(((~st.active) & (k_next < lanes.P) & lanes.valid).sum())


def k4_inputs(device, frame: str = "cornell", steps: int = 2, width: int = 0, ssqrt: int = 0,
              m: int = 0, height: int = 0, scene=None, sensor=None, cfg=None) -> K4Inputs:
    """The inputs of K4's kernels on the first block of the Cornell bench
    frame (131072 lanes), the rtiow_dof frame (128000 lanes, through the
    thin lens), the animated Cornell frame (cornell_animated, the
    same lanes at t = ANIM_TIME: the sweeps' casts, K3a, the moving light
    in the step tables; cornell_animated_bvh: with its spheres, cast through
    its BVH), the ToF frame (phase 0, 73728 lanes), the mesh frame (76800
    lanes), the envmap frame (131072 lanes), the rtiow frame (98304 lanes,
    through its OpenCV lens; rtiow_bvh: the 488 spheres of the full field in
    a BVH, the same lanes) or the city frame (1048576 of its
    2073600 pixels at 1 spp, 360-degree stereo), after `steps` wavefront
    steps of the plain route (regen_plain with the step before's pending
    deposits, the scene's closest-hit cast, K3, the class's plain shade, the
    scene's any-hit cast where the shade casts shadow rays): lanes live,
    dead and (with more than one sample per lane) due for regeneration side
    by side. The regeneration's inputs are that state with the last step's
    pending deposits and their occlusion (none where `steps` is 0 or the
    step casts no shadow ray); the shade's, the state after that plain
    regeneration and its casts; the resolve's (the stand-alone
    nee_resolve), the plain shade's pending deposits and their shadow casts;
    `assemble`, the hit assembly's before that shade (the tables, the
    winners, the frames and the class's field set, for K3's K4 form).
    `width`, `height` (= width
    when only `width` is given), `ssqrt`, `m` (sample lanes per pixel),
    `scene`, `sensor` and the camera config `cfg` (the lens model) replace
    the frame's own where given; a block holds at most the frame's lanes
    (131072, the city's 1048576) over m."""
    from ..render import wavefront as wf

    lens = None
    own_cfg = CameraConfig()
    eye_distance, max_lanes = 0.0635, 131072
    if frame in ("cornell", "cornell_animated", "cornell_animated_bvh"):
        own = ({"cornell": scenes.cornell_box_ref, "cornell_animated": scenes.cornell_box_animated,
                "cornell_animated_bvh": lambda dev: scenes.cornell_box_animated(
                    dev, spheres=True, use_bvh=True)}[frame], scenes.cornell_ref_camera)
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
    elif frame in ("rtiow", "rtiow_bvh"):
        own = ((lambda dev: scenes.rtiow(device=dev)) if frame == "rtiow" else
               (lambda dev: scenes.rtiow(n=RTIOW_BVH_N, device=dev, use_bvh=True)),
               scenes.rtiow_camera)
        size = (RTIOW_WIDTH, RTIOW_HEIGHT, RTIOW_SSQRT, RTIOW_LANES_M)
        depth, own_sensor, own_cfg, lens = RTIOW_DEPTH, SensorRGB(), RTIOW_CAMERA, RTIOW_LENS
    elif frame == "rtiow_dof":
        own = ((lambda dev: scenes.rtiow(device=dev)),
               lambda dev: (scenes.rtiow_camera(dev)[0], 25.0))
        size = (DOF_WIDTH, DOF_HEIGHT, DOF_SSQRT, DOF_LANES_M)
        depth, own_sensor, own_cfg = DOF_DEPTH, SensorRGB(), CameraConfig(dof=True)
        lens = {"focus_distance": DOF_FOCUS, "aperture_diameter": DOF_APERTURE}
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

    pending = occ = None
    for _ in range(steps + 1):
        regen_args = (st, sample, k_next, cam, cfg, lanes, True, pending, occ)
        st, sample, k_next, t_max, _ = wf.regen_plain(*regen_args)
        t, prim, u, v = scene_raw_hit(accel, st.o, st.d, t_min[:L], t_max, frames)
        hr = assemble_hit(ht, st.o, st.d, t, prim, u, v, frames)
        assemble = (ht, (st.o, st.d, t, prim, u, v), frames, route.hit_fields)
        shade_args = (tables, sensor, params, st, lanes.pixel, sample, t, prim, hr)
        st, so, sd, stmax, pending = route.shade_plain(*shade_args)
        occ = None if stmax is None else scene_any_hit(accel, so, sd, t_min, stmax, frames)
    return K4Inputs(regen_args, shade_args, (st.acc, pending, occ, st.active, k_next, lanes),
                    assemble)


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


REGEN_OUT = ("state", "sample", "k_next", "t_max", "work")
SHADE_OUT = ("state", "shadow_o", "shadow_d", "shadow_tmax", "pending", "stats")


def check_call(kernel, plain, args, cast_rows: bool = False,
               exact_rows: bool = True) -> Dict[str, float]:
    """`kernel` against `plain` (a regeneration or a shade and their plain
    versions), each on its own copy of `args` (see `_compare`). A shade's
    counters are compared too; with `cast_rows` (the in-place shades, which
    write a shadow ray only where it casts) the shadow t_max must be
    bit-equal on every row (`exact_rows`; else it is held as any float
    field, for a build whose libm is not the card's) and the shadow origins
    and directions are compared on the rows that cast only."""
    from ..render.wavefront import LoopState

    regen = isinstance(args[0], LoopState)
    names = REGEN_OUT if regen else SHADE_OUT

    def run(fn):
        a = fresh_args(args)
        out = fn(*a)
        return _named(out if regen else out + (a[3].stats,), names)

    got, ref = run(kernel), run(plain)
    if "shadow_tmax" in got:
        if cast_rows and exact_rows:
            same = ((got["shadow_tmax"] == ref["shadow_tmax"])
                    | (torch.isnan(got["shadow_tmax"]) & torch.isnan(ref["shadow_tmax"])))
            assert bool(same.all()), f"shadow t_max differs on {int((~same).sum())} rows"
        if cast_rows:
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
                                            cast_rows=True)}
    names = ("acc", "work")
    res["nee_resolve"] = _compare(_named(wf.nee_resolve(*inputs.resolve), names),
                                  _named(wf.nee_resolve_plain(*inputs.resolve), names), n)
    return res


def _hit_types(tables, hr, prim):
    """The material type of each lane's winner, -1 on a miss lane: K3's K4
    form leaves a miss lane's material unwritten (ROADMAP C.6)."""
    typ = tables.mat[:, 20].contiguous().view(torch.int32)
    return torch.where(prim >= 0, typ[hr.mat.long().clamp(0, typ.shape[0] - 1)], -1)


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
    and the shades update the lane state in place: a lane pays only the
    fields its branch reads and changes (`in_place=False`: the bound of the
    earlier kernels, which wrote every lane's whole state anew; the
    regeneration: each lane's flags and its old state where it is kept).
    The regeneration in place reads every lane's active flag and a dead
    lane's next sample index, writes every lane's t_max and a regenerated
    lane's state, sample id and next sample index. Flops are tallies of
    the code per lane: the regeneration ~60 per regenerated lane (jitter, the
    pinhole ray, its rotation) plus the lens model's inverse (`LENS_FLOPS`,
    per step of the OpenCV fixed point); the shades as `_diffuse_shade_work`,
    `_env_shade_work` and `_lit_shade_work` say (in place) and their
    `_copy_work` twins (the copy contract); the surround regeneration ~180
    per regenerated lane (four sines and cosines, two rotations); the
    deposits of the step before, which the regeneration adds first, and
    the resolve one add per accumulator channel on each unoccluded row
    (`_deposit_work`)."""
    if kernel in ("regen_pinhole", "regen_surround"):
        st, sample, k_next, cam, cfg, lanes, _, pending, occluded = inputs.regen
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
        dep_bytes, dep_flops = _deposit_work(st.acc, pending, occluded, in_place)
        flops = per_lane * n_need + dep_flops
        if in_place:
            n_dead = int((~st.active).sum())
            n_bytes = (n * _lane_bytes(st.active, st.geom_len)          # geom_len: t_max
                       + n_dead * _lane_bytes(k_next)
                       + n_need * _lane_bytes(*state, sample, k_next))
            return n_bytes + dep_bytes + _table_bytes(camera), flops
        read = (n * _lane_bytes(st.active, k_next, st.prev_random)
                + (n - n_need) * _lane_bytes(sample, *kept))
        written = n * _lane_bytes(*state, sample, k_next, st.geom_len)      # geom_len: t_max
        return read + written + dep_bytes + _table_bytes(camera), flops
    if kernel == "shade_lit":
        return _lit_shade_work(inputs) if in_place else _lit_shade_copy_work(inputs)
    if kernel == "shade_diffuse":
        return _diffuse_shade_work(inputs) if in_place else _diffuse_shade_copy_work(inputs)
    if kernel == "shade_env":
        return _env_shade_work(inputs) if in_place else _env_shade_copy_work(inputs)
    acc, pending, occluded, active, k_next, _ = inputs.resolve
    dep_bytes, dep_flops = _deposit_work(acc, pending, occluded, in_place=False)
    flag = acc.shape[0] * _lane_bytes(active) + int((~active).sum()) * _lane_bytes(k_next)
    return flag + dep_bytes, dep_flops


def _deposit_work(acc, pending, occluded, in_place: bool):
    """(bytes, flops) of adding a step's pending deposits to acc (none: 0
    and the loop flag's 4 bytes): every lane's acc and occlusion flags read,
    an unoccluded row's deposit read, one add per channel on it; written in
    place the acc elements whose bits change, else every lane's acc; and
    the flag."""
    from ..render.wavefront import deposit_pending

    if pending is None:
        return 4, 0.0
    n, n_acc = acc.shape
    n_open = int((~occluded).sum())       # unoccluded rows (two per lane in the lit class)
    new = deposit_pending(acc, pending, occluded)
    written = (int((new.view(torch.int32) != acc.view(torch.int32)).sum()) * acc.element_size()
               if in_place else n * _lane_bytes(acc))
    read = (n * _lane_bytes(acc) + occluded.numel() * occluded.element_size()
            + n_open * _lane_bytes(pending))
    return read + written + 4, float(n_open * n_acc)


def _diffuse_shade_copy_work(inputs: K4Inputs):
    """(bytes, flops) of the diffuse shade that wrote new state (the kernel
    before the in-place contract) on `inputs`. Bytes: every lane's state,
    sample id, pixel and hit position (its shadow ray's origin); the
    primitive id on active lanes; t, the ray IOR, normal, backside,
    material and the previous sample's flag on hit lanes; the origin where
    the ray missed; the previous pdf with the geometric normal (per-light
    MIS) or the previous mixture pdf on hit lanes whose flag is set; out
    the next state but the ray IOR, and every lane's shadow direction,
    t_max and pending deposit; the material and light rows once. Flops:
    ~250 per lane (emission, the cosine sample, the light's sample and pdf,
    the roulette) and 2 x 70 per light on RANDOM lanes of a mixture scene
    (counted with the plain version)."""
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


def _env_shade_copy_work(inputs: K4Inputs):
    """(bytes, flops) of the env shade that wrote new state (the kernel
    before the in-place contract) on `inputs`. Bytes: every lane's state,
    sample id and pixel (and ray IOR with glass, read and written back);
    the primitive id on active lanes; t, position, normal, backside,
    material (and the ray IOR without glass) on hit lanes, the tangent on
    GGX hits; the origin where the ray missed; with importance tables the
    previous sample's flag on escaped lanes and its pdf where the flag is
    set, and every lane's shadow direction, t_max and pending deposit; out
    the next state but the mixture pdf; the material rows and the sky once.
    Flops: ~170 per lane (emission, the roulette) and 80 more for the sky
    sample with importance tables, per escaped lane the sky's lookup
    (`SKY_LOOKUP_FLOPS`) and pdf (`SKY_PDF_FLOPS`, importance only), the
    sample per hit lane (~60 Lambertian, ~350 GGX, ~100 glass) and ~80 per
    RANDOM lane with importance tables (the sky's lookup toward the sample,
    the weight)."""
    from ..render import wavefront as wf

    tables, _, _, st, pixel, sample, t, prim, hr = inputs.shade
    env = tables.env
    imp = env.importance
    glass = MaterialType.GLASS in tables.mat_types
    n = st.active.shape[0]
    hit = (prim >= 0) & st.active
    escaped = st.active & (prim < 0)
    typ = _hit_types(tables, hr, prim)
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


def _diffuse_shade_work(inputs: K4Inputs):
    """(bytes, flops) of the diffuse shade in place on `inputs`, by branch.
    Every lane reads its active flag. A dead lane writes its previous
    sample's pdf, flag and mixture pdf and its idle shadow row (t_max and
    pending deposit): 25 B. Every lane reads its primitive id beside the
    flag (one round trip). An escaped lane reads its deposits and bounce index and writes them, its
    end, its previous-sample fields and its idle row. A hit lane reads its
    bounce index, t, direction, deposits, normal, position, throughput,
    ray IOR, backside, material, path lengths and the previous sample's
    flag (where it is set the pdf and the geometric normal (per-light MIS)
    or the mixture pdf), on a Lambertian hit its pixel and sample id; it
    writes its deposits, bounce index, origin, path lengths, end and
    previous-sample fields, on a RANDOM lane its direction, throughput and
    shadow ray (direction, t_max, pending deposit), else its idle row. The
    material and light rows once. Flops: ~150 per hit lane (emission, two
    uniforms, the cosine sample, the roulette), ~100 per RANDOM lane (a
    uniform, the light's sample, its weight and deposit) and 2 x 70 per
    light there in a mixture scene."""
    tables, _, _, st, pixel, sample, t, prim, hr = inputs.shade
    n = st.active.shape[0]
    dead, escaped, hit, random, _, typ = _shade_lanes(inputs)
    count = lambda m: int(m.sum())  # noqa: E731
    flags = _lane_bytes(st.prev_pdf, st.prev_random, st.prev_light_pdf)
    idle_row = _lane_bytes(t, st.acc)                           # t_max and pending
    weighted = hit & st.prev_random
    n_bytes = (n * _lane_bytes(st.active, prim)
               + count(dead) * (flags + idle_row)
               + count(escaped) * (2 * _lane_bytes(st.acc, st.bounce)
                                   + _lane_bytes(st.active) + flags + idle_row)
               + count(hit) * (_lane_bytes(st.bounce, t, st.d, st.acc, hr.normal, hr.position,
                                           st.throughput, st.ior, hr.backside, hr.mat,
                                           st.geom_len, st.opt_len, st.prev_random)
                               + _lane_bytes(st.acc, st.bounce, st.o, st.opt_len, st.geom_len,
                                             st.active) + flags)
               + count(weighted) * _lane_bytes(st.prev_pdf, hr.geom_normal if tables.per_light
                                               else st.prev_light_pdf)
               + count(hit & (typ == MaterialType.LAMBERTIAN)) * _lane_bytes(pixel, sample)
               + count(random) * _lane_bytes(st.d, st.throughput, hr.position, t, st.acc)
               + count(hit & ~random) * idle_row)
    rows = [tables.mat, tables.light_tri, tables.light_mat, tables.light_w,
            tables.alias_prob, tables.alias_idx] + ([tables.pick_area] if tables.per_light else [])
    flops = (150.0 * count(hit) + 100.0 * count(random)
             + (0.0 if tables.per_light else 140.0 * tables.n_lights * count(random)))
    return n_bytes + _table_bytes(rows) + 16, flops


def _env_shade_work(inputs: K4Inputs):
    """(bytes, flops) of the env shade in place on `inputs`, by branch.
    Every lane reads its active flag and primitive id (side by side). A
    dead lane writes its previous sample's pdf and flag, with importance
    tables its idle shadow row. An escaped lane reads its bounce
    index, direction, throughput, deposits and optical path length, with
    importance tables the previous sample's flag (and the pdf where it is
    set: the sky's MIS weight); it writes its deposits, bounce index, end,
    previous sample's pdf and flag (and its idle row). A hit lane reads its
    bounce index, t, direction, deposits, normal, position, throughput, ray
    IOR, backside, material, path lengths, pixel and sample id (the tangent
    on a GGX hit) and writes its deposits, bounce index, origin, path
    lengths, end, pdf and flag, where it scatters its direction and
    throughput, on a glass hit its ray IOR, and with importance tables its
    shadow ray (direction, t_max, pending deposit) on a RANDOM lane, else
    its idle row. No lane writes the mixture pdf. The material rows and the
    sky once. Flops: ~170 per hit lane (emission, two uniforms, the
    roulette), the sample per hit lane and type (`LIT_SAMPLE_FLOPS`), per
    escaped lane the sky's lookup (and pdf), per RANDOM lane with
    importance tables ~160 (the sky's sample, its lookup, the weight) and a
    bsdf evaluation of its type (`LIT_EVAL_FLOPS`)."""
    tables, _, _, st, pixel, sample, t, prim, hr = inputs.shade
    env = tables.env
    imp = env.importance
    n = st.active.shape[0]
    dead, escaped, hit, random, cont, typ = _shade_lanes(inputs)
    count = lambda m: int(m.sum())  # noqa: E731
    flags = _lane_bytes(st.prev_pdf, st.prev_random)
    idle_row = _lane_bytes(t, st.acc) if imp else 0            # t_max and pending
    n_bytes = (n * _lane_bytes(st.active, prim)
               + count(dead) * (flags + idle_row)
               + count(escaped) * (_lane_bytes(st.bounce, st.d, st.throughput, st.acc, st.opt_len)
                                   + _lane_bytes(st.acc, st.bounce, st.active) + flags + idle_row)
               + count(hit) * (_lane_bytes(st.bounce, t, st.d, st.acc, hr.normal, hr.position,
                                           st.throughput, st.ior, hr.backside, hr.mat,
                                           st.geom_len, st.opt_len, pixel, sample)
                               + _lane_bytes(st.acc, st.bounce, st.o, st.opt_len, st.geom_len,
                                             st.active) + flags)
               + count(hit & (typ == MaterialType.GGX)) * _lane_bytes(hr.tangent)
               + count(cont) * _lane_bytes(st.d, st.throughput)
               + count(hit & (typ == MaterialType.GLASS)) * _lane_bytes(st.ior))
    if imp:
        n_bytes += (count(escaped) * _lane_bytes(st.prev_random)
                    + count(escaped & st.prev_random) * _lane_bytes(st.prev_pdf)
                    + count(random) * _lane_bytes(hr.position, t, st.acc)
                    + count(hit & ~random) * idle_row)
    rows = [tables.mat] + ([env.const_radiance] if env.kind == 3 else [env.image, env.rotation])
    if imp:
        rows += [env.pdf_table, env.alias_prob, env.alias_idx]
    flops = (170.0 * count(hit)
             + (SKY_LOOKUP_FLOPS[env.kind] + (SKY_PDF_FLOPS if imp else 0.0)) * count(escaped))
    for mt, f in LIT_SAMPLE_FLOPS.items():
        flops += f * count(hit & (typ == mt))
    if imp:
        flops += 160.0 * count(random)
        for mt, f in LIT_EVAL_FLOPS.items():
            flops += f * count(random & (typ == mt))
    return n_bytes + _table_bytes(rows) + 16, flops


# Float operations of the lit shade: per hit lane of each material type
# (the sample: Lambertian's cosine, GGX's VNDF sample and evaluation,
# mirror, glass's Fresnel term and refraction, ModPhong's lobe pick and
# mixture, RGL's two warps and reflectance), and per RANDOM lane of each
# type of one bsdf evaluation (two per lane: toward the light and the sky).
LIT_SAMPLE_FLOPS = {1: 60.0, 2: 350.0, 3: 100.0, 4: 10.0, 5: 150.0, 10: 900.0}
LIT_EVAL_FLOPS = {1: 10.0, 2: 100.0, 5: 50.0, 10: 450.0}


def _shade_lanes(inputs: K4Inputs):
    """(dead, escaped, hit, RANDOM, scattering, material type) lanes of a
    shade's inputs: the plain version's bsdf sample of every hit lane."""
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
    typ = _hit_types(tables, hr, prim)
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
    dead, escaped, hit, random, cont, typ = _shade_lanes(inputs)
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
    typ = _hit_types(tables, hr, prim)
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
    """K1: per lane t_min and t_max in (8 B) and the hit out (16 B), o and d
    (24 B) on live lanes (t_max > t_min; a dead lane reads no more); 40
    flops per live ray and triangle (four linear functionals of the ray and
    the division-free predicates), 20 per live ray and sphere; the primitive
    rows read once. The flops count a multiply and an add as two: built
    with -fmad=false, K1 issues them unfused, at half the FMA peak that
    bound_ms divides by."""
    _, _, t_min, t_max = rays
    n, n_live = t_max.shape[0], int((t_max > t_min).sum())
    return (n * (8 + 16) + n_live * 24 + _table_bytes(bs),
            n_live * (40 * bs.n_tris + 20 * bs.n_spheres))


def any_hit_work(bs, rays):
    """K2: as K1 with a bool out, and each live lane tests primitives only up
    to its first blocker (counted on these rays); a dead lane tests none."""
    _, _, t_min, t_max = rays
    live = t_max > t_min
    blocked = candidate_t(bs, *rays) < BIG
    first = torch.where(blocked.any(1), blocked.to(torch.int8).argmax(1) + 1, blocked.shape[1])
    n = t_max.shape[0]
    return (n * (8 + 1) + int(live.sum()) * 24 + _table_bytes(bs),
            40 * float(torch.where(live, first, 0).sum()))


# Bytes per lane of each field of a hit record; float operations per
# assembled lane: the position, normal, geometric normal and the flip
# (K3_FLOPS), the tangent, the uv; K3a's object-space ray and each vector
# brought back to world (normal, geometric normal, tangent) with its
# normalization.
HIT_FIELD_BYTES = {"position": 12, "normal": 12, "geom_normal": 12, "tangent": 12, "uv": 8,
                   "mat": 4, "backside": 1}
K3_FLOPS, K3_TAN_FLOPS, K3_UV_FLOPS = 60.0, 40.0, 20.0
K3A_RAY_FLOPS, K3A_VECTOR_FLOPS = 30.0, 22.0


def assemble_hit_work(ht, prim, frames=None, fields=None):
    """K3 on the winners `prim` of one launch (K3a with `frames`): the full
    form (`fields` None: o, d, t, prim, u, v in and every field out on every
    lane) or the K4 form with a field set (prim in on every lane; o, d and t
    in on each hit lane, u and v on triangle winners; the set's fields out
    on hit lanes). The tables count by the rows the winners touch, each
    once, and the words the fields read: a triangle's three normals, its
    geometric normal and material (52 B), its uvs (24 B) with uv, its
    tangents and flags (40 B) with the tangent; a sphere's centre, radius
    and material (20 B); K3a also each touched row's animation id (4 B) and
    each animation row a winner uses (120 B). Flops per assembled lane (every
    lane of the full form, hit lanes of the K4 form): K3_FLOPS, K3_TAN_FLOPS
    with the tangent, K3_UV_FLOPS with uv; K3a K3A_RAY_FLOPS and
    K3A_VECTOR_FLOPS per vector brought back to world."""
    full = fields is None
    fields = tuple(HIT_FIELD_BYTES) if full else tuple(fields)
    n = prim.shape[0]
    hit = prim >= 0
    tri = hit & (prim < ht.n_tris)
    sph = hit & ~tri
    tri_rows, sph_rows = torch.unique(prim[tri]), torch.unique(prim[sph]) - ht.n_tris
    row = 52 + (24 if "uv" in fields else 0) + (40 if "tangent" in fields else 0)
    tables = tri_rows.numel() * row + sph_rows.numel() * 20
    flops = K3_FLOPS + (K3_TAN_FLOPS if "tangent" in fields else 0.0) + (
        K3_UV_FLOPS if "uv" in fields else 0.0)
    if frames is not None:
        tables += 4 * (tri_rows.numel() + sph_rows.numel())
        if frames.dim() == 3:   # per-ray rows: each assembled lane reads its winner's own row
            tables += (n if full else int(hit.sum())) * 4 * frames.shape[-1]
        else:
            ids = torch.unique(torch.cat([ht.tri_anim[tri_rows.long()],
                                          ht.sph_anim[sph_rows.long()]]))
            tables += ids.numel() * 4 * frames.shape[-1]
        flops += K3A_RAY_FLOPS + K3A_VECTOR_FLOPS * (3 if "tangent" in fields else 2)
    out = sum(HIT_FIELD_BYTES[f] for f in fields)
    if full:
        return n * (40 + out) + tables, n * flops
    n_hit, n_tri = int(hit.sum()), int(tri.sum())
    return n * 4 + n_hit * (28 + out) + n_tri * 8 + tables, n_hit * flops


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
    once; per-ray rows (motion blur): each live lane's r_inv and t_inv (48
    B) once per run of one animation along its walk. Per live lane
    SWEEP_TRI_FLOPS per triangle and SWEEP_SPHERE_FLOPS per sphere tested,
    and OBJECT_RAY_FLOPS per run of one animation along the walk
    (animated). KS2's lanes stop at their first blocker, counted on these
    rays with the plain tests."""
    o, d, t_min, t_max = rays
    n = o.shape[0]
    live = t_max > t_min
    n_live = int(live.sum())
    rows = (0 if frames is None else 48 * _anim_runs(ss) * n_live if frames.dim() == 3
            else _table_bytes([frames]))
    tables = 40 * ss.n_tris + 20 * ss.n_spheres + rows
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


BVH_TRI_FLOPS = 60.0      # the watertight test
SHEAR_FLOPS = 3.0         # an object ray's shear: a reciprocal and two products


def bvh_work(bvh, rays, any_hit: bool, frames=None, counts=None):
    """K5/K6: per lane t_min and t_max in (8 B) and the result out (16 B of t,
    prim, u, v; 1 B of occlusion); o and d in (24 B) only on live lanes
    (t_max > t_min: a dead lane reads no more); the node table, 40 B per
    triangle row (nine vertex floats and the prim id, not the row's pad
    words) and 20 B per sphere row (centre, radius, prim id), 4 B more per
    row for its animation id and the frame rows with `frames`, read once
    (rows visited by many rays stay in cache; per-ray rows, r_inv and t_inv,
    48 B, for each object ray a lane computes). Charged per branch: two slab
    tests (48 flops) for each inner-node visit of the walk, BVH_TRI_FLOPS for
    each leaf triangle test, SWEEP_SPHERE_FLOPS for each leaf sphere test,
    and with `frames` OBJECT_RAY_FLOPS + SHEAR_FLOPS for each object ray a
    lane computes (one per animation other than the identity whose rows its
    walk tests), counted with the plain walk on these rays (`counts`: its
    bvh_walk_counts, when already taken)."""
    c = counts if counts is not None else bvh_walk_counts(bvh, *rays, any_hit=any_hit,
                                                          frames=frames)
    n = rays[0].shape[0]
    live = int((rays[3] > rays[2]).sum())
    per_row = 4 if frames is not None else 0
    rows = (0 if frames is None else 48 * c["object_rays"] if frames.dim() == 3
            else _table_bytes([frames]))
    tables = (_table_bytes([bvh.nodes]) + (40 + per_row) * bvh.n_tris
              + (20 + per_row) * bvh.n_spheres + rows)
    n_bytes = live * 24 + n * 8 + (n if any_hit else n * 16) + tables
    return n_bytes, (48.0 * c["nodes"] + BVH_TRI_FLOPS * c["tri_tests"]
                     + SWEEP_SPHERE_FLOPS * c["sphere_tests"]
                     + (OBJECT_RAY_FLOPS + SHEAR_FLOPS) * c["object_rays"])


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
    16 B out per lane, no arithmetic. Its masked form: `env_lanes_work`."""
    if env.kind == 3:
        return n * 16 + env.const_radiance.numel() * 4, 0.0
    return n * (12 + 16) + _table_bytes(env[1:]), n * 60.0


def env_lanes_work(env, n: int, sample: bool, pdf: bool, rad: bool, live: Optional[int] = None):
    """K8's kernel (env_lanes_kernel) over n lanes, `live` of them in its
    mask (every lane, without one): every lane's mask byte read (with one)
    and its outputs written (a sample's 12 B direction, 4 B pdf, 16 B
    radiance, each where asked for); only the live lanes' inputs read (12 B
    of direction or uniforms; none for a constant sky's radiance alone),
    the tables the outputs need read once (the image or the constant
    radiance, the pdf table, the alias tables) and ~60 flops a live lane
    and output (a lookup, a pdf, a sample)."""
    masked = live is not None
    live = n if live is None else live
    out = n * ((12 if sample else 0) + (4 if pdf else 0) + (16 if rad else 0))
    reads_x = sample or pdf or env.kind != 3
    tables = 0
    if live:
        if rad:
            tables += (env.const_radiance if env.kind == 3 else env.image).numel() * 4
        if sample or pdf:
            tables += env.pdf_table.numel() * 4
        if sample:
            tables += (env.alias_prob.numel() + env.alias_idx.numel()) * 4
    ops = int(sample) + int(pdf) + int(rad and env.kind != 3)
    return ((n if masked else 0) + out + (live * 12 if reads_x else 0) + tables,
            live * 60.0 * ops)


def rgl_work(tables, n: int, sample: bool, live: Optional[int] = None):
    """K7 over n lanes of which `live` (default n) carry an RGL material:
    every lane's id read and its f*cos and pdf written (and wo, ok for
    sample); wi with wo (eval) or u2 (sample) read, the tables read once and
    the arithmetic only for the live lanes. About 450 flops per live lane
    for eval (two parameter searches, the vndf inversion, 16 rgb, 8
    ndf/sigma and 8 luminance corner fetches) and 900 for sample (two full
    warps with their marginal and conditional row searches)."""
    live = n if live is None else live
    t_bytes = _table_bytes(tables) if live else 0
    if sample:
        return n * (4 + 12 + 16 + 4 + 1) + live * (12 + 8) + t_bytes, live * 900.0
    return n * (4 + 16 + 4) + live * (12 + 12) + t_bytes, live * 450.0


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


SPIN_HZ = 2e9   # cycles a second of torch.cuda._sleep's spin, at most (the SM clock)


def device_ms(fn: Callable[[], object], n: int = 20, warmup: int = 3) -> float:
    """Device time of one call of `fn` on the GPU, by CUDA events around `n`
    calls after `warmup`, queued behind a spin kernel (torch.cuda._sleep)
    that keeps the card busy for four times as long as the host took to
    enqueue `n` calls: the host's time per call (a wrapper's checks and
    ctypes call) is left out, the card's gaps between kernels are in."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4 * max(host_s, 1e-3) * SPIN_HZ))
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


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
