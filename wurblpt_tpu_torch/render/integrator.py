"""Wavefront path integrator (port of ``wurblpt_tpu/render/integrator.py``:
the persistent-lane `render_frame_wavefront` and its bounce step).

Per bounce, as the reference's tracePath (wurblpt.hpp:108-275):
  1. closest hit (K1 or the sweep KS1 brute force, or K5 on a BVH);
  2. on a miss, the environment map's radiance (K8) with its MIS weight
     against the env importance pdf (K8);
  3. hit assembly (K3), the material row (P0), emitted radiance with its MIS
     weight against the light-mixture pdf, or in scenes with many lights
     against the hit light's own pdf (`lights_pdf_at_hit`, P0);
  4. BSDF sample (RGL lanes through K7);
  5. NEE toward a picked hot spot, visibility by an any-hit cast (K2, KS2 or K6)
     shortened by `shadow_identity_eps`, power-heuristic weighted against
     the mixture pdf or, per light, against pick probability x the picked
     light's pdf;
  6. env NEE: an importance-sampled sky direction (K8), visibility by an
     any-hit cast to BIG, power-heuristic weighted;
  7. throughput update and Russian roulette.

Two routes take a step, chosen once per render from the scene and the
camera (`wavefront.diffuse_class`, `wavefront.env_class`,
`wavefront.lit_class`):

* K4 (:mod:`.wavefront`), for three classes of scenes: the diffuse class
  (Lambertian surfaces, triangle lights, no sky, static or animated; the
  cornell, tof_amcw and cornell_animated paths), the env class
  (Lambertian, GGX, mirror and glass surfaces, triangles and analytic
  spheres, under an equirect, cube or constant sky, no light, brute force
  or a BVH; the bvh_100k, envmap_cube_is and rtiow_distortion paths),
  both seen by a mono pinhole camera with or without a lens model, and
  the lit class (those surfaces, ModPhong and
  RGL, triangle lights under per-light MIS beside an importance-sampled
  sky; the city_many_lights path), seen by a pinhole or a surround camera,
  mono or stereo. A step is the regeneration (which first adds the step
  before's NEE deposits and flags the loop condition), the scene's
  closest-hit cast (K1, KS1 or K5), K3's K4 form (K3a's animated: the
  fields the class's shade reads, on hit lanes only), the class's shade
  (`shade_diffuse`, `shade_env`, `shade_lit`) and the scene's any-hit cast
  (K2, KS2 or K6) on its shadow rays (the lit class's light and sky shadow
  rays in one cast): 5 launches, 4 without shadow rays, and one more
  regeneration that ends the block;
* every other scene runs the regeneration and the generic bounce above as
  PyTorch ops (~1000-1700 launches), with the hand-written casts, K3, K7,
  K8 and P0 inside; it shares its emission, NEE, sky and roulette pieces
  with K4's plain versions.

An animated scene (rigid keyframes, at one instant t0 = t1) is cast by the
sweeps KS1/KS2, or through its BVH by K5/K6 (the boxes swept over the build
interval), in each primitive's object space and assembled by K3a, with
the frame's animation rows built once (`frame_anim`); a moving light is
placed at that instant for NEE (on K4, in the frame's step tables:
`wavefront.step_tables_at`).

The brute-force cast follows the JAX package (`prepare_scene`): K1/K2 for
a static scene without a BVH within the matrix form's 8192 columns
(`intersect_brute.brute_eligible`), the sweeps for every other scene
without a BVH; a scene with a BVH (triangles and spheres, static or
animated) is cast by K5/K6.

A scene's tables (the brute-force scene or the BVH, the hit tables, the
packed material rows, the per-light rows and K4's step tables) are built
once per scene by `prepare_scene`; a frame rendered with them launches
only its lane state and its steps.

Randomness is counter-based on (pixel, sample, bounce, salt), so the port
draws the JAX package's random numbers. The JAX `while_loop` condition
becomes a Python loop with one host sync per step: on K4 the regeneration
evaluates it at the start of the step, after adding the step before's NEE
deposits, so the block stops without casting once no lane has work; the
generic route evaluates it with torch ops after its bounce. Replacing that
sync with a CUDA graph of several steps is a later item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..core.rng import Salt, uniform4
from ..scene.animation import anim_frames
from ..scene.ir import SceneArrays
from .bsdf import ScatterKind, SceneStatic, bsdf_sample, gather_material_rows, pack_material_table
from .camera import CameraConfig, CameraParams, check_camera
from .intersect import (
    HitTables,
    assemble_hit,
    assemble_hit_k4,
    build_hit_tables,
    hit_buffers,
    scene_any_hit,
    scene_raw_hit,
)
from .intersect_brute import BIG, brute_eligible, build_brute_scene
from .intersect_sweep import build_sweep_scene
from .lights import light_frames, pick_area_table
from .wavefront import (
    LoopState,
    StepTables,
    advance,
    block_lanes,
    build_step_tables,
    deposit_unoccluded,
    diffuse_class,
    diffuse_scene,
    emit,
    env_class,
    env_miss,
    env_nee,
    env_scene,
    k4_route,
    light_nee,
    lit_class,
    lit_scene,
    path_lengths,
    regen_plain,
    step_tables_at,
)


@dataclass(frozen=True)
class RenderParams:
    """Reference `Parameters` (wurblpt.hpp:79-96), the fields the slice reads."""

    max_path_components: int = 32
    rr_threshold: float = 1.0
    rr_start: int = 5
    min_hit_distance: float = 1e-4
    randomize_ray_over_pixel: bool = True
    # The NEE shadow ray is shortened to ldist * (1 - shadow_identity_eps) so
    # the sampled light never counts as its own blocker (the reference
    # compares blocker identity instead, wurblpt.hpp:203-217).
    shadow_identity_eps: float = 3e-4


class SceneTables(NamedTuple):
    """A scene's loop-invariant tables, built once by `prepare_scene` and read
    by every frame rendered of the scene."""

    accel: object                      # the BVH's arrays, the K1 form's or the sweeps' scene
    hit: HitTables
    mat: torch.Tensor                  # [M, 23] packed material rows
    pick_area: Optional[torch.Tensor]  # [P, 2] per-light MIS rows (None: mixture or no light)
    step: Optional[StepTables]         # K4's tables (None: a scene outside K4's classes)


def prepare_scene(scene: SceneArrays, static: SceneStatic) -> SceneTables:
    """The tables every frame of `scene` reads: build them once and pass them
    to each `render_frame_wavefront` of the scene."""
    mat = pack_material_table(scene.materials)
    per_light = static.n_lights > 0 and static.per_light_mis
    pick_area = pick_area_table(scene) if per_light else None
    if scene.has_bvh:
        accel = scene.bvh
    else:
        accel = build_brute_scene(scene) if brute_eligible(scene) else build_sweep_scene(scene)
    return SceneTables(
        accel=accel,
        hit=build_hit_tables(scene), mat=mat, pick_area=pick_area,
        step=(build_step_tables(scene, static, mat, pick_area)
              if (diffuse_scene(scene, static) or env_scene(scene, static)
                  or lit_scene(scene, static)) else None))


class FrameAnim(NamedTuple):
    """An animated scene's state at the frame's instant: every animation's
    rows for the casts and the hit assembly, and the hot spots' forward
    frames, taken from those rows, where a light moves (None otherwise)."""

    frames: torch.Tensor              # [A, 30] scene/animation.anim_frames
    lights: Optional[tuple]           # lights.light_frames, or None


def frame_anim(scene: SceneArrays, static: SceneStatic, t0: float) -> Optional[FrameAnim]:
    """The animations at t0, evaluated once per frame (None: a static scene);
    the light frames only when a hot spot moves (integrator.py:856-861)."""
    if not static.has_anim:
        return None
    frames = anim_frames(scene.anims, t0)
    return FrameAnim(frames, light_frames(scene, frames) if static.lights_animated else None)


def _make_bounce_fn(scene: SceneArrays, static: SceneStatic, tables: SceneTables, sensor,
                    params: RenderParams, n, anim: Optional[FrameAnim] = None):
    """One generic torch-op wavefront bounce as a function of (state, pixel, sample)."""
    accel, ht, mat_packed, pick_area = tables.accel, tables.hit, tables.mat, tables.pick_area
    frames = None if anim is None else anim.frames
    lframes = None if anim is None else anim.lights
    mat_types = static.mat_types
    rgl = scene.rgl
    has_lights = static.n_lights > 0
    per_light = pick_area is not None
    has_env = static.env_kind != 0
    env_is = has_env and static.env_importance
    env = scene.envmap
    dev = scene.device
    t_min = torch.full((n,), params.min_hit_distance, dtype=torch.float32, device=dev)

    def body(st: LoopState, pixel_id, sample_id) -> LoopState:
        k = st.bounce
        acc = st.acc
        t, prim, u, v = scene_raw_hit(accel, st.o, st.d, t_min,
                                      torch.where(st.active, BIG, 0.0), frames)
        hit = (prim >= 0) & st.active

        # Environment on a miss, MIS-weighted against env NEE.
        if has_env:
            acc = env_miss(sensor, acc, st, env, prim, env_is)

        hr = assemble_hit(ht, st.o, st.d, t, prim, u, v, frames)
        mrow = gather_material_rows(mat_packed, hr.mat)
        geom_len, opt_len = path_lengths(st, hit, t)
        acc = emit(sensor, acc, st, hr, mrow, t, prim, hit, geom_len, opt_len,
                   static.n_lights, pick_area)

        u4 = uniform4(pixel_id, sample_id, k, Salt.BSDF)
        u_aux = uniform4(pixel_id, sample_id, k, Salt.BSDF_AUX)
        sr = bsdf_sample(hr, st.d, st.ior, u4, u_aux[:, 0], u_aux[:, 1], mrow, mat_types,
                         rgl=rgl)
        is_random = hit & (sr.kind == ScatterKind.RANDOM) & (sr.pdf > 0.0)
        is_explicit = hit & (sr.kind == ScatterKind.EXPLICIT)

        light_pdf_next = None
        if has_lights:
            u3 = uniform4(pixel_id, sample_id, k, Salt.NEE_SAMPLE)[:, :3]
            ldir, t_shadow, pending, light_pdf_next = light_nee(
                scene, sensor, params, st, hr, mrow, mat_types, rgl, sr.direction, is_random,
                geom_len, opt_len, u3, mat_packed, per_light, lframes)
            occluded = scene_any_hit(accel, hr.position, ldir, t_min, t_shadow, frames)
            acc = deposit_unoccluded(acc, pending, occluded)

        # Env NEE: shadow ray to BIG, unoccluded lanes see the sky's radiance
        # in the sampled direction.
        if env_is:
            ue = uniform4(pixel_id, sample_id, k, Salt.ENVMAP_SAMPLE)[:, :3].contiguous()
            edir, t_env, pending_e = env_nee(sensor, env, st, hr, mrow, mat_types, rgl, ue,
                                             is_random, geom_len, opt_len)
            occluded_e = scene_any_hit(accel, hr.position, edir, t_min, t_env, frames)
            acc = deposit_unoccluded(acc, pending_e, occluded_e)

        new = advance(params, st, hit, hr, sr, is_random, is_explicit, u_aux[:, 2], acc,
                      geom_len, opt_len, light_pdf_next)
        # Ray counters: one closest cast per active lane, one shadow cast per
        # RANDOM lane and NEE kind (bench.py's Mrays/s accounting).
        n_closest = st.active.sum()
        n_all = n_closest + (int(has_lights) + int(env_is)) * is_random.sum()
        return new._replace(stats=st.stats + torch.stack([n_closest, n_all]))

    return body


def _make_generic_step(scene, static, tables, sensor, params, cam, cam_cfg, L, anim=None):
    """The torch-op step: regeneration, then the generic bounce; the loop
    condition as torch ops and one host sync."""
    bounce_fn = _make_bounce_fn(scene, static, tables, sensor, params, L, anim)

    def step(ls, sample, k_next, lanes, carry):
        ls, sample, k_next, _, _ = regen_plain(ls, sample, k_next, cam, cam_cfg, lanes,
                                               params.randomize_ray_over_pixel)
        ls = bounce_fn(ls, lanes.pixel, sample)
        work = ls.active.any() | ((k_next < lanes.P) & lanes.valid).any()
        return ls, sample, k_next, None, bool(work.item())

    return step


def _make_k4_step(scene, static, tables, sensor, params, cam, cam_cfg, L, anim=None):
    """The step through K4 (`wavefront.k4_route`): the regeneration
    (wpt_regen_pinhole or wpt_regen_surround), which first adds the pending
    deposits of the step before where their shadow rays are not occluded
    (`carry`; None on a block's first step) and evaluates the loop
    condition, which one host sync reads: without work the block is done,
    its acc holding every deposit; else the scene's closest-hit cast (K1,
    KS1 or K5), K3's K4 form (K3a's with `anim`: the class's fields on hit
    lanes only, into buffers allocated once per frame, which every step of
    every block reuses: no reader looks at a miss lane's record), the
    class's shade (wpt_shade_diffuse, wpt_shade_env or wpt_shade_lit) and
    the scene's any-hit cast (K2, KS2 or K6) on its shadow rays, whose
    pending deposits and occlusion are the carry of the next step. A scene that casts no shadow ray (no light, a
    sky without importance tables) skips the any-hit cast and carries
    nothing; the lit class casts its light and sky shadow rays (2 L, from
    the origins its shade writes) in one any-hit cast. An animated frame
    (`anim`) casts and assembles with its animation rows and shades with
    its step tables (`wavefront.step_tables_at`)."""
    accel, ht = tables.accel, tables.hit
    frames = None if anim is None else anim.frames
    step_tables = step_tables_at(tables.step, None if anim is None else anim.lights)
    route = k4_route(step_tables, cam_cfg)
    t_min = torch.full((route.shadow_rows * L,), params.min_hit_distance, dtype=torch.float32,
                       device=scene.device)
    hit_out = hit_buffers(route.hit_fields, L, scene.device)

    def step(ls, sample, k_next, lanes, carry):
        ls, sample, k_next, t_max, work = route.regen(
            ls, sample, k_next, cam, cam_cfg, lanes, params.randomize_ray_over_pixel,
            *(carry or (None, None)))
        if not bool(work.item()):
            return ls, sample, k_next, None, False
        t, prim, u, v = scene_raw_hit(accel, ls.o, ls.d, t_min[:L], t_max, frames)
        hr = assemble_hit_k4(ht, ls.o, ls.d, t, prim, u, v, frames, hit_out)
        ls, shadow_o, shadow_d, shadow_tmax, pending = route.shade(
            step_tables, sensor, params, ls, lanes.pixel, sample, t, prim, hr)
        if shadow_tmax is None:
            return ls, sample, k_next, None, True
        occluded = scene_any_hit(accel, shadow_o, shadow_d, t_min, shadow_tmax, frames)
        return ls, sample, k_next, (pending, occluded), True

    return step


def _make_run_block(step, sensor, width, height, samples_sqrt, B, m, P, n_pix, device):
    """One persistent-lane block render: (blk, img_acc, stats) -> (img_acc, stats)."""
    L = B * m
    f32 = dict(dtype=torch.float32, device=device)

    def run_block(blk, img_acc, stats):
        lanes = block_lanes(blk, B, m, P, width, height, samples_sqrt, device)
        ls = LoopState(
            bounce=torch.zeros((L,), dtype=torch.int64, device=device),
            o=torch.zeros((L, 3), **f32),
            d=torch.tensor([0.0, 0.0, 1.0], **f32).expand(L, 3).contiguous(),
            ior=torch.ones((L, 4), **f32),
            throughput=torch.zeros((L, 4), **f32),
            active=torch.zeros((L,), dtype=torch.bool, device=device),
            acc=torch.zeros((L, sensor.n_acc), **f32),
            geom_len=torch.zeros((L,), **f32),
            opt_len=torch.zeros((L, 4), **f32),
            prev_pdf=torch.zeros((L,), **f32),
            prev_random=torch.zeros((L,), dtype=torch.bool, device=device),
            prev_light_pdf=torch.zeros((L,), **f32),
            stats=torch.zeros((2,), dtype=torch.int64, device=device),
        )
        sample = torch.zeros((L,), dtype=torch.int64, device=device)
        k_next = torch.zeros((L,), dtype=torch.int64, device=device)
        # The while_loop of the JAX package; every block has a pixel to start.
        # `carry`: what a step hands the next (K4: its pending NEE deposits
        # and their occlusion).
        work, carry = True, None
        while work:
            ls, sample, k_next, carry, work = step(ls, sample, k_next, lanes, carry)

        block_img = ls.acc.reshape(m, B, sensor.n_acc).sum(0)
        img_acc[blk * B:(blk + 1) * B] = block_img
        return img_acc, stats + ls.stats

    return run_block


def render_frame_wavefront(
    scene: SceneArrays,
    static: SceneStatic,
    cam: CameraParams,
    cam_cfg: CameraConfig,
    sensor,
    width: int,
    height: int,
    samples_sqrt: int,
    params: RenderParams = RenderParams(),
    max_lanes: int = 131072,
    return_stats: bool = False,
    *,
    device,
    tables: Optional[SceneTables] = None,
    t0: float = 0.0,
    t1: float = 0.0,
):
    """Render a frame with persistent lanes: each lane owns one pixel and a
    fixed subset of its samples, and starts the pixel's next sample the moment
    a path dies. Blocks of B pixels x m sample-lanes (B * m <= max_lanes) run
    one after another.

    `scene` and `cam` must live on `device`; `tables` are the scene's own
    (`prepare_scene`), built here when not given. An animated scene is
    rendered at the one instant t0 = t1 (the shutter interval [t0, t1]: the
    JAX package hands t0 != t1 to its pass renderer, which the port has not
    yet). Returns the image [H, W, n_acc] (row 0 at the top); with
    `return_stats` also the [2] int64 cast counters (closest-hit casts, all
    casts incl. NEE shadow rays)."""
    device = torch.device(device)
    static.check_slice()
    check_camera(cam_cfg)
    if static.has_anim and t0 != t1:
        raise NotImplementedError("motion blur: an animated scene over a shutter interval "
                                  "t0 != t1 takes the pass renderer (ROADMAP A.3), not ported yet")
    for name, x in (("scene", scene.tris.p0), ("camera", cam.focal_px)):
        if x.device.type != device.type:
            raise ValueError(f"{name} is on {x.device}, render device is {device}")

    spp = samples_sqrt * samples_sqrt
    n_pix = width * height
    if n_pix >= max_lanes:
        B, m = max_lanes, 1
    else:
        B = n_pix
        m = next(c for c in range(min(spp, max(max_lanes // n_pix, 1)), 0, -1) if spp % c == 0)
    L = B * m
    P = spp // m
    n_blocks = -(-n_pix // B)

    if tables is None:
        tables = prepare_scene(scene, static)
    k4 = (diffuse_class(scene, static, cam_cfg) or env_class(scene, static, cam_cfg)
          or lit_class(scene, static, cam_cfg))
    make_step = _make_k4_step if k4 else _make_generic_step
    step = make_step(scene, static, tables, sensor, params, cam, cam_cfg, L,
                     frame_anim(scene, static, t0))
    run_block = _make_run_block(step, sensor, width, height, samples_sqrt, B, m, P, n_pix,
                                device)
    img = torch.zeros((n_blocks * B, sensor.n_acc), dtype=torch.float32, device=device)
    stats = torch.zeros((2,), dtype=torch.int64, device=device)
    for blk in range(n_blocks):
        img, stats = run_block(blk, img, stats)
    img = sensor.finish(img[:n_pix], 1.0 / spp).reshape(height, width, sensor.n_acc)
    if return_stats:
        return img, stats
    return img
