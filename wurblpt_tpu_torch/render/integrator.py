"""Path integrators (port of ``wurblpt_tpu/render/integrator.py``): the
persistent-lane `render_frame_wavefront` and its bounce step, and the pass
renderer (`render_frame`, `render_frame_progressive`, `accumulate_passes`,
`trace_paths`), which is also the differentiable one.

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
* every other scene (a textured one among them) runs the regeneration and
  the generic bounce above as PyTorch ops (~1000-1700 launches), with the
  hand-written casts, K3, K7, K8 and P0 inside; it shares its emission,
  NEE, sky and roulette pieces with K4's plain versions. A textured scene's
  bounce gathers its texture ids (P0), perturbs the shading frame by the
  normal map and folds the textured colours into the material rows once
  (`render.texture`).

An animated scene (rigid keyframes) is cast by the sweeps KS1/KS2, or
through its BVH by K5/K6 (the boxes swept over the build interval), in
each primitive's object space and assembled by K3a. At one instant (t0 =
t1) the frame's animation rows are built once (`frame_anim`) and a moving
light is placed at that instant for NEE (on K4, in the frame's step
tables: `wavefront.step_tables_at`). Over a shutter interval t0 != t1
(motion blur) each ray has its own time, drawn by Salt.TIME, and keeps it
along its path: the pass renderer builds every animation's rows at each
ray's time once per trace (`frame_anim` of the rays' times, [N, A, 30]), and the
casts, K3a and NEE read each lane's own rows; `render_frame_wavefront`
hands such a frame to `render_frame`, as the JAX package does. The camera
takes a thin lens (depth of field) and an animated pose; K4's pinhole
regeneration takes the lens, and an animated camera at one instant is
posed once on the host (`camera.static_pose`).

The brute-force cast follows the JAX package (`prepare_scene`): K1/K2 for
a static scene without a BVH within the matrix form's 8192 columns
(`intersect_brute.brute_eligible`), the sweeps for every other scene
without a BVH; a scene with a BVH (triangles and spheres, static or
animated) is cast by K5/K6.

A scene's tables (the brute-force scene or the BVH, the hit tables, the
packed material rows, the per-light rows and K4's step tables) are built
once per scene by `prepare_scene`; a frame rendered with them launches
only its lane state and its steps.

The pass renderer traces a pass's samples of every pixel to completion on
the generic bounce: the same paths as the wavefront (the RNG is keyed on
pixel and sample, not lane). With `RenderParams.differentiable` its loop
runs `max_path_components` bounces, each under `torch.utils.checkpoint`,
and the image is on the autograd tape with the JAX package's attached
estimator (pdfs and MIS weights on the tape; the light pick, the lobe pick
and the roulette detached): the casts give no derivative, K3's backward
(K3T) differentiates the winner's hit equation, and P0's and K8's backwards
(P0T, K8T) carry the material rows' and the sky's cotangents
(:mod:`.backward`).

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

from ..core.rng import Salt, uniform1, uniform2, uniform4
from ..scene.animation import anim_frames, anim_frames_per_ray
from ..scene.ir import SceneArrays
from .bsdf import (
    ScatterKind,
    SceneStatic,
    apply_normal_map,
    bsdf_sample,
    gather_material_rows,
    pack_material_table,
)
from .camera import CameraConfig, CameraParams, _recip, camera_rays, check_camera, static_pose
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
from .media import apply_media
from .texture import TexCtx, apply_textures
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
    """Reference `Parameters` (wurblpt.hpp:79-96), the fields the slice reads.

    `differentiable` (integrator.py:69-92): the pass renderer's bounce loop
    runs exactly `max_path_components` trips, each under
    `torch.utils.checkpoint` (recomputed in the backward pass, so the tape
    holds one bounce at a time), instead of stopping once every path has
    died; inference keeps the early exit."""

    max_path_components: int = 32
    rr_threshold: float = 1.0
    rr_start: int = 5
    min_hit_distance: float = 1e-4
    randomize_ray_over_pixel: bool = True
    differentiable: bool = False
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
    tex: Optional[TexCtx] = None       # the texture ids' rows and the table (None: untextured)


@torch.no_grad()
def prepare_scene(scene: SceneArrays, static: SceneStatic, step: bool = True) -> SceneTables:
    """The tables every frame of `scene` reads: build them once and pass them
    to each `render_frame_wavefront` or `render_frame` of the scene; `step`:
    K4's step tables too (the pass renderer reads none).

    They carry no gradient: the casts' tables (the BVH, the K1 form's, the
    sweeps'), the per-light pick rows and K4's tables stay fixed, and a
    differentiable render rebuilds the packed material rows and the hit
    tables from the scene's tensors on every call (`live_tables`)."""
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
              if step and (diffuse_scene(scene, static) or env_scene(scene, static)
                           or lit_scene(scene, static)) else None),
        tex=TexCtx.of(scene))


def live_tables(scene: SceneArrays, tables: SceneTables) -> SceneTables:
    """`tables` with the packed material rows and the hit tables rebuilt from
    the scene's tensors, so that a loss's gradient reaches the materials
    and the primitives through them (P0's and K3's backward kernels), and
    the texture table and its descriptor rows the scene's own (a texel's
    gradient is the lookup's gather backward, a descriptor's P0T)."""
    return tables._replace(mat=pack_material_table(scene.materials),
                           hit=build_hit_tables(scene),
                           tex=None if tables.tex is None else TexCtx.of(scene))


class FrameAnim(NamedTuple):
    """An animated scene's state at the frame's instant, or at each ray's
    own instant (motion blur): every animation's rows for the casts and the
    hit assembly, and the hot spots' forward frames, taken from those rows,
    where a light moves (None otherwise)."""

    frames: torch.Tensor              # [A, 30] anim_frames, or [N, A, 30] anim_frames_per_ray
    lights: Optional[tuple]           # lights.light_frames, or None


def frame_anim(scene: SceneArrays, static: SceneStatic, time) -> Optional[FrameAnim]:
    """The animations at one instant `time` (a number: the [A, 30] rows,
    evaluated once per frame) or at each ray's time (a tensor [N]: the
    per-ray rows, N A 120 bytes, evaluated once per trace, since a path
    keeps its time across its bounces, integrator.py:270-279); None for a
    static scene. The light frames only when a hot spot moves
    (integrator.py:856-861)."""
    if not static.has_anim:
        return None
    frames = (anim_frames_per_ray(scene.anims, time) if isinstance(time, torch.Tensor)
              else anim_frames(scene.anims, float(time)))
    return FrameAnim(frames, light_frames(scene, frames, static.sphere_lights)
                     if static.lights_animated else None)


def pass_samples(n_pix: int, spp: int, max_lanes: int) -> int:
    """Samples of every pixel per pass where a frame takes the pass
    renderer in `render_frame_wavefront`'s stead (motion blur): the largest
    divisor of spp whose pass has at most max_lanes rays (at least 1)."""
    return next(c for c in range(min(spp, max(max_lanes // max(n_pix, 1), 1)), 0, -1)
                if spp % c == 0)


def _check_device(device, **tensors):
    """Raise unless each named tensor lives on the render's device."""
    for name, x in tensors.items():
        if x.device.type != device.type:
            raise ValueError(f"{name} is on {x.device}, render device is {device}")


def _make_bounce_fn(scene: SceneArrays, static: SceneStatic, tables: SceneTables, sensor,
                    params: RenderParams, n, anim: Optional[FrameAnim] = None):
    """One generic torch-op wavefront bounce as a function of (state, pixel, sample)."""
    accel, ht, mat_packed, pick_area = tables.accel, tables.hit, tables.mat, tables.pick_area
    tex = tables.tex
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
    has_media = static.has_media

    def cast(o, d, t_max, pixel_id, sample_id, k, salt_ctx):
        """The closest cast, and in a scene with media KM after it
        (integrator.py:374-395): (t, prim, u, v, med_mask, med_mat); a lane
        that scatters in medium m has prim n_tris + n_spheres + m."""
        t, prim, u, v = scene_raw_hit(accel, o, d, t_min, t_max, frames)
        if not has_media:
            return t, prim, u, v, None, None
        return apply_media(scene, o, d, t_min, t, prim, u, v, pixel_id, sample_id, k, salt_ctx)

    def body(st: LoopState, pixel_id, sample_id) -> LoopState:
        k = st.bounce
        acc = st.acc
        t, prim, u, v, med_mask, med_mat = cast(st.o, st.d, torch.where(st.active, BIG, 0.0),
                                                pixel_id, sample_id, k, 0)
        hit = (prim >= 0) & st.active
        # With media the NEE shadow rays are closest casts followed by KM
        # (salt_ctx 1 for the light's, 2 for the sky's; integrator.py:573-582,
        # :657-663): a medium scatter blocks them as a solid blocker would.
        shadow = None if not has_media else (
            lambda o, d, t_max, salt_ctx: cast(o.contiguous(), d.contiguous(), t_max, pixel_id,
                                               sample_id, k, salt_ctx)[:2])

        # Environment on a miss, MIS-weighted against env NEE.
        if has_env:
            acc = env_miss(sensor, acc, st, env, prim, env_is)

        hr = assemble_hit(ht, st.o, st.d, t, prim, u, v, frames)
        t = hr.t   # the winner's distance, on the tape where o, d or the geometry are
        if has_media:
            # A medium scatter takes the phase material, a frame facing the
            # ray and uv 0 (hitable_medium.hpp:94-97; integrator.py:476-490),
            # before the material rows are gathered.
            mm = med_mask[:, None]
            hr = hr._replace(mat=torch.where(med_mask, med_mat, hr.mat),
                             normal=torch.where(mm, -st.d, hr.normal),
                             geom_normal=torch.where(mm, -st.d, hr.geom_normal),
                             backside=hr.backside & ~med_mask,
                             uv=torch.where(mm, 0.0, hr.uv))
        mrow = gather_material_rows(mat_packed, hr.mat, None if tex is None else tex.ids)
        # The normal map perturbs the shading frame before any emission,
        # scatter or evaluation (integrator.py:495); the textured colours
        # are read once, at the hit's uv.
        hr = apply_normal_map(hr, mrow, tex)
        mrow = apply_textures(mrow, tex, hr.uv)
        geom_len, opt_len = path_lengths(st, hit, t)
        acc = emit(sensor, acc, st, hr, mrow, t, prim, hit, geom_len, opt_len,
                   static.n_lights, pick_area, scene if static.sphere_lights else None)

        u4 = uniform4(pixel_id, sample_id, k, Salt.BSDF)
        u_aux = uniform4(pixel_id, sample_id, k, Salt.BSDF_AUX)
        sr = bsdf_sample(hr, st.d, st.ior, u4, u_aux[:, 0], u_aux[:, 1], mrow, mat_types,
                         rgl=rgl)
        is_random = hit & (sr.kind == ScatterKind.RANDOM) & (sr.pdf > 0.0)
        is_explicit = hit & (sr.kind == ScatterKind.EXPLICIT)

        light_pdf_next = None
        if has_lights:
            u3 = uniform4(pixel_id, sample_id, k, Salt.NEE_SAMPLE)[:, :3]
            nee = (scene, sensor, params, st, hr, mrow, mat_types, rgl, sr.direction, is_random,
                   geom_len, opt_len, u3, mat_packed, per_light, lframes, tex)
            if shadow is None:
                ldir, t_shadow, pending, light_pdf_next = light_nee(*nee)
                occluded = scene_any_hit(accel, hr.position, ldir, t_min, t_shadow, frames)
                acc = deposit_unoccluded(acc, pending, occluded)
            else:   # visibility resolved by the closest cast inside light_nee
                _, _, pending, light_pdf_next = light_nee(*nee, shadow=shadow)
                acc = acc + pending

        # Env NEE: shadow ray to BIG, unoccluded lanes see the sky's radiance
        # in the sampled direction.
        if env_is:
            ue = uniform4(pixel_id, sample_id, k, Salt.ENVMAP_SAMPLE)[:, :3].contiguous()
            nee_e = (sensor, env, st, hr, mrow, mat_types, rgl, ue, is_random, geom_len, opt_len)
            if shadow is None:
                edir, t_env, pending_e = env_nee(*nee_e)
                occluded_e = scene_any_hit(accel, hr.position, edir, t_min, t_env, frames)
                acc = deposit_unoccluded(acc, pending_e, occluded_e)
            else:
                acc = acc + env_nee(*nee_e, shadow=shadow)[2]

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
    (`prepare_scene`), built here when not given. An animated scene over a
    shutter interval t0 != t1 (motion blur) is handed to `render_frame`,
    image and counters, as the JAX package does (integrator.py:795-802),
    with passes of `pass_samples` samples; at one instant t0 = t1 an
    animated camera is posed once (`camera.static_pose`). Returns the image
    [H, W, n_acc] (row 0 at the top); with `return_stats` also the [2]
    int64 cast counters (closest-hit casts, all casts incl. NEE shadow
    rays)."""
    device = torch.device(device)
    if params.differentiable:
        raise ValueError("render_frame_wavefront renders for inference only; a differentiable "
                         "render takes render_frame (the JAX package's integrator.py:789-790)")
    static.check_slice()
    check_camera(cam_cfg)
    _check_device(device, scene=scene.tris.p0, camera=cam.focal_px)
    if static.has_anim and t0 != t1:
        return render_frame(scene, static, cam, cam_cfg, sensor, width, height, samples_sqrt,
                            t0, t1, params,
                            pass_samples(width * height, samples_sqrt ** 2, max_lanes),
                            return_stats, device=device, tables=tables)
    cam, cam_cfg = static_pose(cam, cam_cfg, scene.anims, t0)

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


# ---------------------------------------------------------------------------
# The pass renderer (integrator.py:253-336, :1023-1207): a batch of camera
# rays traced to completion per pass, reverse-differentiable
# ---------------------------------------------------------------------------

def trace_paths(scene: SceneArrays, static: SceneStatic, sensor, o, d, time, pixel_id, sample_id,
                params: RenderParams = RenderParams(), return_stats: bool = False, *,
                device="cuda", tables: Optional[SceneTables] = None):
    """Trace one batch of camera rays (o, d [N, 3] on `device`, every lane
    active at bounce 0) to completion; pixel_id and sample_id [N] key the
    random numbers. Returns acc [N, sensor.n_acc] and, with `return_stats`,
    the [2] int64 cast counters (closest-hit casts, all casts incl. NEE
    shadow rays).

    Inference stops once no lane is active (one host sync a bounce);
    `params.differentiable` runs exactly `max_path_components` bounces, each
    under `torch.utils.checkpoint` (its tape recomputed in the backward
    pass), as the JAX package's fori_loop with jax.checkpoint
    (integrator.py:322-331). The scene's fixed tables are built here unless
    `tables` (`prepare_scene`) are given; a differentiable trace rebuilds
    the material rows and the hit tables from the scene (`live_tables`).
    `time` [N] is each ray's instant: an animated scene whose rays share one
    instant is traced with the rows of that instant, else with each ray's
    own (`frame_anim`, built once: a path keeps its time), which a
    differentiable trace keeps on the tape (K3aT carries their cotangents
    to the keyframes)."""
    device = torch.device(device)
    _check_device(device, scene=scene.tris.p0, rays=o)
    static.check_slice()
    if params.differentiable and static.has_media:
        raise NotImplementedError("a differentiable render of a scene with participating media: "
                                  "KM has no backward yet (ROADMAP A.13, media gradients: KMT)")
    n = o.shape[0]
    if tables is None:
        tables = prepare_scene(scene, static, step=False)
    if params.differentiable:
        tables = live_tables(scene, tables)
    anim = None
    if static.has_anim and n:
        one_instant = not bool((time != time[0]).any())
        anim = frame_anim(scene, static, float(time[0]) if one_instant else time)
    bounce_fn = _make_bounce_fn(scene, static, tables, sensor, params, n, anim)
    f32 = dict(dtype=torch.float32, device=device)
    st = LoopState(
        bounce=torch.zeros((n,), dtype=torch.int64, device=device),
        o=o, d=d,
        ior=torch.ones((n, 4), **f32),
        throughput=torch.ones((n, 4), **f32),
        active=torch.ones((n,), dtype=torch.bool, device=device),
        acc=torch.zeros((n, sensor.n_acc), **f32),
        geom_len=torch.zeros((n,), **f32),
        opt_len=torch.zeros((n, 4), **f32),
        prev_pdf=torch.zeros((n,), **f32),
        prev_random=torch.zeros((n,), dtype=torch.bool, device=device),
        prev_light_pdf=torch.zeros((n,), **f32),
        stats=torch.zeros((2,), dtype=torch.int64, device=device),
    )
    for _ in range(params.max_path_components):
        if params.differentiable:
            st = torch.utils.checkpoint.checkpoint(bounce_fn, st, pixel_id, sample_id,
                                                   use_reentrant=False)
        elif bool(st.active.any()):
            st = bounce_fn(st, pixel_id, sample_id)
        else:
            break
    if return_stats:
        return st.acc, st.stats
    return st.acc


def accumulate_passes(scene: SceneArrays, static: SceneStatic, cam: CameraParams,
                      cam_cfg: CameraConfig, sensor, width: int, height: int, samples_sqrt: int,
                      t0: float, t1: float, params: RenderParams, samples_per_pass: int, img_acc,
                      pass_start: int, n_pass: int, sample_offset=0, return_stats: bool = False,
                      *, device="cuda", tables: Optional[SceneTables] = None):
    """Add `n_pass` sample passes, from pass index `pass_start`, to the raw
    sensor accumulator `img_acc` [n_pix, n_acc] (integrator.py:1118-1207).
    A pass traces `samples_per_pass` samples of every pixel as one batch;
    sample s of a pixel is jittered within stratum (s mod ssqrt, s div
    ssqrt) by Salt.PIXEL_JITTER and draws its ray time and lens sample by
    Salt.TIME and Salt.LENS. `sample_offset` (an int or an int tensor)
    shifts every sample id: the differentiable way to draw another sample
    window per optimisation step. The random numbers are counter-based on
    (pixel, sample), so any split of a frame's passes into calls gives the
    same paths. With `return_stats` also the summed [2] cast counters."""
    device = torch.device(device)
    check_camera(cam_cfg)
    _check_device(device, scene=scene.tris.p0, camera=cam.focal_px)
    if tables is None:
        tables = prepare_scene(scene, static, step=False)
    n_pix = width * height
    pid = torch.arange(n_pix, dtype=torch.int64, device=device).repeat(samples_per_pass)
    px = (pid % width).to(torch.float32)
    py = (pid // width).to(torch.float32)
    s_local = torch.arange(samples_per_pass, dtype=torch.int64,
                           device=device).repeat_interleave(n_pix)
    inv = _recip(samples_sqrt)
    stats = torch.zeros((2,), dtype=torch.int64, device=device)
    for p in range(pass_start, pass_start + n_pass):
        s = p * samples_per_pass + s_local + sample_offset
        if params.randomize_ray_over_pixel:
            uj = uniform2(pid, s, 0, Salt.PIXEL_JITTER)
            jx = ((s % samples_sqrt).to(torch.float32) + uj[:, 0]) * inv
            jy = ((s // samples_sqrt).to(torch.float32) + uj[:, 1]) * inv
        else:
            jx = jy = torch.full(px.shape, 0.5, dtype=torch.float32, device=device)
        o, d, time = camera_rays(cam, cam_cfg, torch.stack([px + jx, py + jy], -1), width,
                                 height, t0, t1, uniform1(pid, s, 0, Salt.TIME),
                                 uniform2(pid, s, 0, Salt.LENS), anims=scene.anims)
        acc, st = trace_paths(scene, static, sensor, o, d, time, pid, s, params, True,
                              device=device, tables=tables)
        img_acc = img_acc + acc.reshape(samples_per_pass, n_pix, sensor.n_acc).sum(0)
        stats = stats + st
    if return_stats:
        return img_acc, stats
    return img_acc


def render_frame(scene: SceneArrays, static: SceneStatic, cam: CameraParams,
                 cam_cfg: CameraConfig, sensor, width: int, height: int, samples_sqrt: int,
                 t0: float = 0.0, t1: float = 0.0, params: RenderParams = RenderParams(),
                 samples_per_pass: int = 1, return_stats: bool = False, *, device="cuda",
                 tables: Optional[SceneTables] = None):
    """Render a frame with the pass renderer (the mcpt() equivalent,
    wurblpt.hpp:279-449; integrator.py:1080-1115): samples_sqrt^2
    stratified samples per pixel in passes of `samples_per_pass`, the
    sensor's finish at the end. Returns the image [height, width, n_acc]
    (row 0 at the top), with `return_stats` also the [2] cast counters.
    With `params.differentiable` the image is on the tape: a loss of it
    back-propagates to the scene's material table, its triangles' and
    spheres' geometry and attributes, the sky's image (or constant
    radiance) and the camera (P0's, K3's and K8's backward kernels on the
    card; with an animated scene also K3aT's, to the animations' keyframe
    tables). `scene` and `cam` must live on `device`. Over a shutter
    interval t0 != t1 each ray has its own time (motion blur: an animated
    scene is cast and lit at each ray's instant)."""
    spp = samples_sqrt * samples_sqrt
    if spp % samples_per_pass:
        raise ValueError(f"samples_per_pass {samples_per_pass} must divide spp {spp}")
    n_pass = spp // samples_per_pass
    _check_device(torch.device(device), scene=scene.tris.p0, camera=cam.focal_px)
    img, stats = accumulate_passes(
        scene, static, cam, cam_cfg, sensor, width, height, samples_sqrt, t0, t1, params,
        samples_per_pass, torch.zeros((width * height, sensor.n_acc), dtype=torch.float32,
                                      device=torch.device(device)),
        0, n_pass, return_stats=True, device=device, tables=tables)
    img = sensor.finish(img, 1.0 / spp).reshape(height, width, sensor.n_acc)
    if return_stats:
        return img, stats
    return img


def render_frame_progressive(scene: SceneArrays, static: SceneStatic, cam: CameraParams,
                             cam_cfg: CameraConfig, sensor, width: int, height: int,
                             samples_sqrt: int, t0: float = 0.0, t1: float = 0.0,
                             params: RenderParams = RenderParams(), samples_per_pass: int = 1,
                             passes_per_chunk: int = 1, progress_cb=None, *, device="cuda",
                             tables: Optional[SceneTables] = None):
    """`render_frame` in chunks of `passes_per_chunk` passes, calling
    ``progress_cb(passes_done, n_pass, preview)`` after each chunk with the
    accumulator finished at the samples done so far (integrator.py:1023-1073).
    Equal to `render_frame` bit for bit for any chunking: the random numbers
    are counter-based on (pixel, sample)."""
    spp = samples_sqrt * samples_sqrt
    if spp % samples_per_pass:
        raise ValueError(f"samples_per_pass {samples_per_pass} must divide spp {spp}")
    n_pass = spp // samples_per_pass
    _check_device(torch.device(device), scene=scene.tris.p0, camera=cam.focal_px)
    if tables is None:
        tables = prepare_scene(scene, static, step=False)
    img_acc = torch.zeros((width * height, sensor.n_acc), dtype=torch.float32,
                          device=torch.device(device))
    done = 0
    while done < n_pass:
        chunk = min(passes_per_chunk, n_pass - done)
        img_acc = accumulate_passes(scene, static, cam, cam_cfg, sensor, width, height,
                                    samples_sqrt, t0, t1, params, samples_per_pass, img_acc,
                                    done, chunk, device=device, tables=tables)
        done += chunk
        if progress_cb is not None:
            preview = sensor.finish(img_acc, 1.0 / (done * samples_per_pass))
            progress_cb(done, n_pass, preview.reshape(height, width, sensor.n_acc))
    return sensor.finish(img_acc, 1.0 / spp).reshape(height, width, sensor.n_acc)
