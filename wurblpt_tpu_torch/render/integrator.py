"""Wavefront path integrator (port of ``wurblpt_tpu/render/integrator.py``:
the persistent-lane `render_frame_wavefront` and its bounce step).

Per bounce, as the reference's tracePath (wurblpt.hpp:108-275):
  1. closest hit (K1 brute force, or K5 on a BVH);
  2. on a miss, the environment map's radiance (K8) with its MIS weight
     against the env importance pdf (K8);
  3. hit assembly (K3), the material row (P0), emitted radiance with its MIS
     weight against the light-mixture pdf, or in scenes with many lights
     against the hit light's own pdf (`lights_pdf_at_hit`, P0);
  4. BSDF sample (RGL lanes through K7);
  5. NEE toward a picked hot spot, visibility by an any-hit cast (K2 or K6)
     shortened by `shadow_identity_eps`, power-heuristic weighted against
     the mixture pdf or, per light, against pick probability x the picked
     light's pdf;
  6. env NEE: an importance-sampled sky direction (K8), visibility by an
     any-hit cast to BIG, power-heuristic weighted;
  7. throughput update and Russian roulette.

Two routes take a step, chosen once per render from the scene and the
camera (`wavefront.diffuse_class`):

* the diffuse class (Lambertian surfaces, triangle lights, no sky, a
  pinhole camera without distortion; the cornell and tof_amcw paths) runs
  the step as K4's kernels (:mod:`.wavefront`): regeneration, K1, K3, the
  shade, K2 on its shadow rays and the NEE resolve, ~7 launches;
* every other scene runs the regeneration and the generic bounce above as
  PyTorch ops (~1000-1700 launches), with the hand-written casts, K3, K7,
  K8 and P0 inside; it shares its emission, NEE and roulette pieces with
  K4's plain versions.

A scene's tables (the brute-force scene or the BVH, the hit tables, the
packed material rows, the per-light rows and K4's light rows) are built
once per scene by `prepare_scene`; a frame rendered with them launches
only its lane state and its steps.

Randomness is counter-based on (pixel, sample, bounce, salt), so the port
draws the JAX package's random numbers. The JAX `while_loop` condition
becomes a Python loop with one host sync per step: K4's resolve kernel
evaluates it, the generic route with torch ops. Replacing that sync with a
CUDA graph of several steps is a later item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..core.rng import Salt, uniform4
from ..core.sampler import power_heuristic
from ..scene.ir import SceneArrays
from .bsdf import (
    ScatterKind,
    SceneStatic,
    bsdf_eval,
    bsdf_sample,
    gather_material_rows,
    pack_material_table,
)
from .camera import CameraConfig, CameraParams, check_camera
from .envmap import env_pdf, env_radiance, env_sample
from .intersect import HitTables, assemble_hit, build_hit_tables, scene_any_hit, scene_raw_hit
from .intersect_brute import BIG, any_hit, brute_eligible, build_brute_scene, closest_hit
from .lights import pick_area_table
from .sensor import SensorEvent
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
    light_nee,
    nee_resolve,
    path_lengths,
    regen_pinhole,
    regen_plain,
    shade_diffuse,
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

    accel: object                      # the BVH's arrays, or the brute-force scene
    hit: HitTables
    mat: torch.Tensor                  # [M, 23] packed material rows
    pick_area: Optional[torch.Tensor]  # [P, 2] per-light MIS rows (None: mixture or no light)
    step: Optional[StepTables]         # K4's tables (None: a scene outside the diffuse class)


def prepare_scene(scene: SceneArrays, static: SceneStatic) -> SceneTables:
    """The tables every frame of `scene` reads: build them once and pass them
    to each `render_frame_wavefront` of the scene."""
    mat = pack_material_table(scene.materials)
    per_light = static.n_lights > 0 and static.per_light_mis
    pick_area = pick_area_table(scene) if per_light else None
    return SceneTables(
        accel=scene.bvh if scene.has_bvh else build_brute_scene(scene),
        hit=build_hit_tables(scene), mat=mat, pick_area=pick_area,
        step=(build_step_tables(scene, static, mat, pick_area)
              if diffuse_scene(scene, static) else None))


def _make_bounce_fn(scene: SceneArrays, static: SceneStatic, tables: SceneTables, sensor,
                    params: RenderParams, n):
    """One generic torch-op wavefront bounce as a function of (state, pixel, sample)."""
    accel, ht, mat_packed, pick_area = tables.accel, tables.hit, tables.mat, tables.pick_area
    mat_types = static.mat_types
    rgl = scene.rgl
    has_lights = static.n_lights > 0
    per_light = pick_area is not None
    has_env = static.env_kind != 0
    env_is = has_env and static.env_importance
    env = scene.envmap
    dev = scene.device
    t_min = torch.full((n,), params.min_hit_distance, dtype=torch.float32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)

    def body(st: LoopState, pixel_id, sample_id) -> LoopState:
        k = st.bounce
        acc = st.acc
        t, prim, u, v = scene_raw_hit(accel, st.o, st.d, t_min,
                                      torch.where(st.active, BIG, 0.0))
        hit = (prim >= 0) & st.active

        # Environment on a miss (wurblpt.hpp:136-146), MIS-weighted against
        # env NEE with the pdf of the previous bsdf sample.
        if has_env:
            L_env = env_radiance(env, st.d)
            if env_is:
                w_env = torch.where(st.prev_random,
                                    power_heuristic(st.prev_pdf, env_pdf(env, st.d)), 1.0)
            else:
                w_env = torch.ones_like(t)
            acc = sensor.accumulate(acc, SensorEvent(
                radiance=st.throughput * L_env * w_env[:, None], path_component=k,
                geom_path_length=st.geom_len, optical_path_length=st.opt_len,
                distance_to_light=zeros, active=st.active & (prim < 0)))

        hr = assemble_hit(ht, st.o, st.d, t, prim, u, v)
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
                geom_len, opt_len, u3, mat_packed, per_light)
            occluded = scene_any_hit(accel, hr.position, ldir, t_min, t_shadow)
            acc = deposit_unoccluded(acc, pending, occluded)

        # Env NEE (wurblpt.hpp:221-252): shadow ray to BIG, unoccluded lanes
        # see the sky's radiance in the sampled direction.
        if env_is:
            ue = uniform4(pixel_id, sample_id, k, Salt.ENVMAP_SAMPLE)[:, :3].contiguous()
            edir, epdf = env_sample(env, ue)
            f_e, pdf_be = bsdf_eval(hr, st.d, edir, mrow, mat_types, rgl=rgl)
            occluded_e = scene_any_hit(accel, hr.position, edir, t_min,
                                       torch.where(is_random, BIG, 0.0))
            w_e = power_heuristic(epdf, pdf_be)
            contrib_e = (st.throughput * f_e * env_radiance(env, edir)
                         * (w_e / torch.clamp_min(epdf, 1e-12))[:, None])
            acc = sensor.accumulate(acc, SensorEvent(
                radiance=contrib_e, path_component=k, geom_path_length=geom_len,
                optical_path_length=opt_len, distance_to_light=zeros,
                active=is_random & ~occluded_e & (epdf > 1e-12)))

        new = advance(params, st, hit, hr, sr, is_random, is_explicit, u_aux[:, 2], acc,
                      geom_len, opt_len, light_pdf_next)
        # Ray counters: one closest cast per active lane, one shadow cast per
        # RANDOM lane and NEE kind (bench.py's Mrays/s accounting).
        n_closest = st.active.sum()
        n_all = n_closest + (int(has_lights) + int(env_is)) * is_random.sum()
        return new._replace(stats=st.stats + torch.stack([n_closest, n_all]))

    return body


def _make_generic_step(scene, static, tables, sensor, params, cam, cam_cfg, L):
    """The torch-op step: regeneration, then the generic bounce; the loop
    condition as torch ops and one host sync."""
    bounce_fn = _make_bounce_fn(scene, static, tables, sensor, params, L)

    def step(ls, sample, k_next, lanes):
        ls, sample, k_next, _ = regen_plain(ls, sample, k_next, cam, cam_cfg, lanes,
                                            params.randomize_ray_over_pixel)
        ls = bounce_fn(ls, lanes.pixel, sample)
        work = ls.active.any() | ((k_next < lanes.P) & lanes.valid).any()
        return ls, sample, k_next, bool(work.item())

    return step


def _make_k4_step(scene, static, tables, sensor, params, cam, cam_cfg, L):
    """The diffuse-class step through K4: regeneration (wpt_regen_pinhole), K1,
    K3, the shade (wpt_shade_diffuse), K2 on its shadow rays and the NEE
    resolve (wpt_nee_resolve), which also evaluates the loop condition; one
    host sync reads it."""
    bs, ht, step_tables = tables.accel, tables.hit, tables.step
    t_min = torch.full((L,), params.min_hit_distance, dtype=torch.float32, device=scene.device)

    def step(ls, sample, k_next, lanes):
        ls, sample, k_next, t_max = regen_pinhole(ls, sample, k_next, cam, cam_cfg, lanes,
                                                  params.randomize_ray_over_pixel)
        t, prim, u, v = closest_hit(bs, ls.o, ls.d, t_min, t_max)
        hr = assemble_hit(ht, ls.o, ls.d, t, prim, u, v)
        ls, shadow_d, shadow_tmax, pending = shade_diffuse(step_tables, sensor, params, ls,
                                                           lanes.pixel, sample, t, prim, hr)
        occluded = any_hit(bs, hr.position, shadow_d, t_min, shadow_tmax)
        acc, work = nee_resolve(ls.acc, pending, occluded, ls.active, k_next, lanes)
        return ls._replace(acc=acc), sample, k_next, bool(work.item())

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
        work = True
        while work:
            ls, sample, k_next, work = step(ls, sample, k_next, lanes)

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
):
    """Render a frame with persistent lanes: each lane owns one pixel and a
    fixed subset of its samples, and starts the pixel's next sample the moment
    a path dies. Blocks of B pixels x m sample-lanes (B * m <= max_lanes) run
    one after another.

    `scene` and `cam` must live on `device`; `tables` are the scene's own
    (`prepare_scene`), built here when not given. Returns the image [H, W, n_acc]
    (row 0 at the top); with `return_stats` also the [2] int64 cast counters
    (closest-hit casts, all casts incl. NEE shadow rays)."""
    device = torch.device(device)
    static.check_slice()
    check_camera(cam_cfg)
    if not (scene.has_bvh or brute_eligible(scene)):
        raise NotImplementedError("a scene of more than 2048 primitives needs a BVH "
                                  "(flatten with use_bvh)")
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
    make_step = _make_k4_step if diffuse_class(scene, static, cam_cfg) else _make_generic_step
    step = make_step(scene, static, tables, sensor, params, cam, cam_cfg, L)
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
