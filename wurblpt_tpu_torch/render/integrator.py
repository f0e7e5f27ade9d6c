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

Randomness is counter-based on (pixel, sample, bounce, salt), so the port
draws the JAX package's random numbers. The JAX `while_loop` condition
becomes a Python loop with one host sync per step (`_any_work`); replacing
that sync with a CUDA graph of several steps is a later item.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..core.rng import Salt, uniform2, uniform4
from ..core.sampler import power_heuristic
from ..core.vecmath import cross, dot
from ..scene.ir import MaterialFlags, SceneArrays
from .bsdf import (
    ScatterKind,
    SceneStatic,
    bsdf_eval,
    bsdf_sample,
    emitted,
    gather_material_rows,
    pack_material_table,
)
from .camera import CameraConfig, CameraParams, camera_rays, check_camera
from .envmap import env_pdf, env_radiance, env_sample
from .intersect import assemble_hit, build_hit_tables, scene_any_hit, scene_raw_hit
from .intersect_brute import BIG, brute_eligible, build_brute_scene
from .lights import (
    light_pick_prob_of,
    lights_pdf_at_hit,
    lights_pdf_multi,
    lights_sample,
    pick_area_table,
)
from .sensor import SensorEvent


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


class _LoopState(NamedTuple):
    bounce: torch.Tensor          # [N] int64 per-lane bounce index
    o: torch.Tensor               # [N, 3]
    d: torch.Tensor               # [N, 3]
    ior: torch.Tensor             # [N, 4]
    throughput: torch.Tensor      # [N, 4]
    active: torch.Tensor          # [N] bool
    acc: torch.Tensor             # [N, n_acc]
    geom_len: torch.Tensor        # [N]
    opt_len: torch.Tensor         # [N, 4]
    prev_pdf: torch.Tensor        # [N] pdf of the previous RANDOM bsdf sample (0 if none)
    prev_random: torch.Tensor     # [N] bool: previous scatter was pdf-sampled
    prev_light_pdf: torch.Tensor  # [N] light-mixture pdf of the previous bsdf sample
    stats: torch.Tensor           # [2] int64: closest casts, all casts incl. shadow


def _light_emitted_at(scene: SceneArrays, prim, toward, mat_packed):
    """Emitted radiance of triangle light `prim` toward unit direction `toward`
    (from the light to the receiver); one-sided unless the material is two-sided."""
    T = scene.tris
    pl = prim.long()
    fn = cross(T.e1[pl], T.e2[pl])
    n = fn / torch.clamp_min(torch.sqrt(dot(fn, fn, keepdim=True)), 1e-20)
    lrow = gather_material_rows(mat_packed, T.mat[pl])
    two_sided = (lrow.flags & MaterialFlags.TWO_SIDED) > 0
    front = (dot(n, toward) > 0.0) | two_sided
    return torch.where(front[:, None], lrow.emissive, 0.0)


def _make_bounce_fn(scene: SceneArrays, static: SceneStatic, sensor, params: RenderParams, n):
    """One wavefront bounce as a function of (state, pixel, sample)."""
    accel = scene.bvh if scene.has_bvh else build_brute_scene(scene)
    ht = build_hit_tables(scene)
    mat_packed = pack_material_table(scene.materials)
    mat_types = static.mat_types
    rgl = scene.rgl
    has_lights = static.n_lights > 0
    per_light = has_lights and static.per_light_mis
    pick_area = pick_area_table(scene) if per_light else None
    has_env = static.env_kind != 0
    env_is = has_env and static.env_importance
    env = scene.envmap
    dev = scene.device
    t_min = torch.full((n,), params.min_hit_distance, dtype=torch.float32, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)

    def body(st: _LoopState, pixel_id, sample_id) -> _LoopState:
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

        geom_len = torch.where(hit, st.geom_len + t, st.geom_len)
        opt_len = torch.where(hit[:, None], st.opt_len + t[:, None] * st.ior, st.opt_len)

        # Emitted, MIS-weighted with the light-mixture pdf of this ray, which
        # the previous bounce evaluated (st.prev_light_pdf); per light, with
        # the pdf of the light actually hit, from the hit itself.
        e = emitted(hr, -st.d, mrow)
        if per_light:
            lp_hit = lights_pdf_at_hit(pick_area, st.d, t, torch.where(hit, prim, -1),
                                       hr.geom_normal)
            w_emit = torch.where(st.prev_random, power_heuristic(st.prev_pdf, lp_hit), 1.0)
        elif has_lights:
            w_emit = torch.where(st.prev_random,
                                 power_heuristic(st.prev_pdf, st.prev_light_pdf), 1.0)
        else:
            w_emit = torch.ones_like(t)
        acc = sensor.accumulate(acc, SensorEvent(
            radiance=st.throughput * e * w_emit[:, None], path_component=k,
            geom_path_length=geom_len, optical_path_length=opt_len,
            distance_to_light=t, active=hit))

        u4 = uniform4(pixel_id, sample_id, k, Salt.BSDF)
        u_aux = uniform4(pixel_id, sample_id, k, Salt.BSDF_AUX)
        sr = bsdf_sample(hr, st.d, st.ior, u4, u_aux[:, 0], u_aux[:, 1], mrow, mat_types,
                         rgl=rgl)
        is_random = hit & (sr.kind == ScatterKind.RANDOM) & (sr.pdf > 0.0)
        is_explicit = hit & (sr.kind == ScatterKind.EXPLICIT)

        if has_lights:
            u3 = uniform4(pixel_id, sample_id, k, Salt.NEE_SAMPLE)[:, :3]
            ldir, lprim, ldist, lpick, pdf_sa = lights_sample(scene, hr.position, u3)
            if per_light:
                # The NEE strategy "pick light i, sample its solid angle" has
                # density pick(i) x pdf_i; the emitted side is weighted at the
                # next hit (lights_pdf_at_hit above).
                pdf_light = light_pick_prob_of(scene, lpick) * pdf_sa
                light_pdf_next = zeros
            else:
                # One mixture evaluation for both directions that need it: the
                # NEE direction now, the bsdf sample at the next bounce.
                pdf_pair = lights_pdf_multi(scene, hr.position,
                                            torch.stack([ldir, sr.direction], 1))
                pdf_light, light_pdf_next = pdf_pair[:, 0], pdf_pair[:, 1]
            f_l, pdf_b = bsdf_eval(hr, st.d, ldir, mrow, mat_types, rgl=rgl)
            t_vis = torch.clamp_min(ldist * (1.0 - params.shadow_identity_eps),
                                    params.min_hit_distance)
            occluded = scene_any_hit(accel, hr.position, ldir, t_min,
                                     torch.where(is_random, t_vis, 0.0))
            Le = _light_emitted_at(scene, torch.clamp_min(lprim, 0), -ldir, mat_packed)
            w_nee = power_heuristic(pdf_light, pdf_b)
            contrib = (st.throughput * f_l * Le
                       * (w_nee / torch.clamp_min(pdf_light, 1e-12))[:, None])
            acc = sensor.accumulate(acc, SensorEvent(
                radiance=contrib, path_component=k,
                geom_path_length=geom_len + ldist,
                optical_path_length=opt_len + ldist[:, None] * st.ior,
                distance_to_light=ldist,
                active=is_random & ~occluded & (pdf_light > 1e-12)))

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

        # Throughput update + Russian roulette (wurblpt.hpp:258-273).
        ratio = torch.where(is_random[:, None],
                            sr.atten / torch.clamp_min(sr.pdf, 1e-12)[:, None], sr.atten)
        cont = is_random | is_explicit
        new_tp = st.throughput * ratio
        max_r = ratio.max(-1).values
        do_rr = (k >= params.rr_start) & (max_r < params.rr_threshold) & cont
        q = torch.clamp(1.0 - max_r, 0.0, 0.95)
        killed = do_rr & (u_aux[:, 2] < q)
        new_tp = torch.where((do_rr & ~killed)[:, None],
                             new_tp / torch.clamp_min(1.0 - q, 0.05)[:, None], new_tp)
        alive = cont & ~killed & (new_tp.max(-1).values > 0.0)

        # Ray counters: one closest cast per active lane, one shadow cast per
        # RANDOM lane and NEE kind (bench.py's Mrays/s accounting).
        n_closest = st.active.sum()
        n_all = n_closest + (int(has_lights) + int(env_is)) * is_random.sum()
        return _LoopState(
            bounce=torch.where(st.active, k + 1, k),
            o=torch.where(hit[:, None], hr.position, st.o),
            d=torch.where(cont[:, None], sr.direction, st.d),
            ior=torch.where(cont[:, None], sr.ior, st.ior),
            throughput=torch.where(cont[:, None], new_tp, st.throughput),
            active=st.active & alive & (k + 1 < params.max_path_components),
            acc=acc,
            geom_len=geom_len,
            opt_len=opt_len,
            prev_pdf=torch.where(is_random, sr.pdf, 0.0),
            prev_random=is_random,
            prev_light_pdf=(torch.where(is_random, light_pdf_next, 0.0)
                            if has_lights else st.prev_light_pdf),
            stats=st.stats + torch.stack([n_closest, n_all]),
        )

    return body


def _make_run_block(cam, cam_cfg, bounce_fn, sensor, params, width, height, samples_sqrt,
                    B, m, P, n_pix, device):
    """One persistent-lane block render: (blk, img_acc, stats) -> (img_acc, stats)."""
    L = B * m
    lane = torch.arange(L, dtype=torch.int64, device=device)
    b_lane = lane % B            # pixel slot within the block
    j_lane = lane // B           # sample-lane index in [0, m)
    f32 = dict(dtype=torch.float32, device=device)

    def run_block(blk, img_acc, stats):
        p_lane = blk * B + b_lane
        valid = p_lane < n_pix
        p_safe = torch.clamp_max(p_lane, n_pix - 1)
        px = (p_safe % width).to(torch.float32)
        py = (p_safe // width).to(torch.float32)
        ls = _LoopState(
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

        def _any_work():   # the while_loop condition; one host sync per step
            return bool((ls.active.any() | ((k_next < P) & valid).any()).item())

        while _any_work():
            # Regenerate dead lanes with their pixel's next sample.
            need = (~ls.active) & (k_next < P) & valid
            s_new = j_lane + k_next * m          # global sample id in [0, spp)
            sample = torch.where(need, s_new, sample)
            if params.randomize_ray_over_pixel:
                uj = uniform2(p_lane, s_new, 0, Salt.PIXEL_JITTER)
                jx = ((s_new % samples_sqrt).to(torch.float32) + uj[:, 0]) / samples_sqrt
                jy = ((s_new // samples_sqrt).to(torch.float32) + uj[:, 1]) / samples_sqrt
            else:
                jx = jy = torch.full((L,), 0.5, **f32)
            o, d = camera_rays(cam, cam_cfg, torch.stack([px + jx, py + jy], -1),
                               width, height)
            sel = need[:, None]
            ls = ls._replace(
                bounce=torch.where(need, 0, ls.bounce),
                o=torch.where(sel, o, ls.o),
                d=torch.where(sel, d, ls.d),
                ior=torch.where(sel, 1.0, ls.ior),
                throughput=torch.where(sel, 1.0, ls.throughput),
                active=ls.active | need,
                geom_len=torch.where(need, 0.0, ls.geom_len),
                opt_len=torch.where(sel, 0.0, ls.opt_len),
                prev_pdf=torch.where(need, 0.0, ls.prev_pdf),
                prev_random=ls.prev_random & ~need,
                prev_light_pdf=torch.where(need, 0.0, ls.prev_light_pdf),
            )
            k_next = k_next + need.to(torch.int64)
            ls = bounce_fn(ls, p_lane, sample)

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
):
    """Render a frame with persistent lanes: each lane owns one pixel and a
    fixed subset of its samples, and starts the pixel's next sample the moment
    a path dies. Blocks of B pixels x m sample-lanes (B * m <= max_lanes) run
    one after another.

    `scene` and `cam` must live on `device`. Returns the image [H, W, n_acc]
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

    bounce_fn = _make_bounce_fn(scene, static, sensor, params, L)
    run_block = _make_run_block(cam, cam_cfg, bounce_fn, sensor, params, width, height,
                                samples_sqrt, B, m, P, n_pix, device)
    img = torch.zeros((n_blocks * B, sensor.n_acc), dtype=torch.float32, device=device)
    stats = torch.zeros((2,), dtype=torch.int64, device=device)
    for blk in range(n_blocks):
        img, stats = run_block(blk, img, stats)
    img = sensor.finish(img[:n_pix], 1.0 / spp).reshape(height, width, sensor.n_acc)
    if return_stats:
        return img, stats
    return img
