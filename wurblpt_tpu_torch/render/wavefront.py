"""K4: one wavefront step as hand-written kernels, for three classes of scenes.

Port of the JAX package's bounce body (``wurblpt_tpu/render/integrator.py``
:400-752, `_make_bounce_fn`) and its regeneration (:973-1013), for

* the diffuse class (`diffuse_class`): Lambertian surfaces; diffuse, spot
  and ToF triangle lights with mixture or per-light MIS; no sky; static, or
  animated by rigid keyframes at the frame's one instant (the casts then
  the sweeps in object space and K3a, a moving light placed where it is at
  that instant: `step_tables_at`);
* the env class (`env_class`): Lambertian, GGX, mirror and glass surfaces,
  triangles and analytic spheres, under an equirect, cube or constant sky
  with or without importance tables; no light; brute force or a BVH;
* the lit class (`lit_class`): Lambertian, GGX, mirror, glass, ModPhong
  and measured-RGL surfaces with triangle lights under per-light MIS beside
  an equirect or cube sky with importance tables (the city); brute force
  or a BVH.

The diffuse and env classes are seen by a mono pinhole camera with or
without one of the three lens models; the lit class also by a surround
camera, mono or stereo. One step is

    the regeneration   refill dead lanes with their pixel's next sample:
                       wpt_regen_pinhole (the lens model's inverse inside)
                       or wpt_regen_surround (the 180/360-degree camera,
                       stereo halves and eye offsets)
    closest hit        K1 or KS1 (brute force) or K5 (BVH), then K3 (K3a in
                       an animated scene) hit assembly
    the shade          wpt_shade_diffuse: emission with its MIS weight, the
                       Lambertian sample, light NEE (the shadow ray and its
                       pending deposit), Russian roulette, the next state,
                       the cast counters;
                       wpt_shade_env: the sky on a miss with its MIS weight,
                       emission, the Lambertian / GGX / mirror / glass
                       sample, env NEE (the shadow ray to BIG and its
                       pending deposit) when the sky is importance-sampled,
                       Russian roulette, the next state, the cast counters;
                       wpt_shade_lit: the sky on a miss, emission with its
                       per-light MIS weight, the sample of every lobe above
                       (ModPhong with its opacity pass-through, RGL through
                       K7's arithmetic inline), light NEE and env NEE (two
                       shadow rays and two pending deposits per lane),
                       Russian roulette, the next state, the counters
    any hit            K2, KS2 or K6 on the shadow rays (none without NEE; the
                       lit class's two kinds in one cast of 2 N rays)
    wpt_nee_resolve    add the pending deposits of unoccluded lanes (the
                       light's, then the sky's); flag whether any lane still
                       has work (the loop condition)

`regen_pinhole`, `regen_surround`, `shade_diffuse`, `shade_env`,
`shade_lit` and `nee_resolve` launch the kernels of ``csrc/wavefront.cu``
on CUDA tensors and run their plain versions (`regen_plain`,
`shade_diffuse_plain`, `shade_env_plain`, `shade_lit_plain`,
`nee_resolve_plain`) on CPU tensors. The plain versions are built from the
helpers of the generic torch-op bounce (`emit`, `light_nee`, `env_miss`,
`env_nee`, `advance`, here), which keeps serving the scenes outside the
classes, so both routes compute the same thing in the same order.

The lane state is updated in place by the regenerations and the lit shade.
JAX's arrays are immutable, so its bounce and regeneration return new
state; the port's `regen_pinhole`, `regen_surround` and `shade_lit` write
the `LoopState` tensors, `sample` and `k_next` they are given and return
them, because on the card most lanes of a step keep most of their fields:
a lane the regeneration does not refill writes only its cast's t_max, a
lane dead at the lit shade only its previous sample's pdf and flag and its
two idle shadow rows, an escaped lane its deposit, bounce index, end and
flags, and the lit shade computes a shadow ray's origin and direction only
on the rows that cast one (t_max > 0; K2/K6 read no other). The plain
versions stay pure functions (the generic step uses `regen_plain`); on CPU
tensors the wrappers run them and copy their result into the inputs, so
both devices keep the same contract. The diffuse and env shades still
write new state.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import native
from ..core.rng import Salt, uniform2, uniform4
from ..core.sampler import power_heuristic
from ..core.vecmath import cross, dot
from ..materials.rgl import RGLTables, c_tables
from ..scene.animation import matvec
from ..scene.ir import EnvMapArrays, MaterialFlags, MaterialType, SceneArrays
from .bsdf import (
    LIGHT_MATERIALS,
    ScatterKind,
    SceneStatic,
    bsdf_eval,
    bsdf_sample,
    emitted,
    gather_material_rows,
)
from .camera import CameraConfig, CameraParams, SurroundMode, camera_rays
from .envmap import env_pdf, env_radiance, env_sample
from .intersect import HitRecord
from .intersect_brute import BIG
from .lights import (
    light_pick_prob_of,
    light_tris,
    lights_pdf_at_hit,
    lights_pdf_multi,
    lights_sample,
    pick_frame,
)
from .sensor import SensorEvent, SensorRGB, SensorTofAmcw

DIFFUSE_MATERIALS = frozenset({MaterialType.LAMBERTIAN}) | LIGHT_MATERIALS
ENV_MATERIALS = frozenset({MaterialType.LAMBERTIAN, MaterialType.GGX, MaterialType.MIRROR,
                           MaterialType.GLASS})
LIT_MATERIALS = ENV_MATERIALS | {MaterialType.MODPHONG, MaterialType.RGL} | LIGHT_MATERIALS

class LoopState(NamedTuple):
    """Per-lane path state of the wavefront (the JAX package's integrator._LoopState)."""

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


class BlockLanes(NamedTuple):
    """Where the lanes of one block draw their samples: lane i renders pixel
    blk * B + i % B (when < n_pix) and its samples j + k * m, k < P, with
    j = i // B."""

    pixel: torch.Tensor   # [L] int64 pixel id (unclamped)
    j_lane: torch.Tensor  # [L] int64 sample-lane index in [0, m)
    valid: torch.Tensor   # [L] bool: pixel < n_pix
    px: torch.Tensor      # [L] f32 column of the (clamped) pixel
    py: torch.Tensor      # [L] f32 row
    blk: int
    B: int
    m: int
    P: int
    n_pix: int
    width: int
    height: int
    ssqrt: int


def block_lanes(blk, B, m, P, width, height, ssqrt, device) -> BlockLanes:
    lane = torch.arange(B * m, dtype=torch.int64, device=device)
    n_pix = width * height
    pixel = blk * B + lane % B
    p_safe = torch.clamp_max(pixel, n_pix - 1)
    return BlockLanes(pixel, lane // B, pixel < n_pix, (p_safe % width).to(torch.float32),
                      (p_safe // width).to(torch.float32), blk, B, m, P, n_pix, width, height,
                      ssqrt)


def diffuse_scene(scene: SceneArrays, static: SceneStatic) -> bool:
    """Whether a scene is of the diffuse class: Lambertian surfaces, triangle
    lights with a power-weighted pick (mixture or per-light MIS), no sky, no
    texture or medium, the brute-force intersector (K1 or the sweeps), static
    or animated (`SceneStatic.check_slice` refuses animation with a BVH)."""
    return (static.mat_types <= DIFFUSE_MATERIALS and static.n_lights > 0
            and not (static.has_textures or static.has_media or static.has_bvh
                     or static.sphere_lights)
            and static.env_kind == 0 and scene.light_alias_prob is not None
            and scene.light_weights is not None)


def env_scene(scene: SceneArrays, static: SceneStatic) -> bool:
    """Whether a scene is of the env class: Lambertian, GGX, mirror and glass
    surfaces (triangles and analytic spheres) under an equirect, cube or
    constant sky, with or without importance tables (an equirect sky has
    them: `SceneStatic.check_slice`), no light, no texture, animation or
    medium; the brute-force intersector or a BVH of triangles."""
    return (static.mat_types <= ENV_MATERIALS and static.n_lights == 0
            and not (static.has_textures or static.has_anim or static.has_media
                     or static.bvh_spheres or static.sphere_lights)
            and static.env_kind != 0)


def lit_scene(scene: SceneArrays, static: SceneStatic) -> bool:
    """Whether a scene is of the lit class: Lambertian, GGX, mirror, glass,
    ModPhong and RGL surfaces (RGL with its tables) with triangle lights
    under per-light MIS and a power-weighted pick, beside an equirect or
    cube sky with importance tables; no texture, animation or medium; the
    brute-force intersector or a BVH of triangles."""
    return (static.mat_types <= LIT_MATERIALS and static.n_lights > 0 and static.per_light_mis
            and not (static.has_textures or static.has_anim or static.has_media
                     or static.bvh_spheres or static.sphere_lights)
            and static.env_kind in (1, 2) and static.env_importance
            and scene.light_alias_prob is not None and scene.light_weights is not None
            and (MaterialType.RGL not in static.mat_types or static.rgl_tables))


def _pinhole(cam_cfg: CameraConfig) -> bool:
    """A mono pinhole camera, with or without a lens model, without depth of
    field or animation."""
    return (cam_cfg.surround == SurroundMode.OFF and not cam_cfg.stereo and not cam_cfg.dof
            and cam_cfg.anim_id < 0)


def _surround(cam_cfg: CameraConfig) -> bool:
    """A 180- or 360-degree surround camera, mono or stereo, without depth of
    field or animation."""
    return cam_cfg.surround != SurroundMode.OFF and not cam_cfg.dof and cam_cfg.anim_id < 0


def diffuse_class(scene: SceneArrays, static: SceneStatic, cam_cfg: CameraConfig) -> bool:
    """Whether a scene and camera take K4 with the diffuse shade (the route is
    decided once per render): a scene of the diffuse class (`diffuse_scene`)
    seen by a mono pinhole camera (`_pinhole`)."""
    return diffuse_scene(scene, static) and _pinhole(cam_cfg)


def env_class(scene: SceneArrays, static: SceneStatic, cam_cfg: CameraConfig) -> bool:
    """Whether a scene and camera take K4 with the env shade: a scene of the
    env class (`env_scene`) seen by a mono pinhole camera (`_pinhole`)."""
    return env_scene(scene, static) and _pinhole(cam_cfg)


def lit_class(scene: SceneArrays, static: SceneStatic, cam_cfg: CameraConfig) -> bool:
    """Whether a scene and camera take K4 with the lit shade: a scene of the
    lit class (`lit_scene`) seen by a mono pinhole camera (`_pinhole`) or a
    surround camera, mono or stereo (`_surround`)."""
    return lit_scene(scene, static) and (_pinhole(cam_cfg) or _surround(cam_cfg))


# ---------------------------------------------------------------------------
# Pieces of the torch-op bounce, shared by the generic bounce and the plain versions
# ---------------------------------------------------------------------------

def light_emitted_at(scene: SceneArrays, prim, toward, mat_packed, frame=None):
    """Emitted radiance of triangle light `prim` toward unit direction `toward`
    (from the light to the receiver); one-sided unless the material is
    two-sided, and a spot or ToF light only inside its cone, |cos| >= p0.x
    (the JAX package's integrator.py:241-250). `frame` (m [N, 3, 3], t) is
    the light's forward map at the frame's instant, for an animated light."""
    T = scene.tris
    pl = prim.long()
    e1, e2 = T.e1[pl], T.e2[pl]
    if frame is not None:
        e1, e2 = matvec(frame[0], e1), matvec(frame[0], e2)
    fn = cross(e1, e2)
    n = fn / torch.clamp_min(torch.sqrt(dot(fn, fn, keepdim=True)), 1e-20)
    lrow = gather_material_rows(mat_packed, T.mat[pl])
    cos_v = dot(n, toward)
    two_sided = (lrow.flags & MaterialFlags.TWO_SIDED) > 0
    front = (cos_v > 0.0) | two_sided
    is_cone = (lrow.typ == MaterialType.LIGHT_SPOT) | (lrow.typ == MaterialType.LIGHT_TOF)
    ok = front & ((torch.abs(cos_v) >= lrow.p0[:, 0]) | ~is_cone)
    return torch.where(ok[:, None], lrow.emissive, 0.0)


def path_lengths(st: LoopState, hit, t):
    """Geometric and per-channel optical path length after the hit (wurblpt.hpp:148-150)."""
    geom_len = torch.where(hit, st.geom_len + t, st.geom_len)
    opt_len = torch.where(hit[:, None], st.opt_len + t[:, None] * st.ior, st.opt_len)
    return geom_len, opt_len


def emit(sensor, acc, st: LoopState, hr: HitRecord, mrow, t, prim, hit, geom_len, opt_len,
         n_lights: int, pick_area):
    """Deposit the radiance emitted at the hit with its MIS weight: against the
    light-mixture pdf of this ray, which the previous bounce evaluated
    (st.prev_light_pdf), or with per-light MIS (`pick_area` given) against
    the pdf of the light actually hit (wurblpt.hpp:160-163, 181-185)."""
    e = emitted(hr, -st.d, mrow)
    if pick_area is not None:
        lp_hit = lights_pdf_at_hit(pick_area, st.d, t, torch.where(hit, prim, -1),
                                   hr.geom_normal)
        w_emit = torch.where(st.prev_random, power_heuristic(st.prev_pdf, lp_hit), 1.0)
    elif n_lights > 0:
        w_emit = torch.where(st.prev_random,
                             power_heuristic(st.prev_pdf, st.prev_light_pdf), 1.0)
    else:
        w_emit = torch.ones_like(t)
    return sensor.accumulate(acc, SensorEvent(
        radiance=st.throughput * e * w_emit[:, None], path_component=st.bounce,
        geom_path_length=geom_len, optical_path_length=opt_len,
        distance_to_light=t, active=hit))


def light_nee(scene: SceneArrays, sensor, params, st: LoopState, hr: HitRecord, mrow, mat_types,
              rgl, sr_direction, is_random, geom_len, opt_len, u3, mat_packed, per_light: bool,
              frames=None):
    """NEE toward a picked hot spot (wurblpt.hpp:179-220), up to its shadow ray;
    `frames` (lights.light_frames) places animated lights at the frame's instant.

    Returns (shadow direction [N, 3], shadow t_max [N]: the light's distance
    shortened by `shadow_identity_eps` on RANDOM lanes, 0 elsewhere, the
    pending deposit [N, n_acc]: what the sensor takes if the shadow ray is
    not occluded, 0 on lanes that deposit nothing, and the light-mixture pdf
    of the bsdf sample for the next bounce's emission weight)."""
    ldir, lprim, ldist, lpick, pdf_sa = lights_sample(scene, hr.position, u3, frames)
    if per_light:
        # The NEE strategy "pick light i, sample its solid angle" has density
        # pick(i) x pdf_i; the emitted side is weighted at the next hit.
        pdf_light = light_pick_prob_of(scene, lpick) * pdf_sa
        light_pdf_next = torch.zeros_like(pdf_sa)
    else:
        # One mixture evaluation for both directions that need it: the NEE
        # direction now, the bsdf sample at the next bounce.
        pdf_pair = lights_pdf_multi(scene, hr.position, torch.stack([ldir, sr_direction], 1),
                                    frames)
        pdf_light, light_pdf_next = pdf_pair[:, 0], pdf_pair[:, 1]
    f_l, pdf_b = bsdf_eval(hr, st.d, ldir, mrow, mat_types, rgl=rgl)
    t_vis = torch.clamp_min(ldist * (1.0 - params.shadow_identity_eps), params.min_hit_distance)
    Le = light_emitted_at(scene, torch.clamp_min(lprim, 0), -ldir, mat_packed,
                          None if frames is None else pick_frame(frames, lpick))
    w_nee = power_heuristic(pdf_light, pdf_b)
    contrib = st.throughput * f_l * Le * (w_nee / torch.clamp_min(pdf_light, 1e-12))[:, None]
    dep, ok = sensor.deposit(SensorEvent(
        radiance=contrib, path_component=st.bounce, geom_path_length=geom_len + ldist,
        optical_path_length=opt_len + ldist[:, None] * st.ior, distance_to_light=ldist,
        active=is_random & (pdf_light > 1e-12)))
    return (ldir, torch.where(is_random, t_vis, 0.0), torch.where(ok[:, None], dep, 0.0),
            light_pdf_next)


def deposit_unoccluded(acc, pending, occluded):
    """acc + the pending NEE deposit where the shadow ray is not occluded."""
    return acc + torch.where(occluded[:, None], 0.0, pending)


def env_miss(sensor, acc, st: LoopState, env: EnvMapArrays, prim, importance: bool):
    """Deposit the sky's radiance on the active lanes whose ray escaped
    (wurblpt.hpp:136-146), MIS-weighted against env NEE with the pdf of the
    previous bsdf sample when the sky is importance-sampled (the JAX
    package's integrator.py:456-474)."""
    L_env = env_radiance(env, st.d)
    if importance:
        w_env = torch.where(st.prev_random, power_heuristic(st.prev_pdf, env_pdf(env, st.d)), 1.0)
    else:
        w_env = torch.ones_like(st.prev_pdf)
    return sensor.accumulate(acc, SensorEvent(
        radiance=st.throughput * L_env * w_env[:, None], path_component=st.bounce,
        geom_path_length=st.geom_len, optical_path_length=st.opt_len,
        distance_to_light=torch.zeros_like(st.geom_len), active=st.active & (prim < 0)))


def env_nee(sensor, env: EnvMapArrays, st: LoopState, hr: HitRecord, mrow, mat_types, rgl, ue,
            is_random, geom_len, opt_len):
    """Env NEE (wurblpt.hpp:221-252; JAX integrator.py:650-693) up to its
    shadow ray: an importance-sampled sky direction from the uniforms ue
    [N, 3], the bsdf toward it, the power-heuristic weight.

    Returns (shadow direction [N, 3], shadow t_max [N]: BIG on RANDOM lanes,
    0 elsewhere, the pending deposit [N, n_acc]: what the sensor takes if the
    shadow ray is not occluded, 0 on lanes that deposit nothing)."""
    edir, epdf = env_sample(env, ue)
    f_e, pdf_be = bsdf_eval(hr, st.d, edir, mrow, mat_types, rgl=rgl)
    w_e = power_heuristic(epdf, pdf_be)
    contrib_e = (st.throughput * f_e * env_radiance(env, edir)
                 * (w_e / torch.clamp_min(epdf, 1e-12))[:, None])
    dep, ok = sensor.deposit(SensorEvent(
        radiance=contrib_e, path_component=st.bounce, geom_path_length=geom_len,
        optical_path_length=opt_len, distance_to_light=torch.zeros_like(geom_len),
        active=is_random & (epdf > 1e-12)))
    return edir, torch.where(is_random, BIG, 0.0), torch.where(ok[:, None], dep, 0.0)


def advance(params, st: LoopState, hit, hr: HitRecord, sr, is_random, is_explicit, u_rr, acc,
            geom_len, opt_len, light_pdf_next) -> LoopState:
    """Throughput update, Russian roulette (wurblpt.hpp:258-273) and the next
    state; `light_pdf_next` is None in scenes without lights. The counters
    are left to the caller."""
    k = st.bounce
    ratio = torch.where(is_random[:, None],
                        sr.atten / torch.clamp_min(sr.pdf, 1e-12)[:, None], sr.atten)
    cont = is_random | is_explicit
    new_tp = st.throughput * ratio
    max_r = ratio.max(-1).values
    do_rr = (k >= params.rr_start) & (max_r < params.rr_threshold) & cont
    q = torch.clamp(1.0 - max_r, 0.0, 0.95)
    killed = do_rr & (u_rr < q)
    new_tp = torch.where((do_rr & ~killed)[:, None],
                         new_tp / torch.clamp_min(1.0 - q, 0.05)[:, None], new_tp)
    alive = cont & ~killed & (new_tp.max(-1).values > 0.0)
    return LoopState(
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
        prev_light_pdf=(st.prev_light_pdf if light_pdf_next is None
                        else torch.where(is_random, light_pdf_next, 0.0)),
        stats=st.stats,
    )


# ---------------------------------------------------------------------------
# Regeneration (integrator.py:973-1013)
# ---------------------------------------------------------------------------

def _recip(c) -> float:
    """float32(1) / float32(c): `x / c` for a Python number c as XLA and
    PyTorch's CUDA division evaluate it."""
    return float(np.float32(1.0) / np.float32(c))


def regen_plain(st: LoopState, sample, k_next, cam: CameraParams, cam_cfg: CameraConfig,
                lanes: BlockLanes, randomize: bool):
    """Plain version of wpt_regen_pinhole, for any camera: regenerate the
    dead lanes that have samples left with their pixel's next sample.

    Returns (state, sample, k_next, t_max): t_max [N] is the closest-hit
    cast's bound, BIG on active lanes and 0 elsewhere."""
    need = (~st.active) & (k_next < lanes.P) & lanes.valid
    s_new = lanes.j_lane + k_next * lanes.m          # global sample id in [0, spp)
    sample = torch.where(need, s_new, sample)
    if randomize:
        uj = uniform2(lanes.pixel, s_new, 0, Salt.PIXEL_JITTER)
        inv = _recip(lanes.ssqrt)
        jx = ((s_new % lanes.ssqrt).to(torch.float32) + uj[:, 0]) * inv
        jy = ((s_new // lanes.ssqrt).to(torch.float32) + uj[:, 1]) * inv
    else:
        jx = jy = torch.full(need.shape, 0.5, dtype=torch.float32, device=need.device)
    o, d = camera_rays(cam, cam_cfg, torch.stack([lanes.px + jx, lanes.py + jy], -1),
                       lanes.width, lanes.height)
    sel = need[:, None]
    active = st.active | need
    st = st._replace(
        bounce=torch.where(need, 0, st.bounce),
        o=torch.where(sel, o, st.o),
        d=torch.where(sel, d, st.d),
        ior=torch.where(sel, 1.0, st.ior),
        throughput=torch.where(sel, 1.0, st.throughput),
        active=active,
        geom_len=torch.where(need, 0.0, st.geom_len),
        opt_len=torch.where(sel, 0.0, st.opt_len),
        prev_pdf=torch.where(need, 0.0, st.prev_pdf),
        prev_random=st.prev_random & ~need,
        prev_light_pdf=torch.where(need, 0.0, st.prev_light_pdf),
    )
    return st, sample, k_next + need.to(torch.int64), torch.where(active, BIG, 0.0)


# ---------------------------------------------------------------------------
# The shades of the diffuse class (integrator.py:456-752 without the env
# sections) and of the env class (the same without light NEE)
# ---------------------------------------------------------------------------

class StepTables(NamedTuple):
    """Loop-invariant inputs of K4's shades. The plain versions read the
    scene's arrays (`scene`, `mat`, `pick_area`, `env`, `rgl`), the kernels
    the packed rows. The env class has no light: its light rows are empty."""

    scene: SceneArrays
    mat: torch.Tensor          # [M, 23] packed material rows (bsdf.pack_material_table)
    pick_area: torch.Tensor    # [P, 2] (pick probability, 1 / area) per prim (per-light MIS)
    light_tri: torch.Tensor    # [L, 9] f32 p0 | e1 | e2 of each hot spot, in pick order
    light_mat: torch.Tensor    # [L] int32 material of each hot spot
    light_w: torch.Tensor      # [L] f32 pick probability
    alias_prob: torch.Tensor   # [L] f32
    alias_idx: torch.Tensor    # [L] int32
    # The sky of the env and lit classes (None for the diffuse class): its
    # kind, the equirect image or the cube faces, the constant radiance, and
    # the importance tables when it has them (`env.importance`).
    env: Optional[EnvMapArrays]
    mat_types: frozenset
    n_lights: int
    per_light: bool
    # The RGL tables of a lit-class scene with RGL materials (else None).
    rgl: Optional[RGLTables] = None
    # A hot spot moves (SceneStatic.lights_animated): the light rows above
    # hold the hot spots where they are at the frame's instant, and
    # light_frames their forward frames (lights.light_frames), which the
    # plain versions apply per ray as the torch-op bounce does; both are set
    # per frame by `step_tables_at`.
    lights_animated: bool = False
    light_frames: Optional[tuple] = None


def build_step_tables(scene: SceneArrays, static: SceneStatic, mat, pick_area) -> StepTables:
    """The step tables of a scene of the diffuse, the env or the lit class,
    from its packed material rows `mat` and its per-light MIS rows
    `pick_area` (None with mixture MIS or without lights)."""
    dev = scene.device
    if pick_area is None:
        pick_area = torch.zeros((1, 2), dtype=torch.float32, device=dev)
    if static.n_lights == 0:
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        lights = (torch.zeros((0, 9), **f32), torch.zeros((0,), **i32),
                  torch.zeros((0,), **f32), torch.zeros((0,), **f32), torch.zeros((0,), **i32))
    else:
        lp = scene.light_prims.long()
        T = scene.tris
        lights = (torch.cat([T.p0[lp], T.e1[lp], T.e2[lp]], -1).contiguous(),
                  T.mat[lp].to(torch.int32).contiguous(), scene.light_weights.contiguous(),
                  scene.light_alias_prob.contiguous(),
                  scene.light_alias_idx.to(torch.int32).contiguous())
    lit = lit_scene(scene, static)
    return StepTables(scene, mat, pick_area, *lights,
                      env=scene.envmap if lit or env_scene(scene, static) else None,
                      mat_types=static.mat_types, n_lights=static.n_lights,
                      per_light=static.per_light_mis,
                      rgl=scene.rgl if lit and MaterialType.RGL in static.mat_types else None,
                      lights_animated=static.lights_animated)


def step_tables_at(tables: StepTables, light_frames) -> StepTables:
    """The step tables of one frame of an animated scene: with moving hot
    spots (`light_frames`, lights.light_frames at the frame's instant; None:
    the lights are static and the tables serve every frame), their light
    rows p0 | e1 | e2 in world space at that instant, each the product the
    plain versions form per ray, so that the shade reads the plain
    version's bits."""
    if light_frames is None:
        return tables
    p0, e1, e2 = light_tris(tables.scene, light_frames)
    return tables._replace(light_tri=torch.cat([p0, e1, e2], -1).contiguous(),
                           light_frames=light_frames)


def _check_light_frames(name, tables: StepTables):
    """Raise if the hot spots move and `tables` are not a frame's
    (`step_tables_at`): their light rows would be the rest poses."""
    if tables.lights_animated and tables.light_frames is None:
        raise ValueError(f"{name}: the scene's lights move; pass the frame's step tables "
                         "(step_tables_at)")


def shade_diffuse_plain(tables: StepTables, sensor, params, st: LoopState, pixel, sample, t,
                        prim, hr: HitRecord):
    """Plain version of wpt_shade_diffuse: one bounce of the diffuse class
    after the closest hit (t, prim) and its hit record `hr`.

    Returns (state, shadow origin [N, 3] (the hit position), shadow
    direction [N, 3], shadow t_max [N], pending deposit [N, n_acc]); the
    counters of st.stats grow in place by the closest casts (active lanes)
    and the shadow casts (RANDOM lanes)."""
    k = st.bounce
    hit = (prim >= 0) & st.active
    mrow = gather_material_rows(tables.mat, hr.mat)
    geom_len, opt_len = path_lengths(st, hit, t)
    acc = emit(sensor, st.acc, st, hr, mrow, t, prim, hit, geom_len, opt_len, tables.n_lights,
               tables.pick_area if tables.per_light else None)
    u4 = uniform4(pixel, sample, k, Salt.BSDF)
    u_aux = uniform4(pixel, sample, k, Salt.BSDF_AUX)
    sr = bsdf_sample(hr, st.d, st.ior, u4, u_aux[:, 0], u_aux[:, 1], mrow, tables.mat_types)
    is_random = hit & (sr.kind == ScatterKind.RANDOM) & (sr.pdf > 0.0)
    is_explicit = hit & (sr.kind == ScatterKind.EXPLICIT)
    u3 = uniform4(pixel, sample, k, Salt.NEE_SAMPLE)[:, :3]
    ldir, t_shadow, pending, light_pdf_next = light_nee(
        tables.scene, sensor, params, st, hr, mrow, tables.mat_types, None, sr.direction,
        is_random, geom_len, opt_len, u3, tables.mat, tables.per_light, tables.light_frames)
    new = advance(params, st, hit, hr, sr, is_random, is_explicit, u_aux[:, 2], acc, geom_len,
                  opt_len, light_pdf_next)
    n_closest = st.active.sum()
    st.stats.add_(torch.stack([n_closest, n_closest + is_random.sum()]))
    return new, hr.position, ldir, t_shadow, pending


def shade_env_plain(tables: StepTables, sensor, params, st: LoopState, pixel, sample, t, prim,
                    hr: HitRecord):
    """Plain version of wpt_shade_env: one bounce of the env class after the
    closest hit (t, prim) and its hit record `hr` (its tangent included).

    Returns (state, shadow origin [N, 3] (the hit position), shadow
    direction [N, 3], shadow t_max [N], pending deposit [N, n_acc]), the
    last four None when the sky has no importance tables (no lane casts a
    shadow ray); the counters of st.stats grow in place by the closest
    casts (active lanes) and the env shadow casts (RANDOM lanes, with
    importance tables)."""
    k = st.bounce
    hit = (prim >= 0) & st.active
    importance = tables.env.importance
    acc = env_miss(sensor, st.acc, st, tables.env, prim, importance)
    mrow = gather_material_rows(tables.mat, hr.mat)
    geom_len, opt_len = path_lengths(st, hit, t)
    acc = emit(sensor, acc, st, hr, mrow, t, prim, hit, geom_len, opt_len, 0, None)
    u4 = uniform4(pixel, sample, k, Salt.BSDF)
    u_aux = uniform4(pixel, sample, k, Salt.BSDF_AUX)
    sr = bsdf_sample(hr, st.d, st.ior, u4, u_aux[:, 0], u_aux[:, 1], mrow, tables.mat_types)
    is_random = hit & (sr.kind == ScatterKind.RANDOM) & (sr.pdf > 0.0)
    is_explicit = hit & (sr.kind == ScatterKind.EXPLICIT)
    origin = edir = t_shadow = pending = None
    if importance:
        origin = hr.position
        ue = uniform4(pixel, sample, k, Salt.ENVMAP_SAMPLE)[:, :3].contiguous()
        edir, t_shadow, pending = env_nee(sensor, tables.env, st, hr, mrow, tables.mat_types,
                                          None, ue, is_random, geom_len, opt_len)
    new = advance(params, st, hit, hr, sr, is_random, is_explicit, u_aux[:, 2], acc, geom_len,
                  opt_len, None)
    n_closest = st.active.sum()
    n_shadow = is_random.sum() if importance else torch.zeros_like(n_closest)
    st.stats.add_(torch.stack([n_closest, n_closest + n_shadow]))
    return new, origin, edir, t_shadow, pending


def shade_lit_plain(tables: StepTables, sensor, params, st: LoopState, pixel, sample, t, prim,
                    hr: HitRecord):
    """Plain version of wpt_shade_lit: one bounce of the lit class after the
    closest hit (t, prim) and its hit record `hr` (its geometric normal and
    tangent included), as the generic bounce takes it: the sky on a miss,
    emission with its per-light MIS weight, the bsdf sample, light NEE, env
    NEE, the roulette and the next state.

    Returns (state, shadow origins [2N, 3], shadow directions [2N, 3],
    shadow t_max [2N], pending deposits [2N, n_acc]): rows i the light's
    shadow ray of lane i, rows N + i its sky's. The counters of st.stats
    grow in place by the closest casts (active lanes) and two shadow casts
    per RANDOM lane."""
    k = st.bounce
    hit = (prim >= 0) & st.active
    acc = env_miss(sensor, st.acc, st, tables.env, prim, True)
    mrow = gather_material_rows(tables.mat, hr.mat)
    geom_len, opt_len = path_lengths(st, hit, t)
    acc = emit(sensor, acc, st, hr, mrow, t, prim, hit, geom_len, opt_len, tables.n_lights,
               tables.pick_area)
    u4 = uniform4(pixel, sample, k, Salt.BSDF)
    u_aux = uniform4(pixel, sample, k, Salt.BSDF_AUX)
    sr = bsdf_sample(hr, st.d, st.ior, u4, u_aux[:, 0], u_aux[:, 1], mrow, tables.mat_types,
                     rgl=tables.rgl)
    is_random = hit & (sr.kind == ScatterKind.RANDOM) & (sr.pdf > 0.0)
    is_explicit = hit & (sr.kind == ScatterKind.EXPLICIT)
    u3 = uniform4(pixel, sample, k, Salt.NEE_SAMPLE)[:, :3]
    ldir, t_light, pend_light, light_pdf_next = light_nee(
        tables.scene, sensor, params, st, hr, mrow, tables.mat_types, tables.rgl, sr.direction,
        is_random, geom_len, opt_len, u3, tables.mat, True)
    ue = uniform4(pixel, sample, k, Salt.ENVMAP_SAMPLE)[:, :3].contiguous()
    edir, t_env, pend_env = env_nee(sensor, tables.env, st, hr, mrow, tables.mat_types,
                                    tables.rgl, ue, is_random, geom_len, opt_len)
    new = advance(params, st, hit, hr, sr, is_random, is_explicit, u_aux[:, 2], acc, geom_len,
                  opt_len, light_pdf_next)
    n_closest = st.active.sum()
    st.stats.add_(torch.stack([n_closest, n_closest + 2 * is_random.sum()]))
    return (new, torch.cat([hr.position, hr.position]), torch.cat([ldir, edir]),
            torch.cat([t_light, t_env]), torch.cat([pend_light, pend_env]))


def nee_resolve_plain(acc, pending, occluded, active, k_next, lanes: BlockLanes):
    """Plain version of wpt_nee_resolve: acc + pending where the shadow ray is
    not occluded, and whether any lane of the block has work left (an active
    path, or samples to start): the wavefront loop's condition. A step that
    casts no shadow ray passes no pending deposit (None) and gets acc back;
    the lit class passes two per lane (pending [2N, n_acc], occluded [2N]:
    the light's rows first), added in that order, as the generic bounce
    adds its light deposit before its sky's.

    Returns (acc, work [1] int32)."""
    if pending is not None:
        n = acc.shape[0]
        for q in range(pending.shape[0] // n):
            acc = deposit_unoccluded(acc, pending[q * n:(q + 1) * n], occluded[q * n:(q + 1) * n])
    work = active.any() | ((k_next < lanes.P) & lanes.valid).any()
    return acc, work.to(torch.int32).reshape(1)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

# The fields of struct WaveState in wavefront.cu, in its order: the lane
# state's tensors (LoopState but its counters), the sample id and the next
# sample index of each lane.
_WAVE_STATE = (*(f for f in LoopState._fields if f != "stats"), "sample", "k_next")


class _StateC(ctypes.Structure):
    """The lane state's device pointers (struct WaveState of wavefront.cu)."""

    _fields_ = [(name, ctypes.c_void_p) for name in _WAVE_STATE]


# dtype and per-lane shape of each LoopState field the kernels take but acc
# ([N, n_acc]) and stats ([2] int64).
_STATE_TYPES = dict(bounce=(torch.int64, ()), o=(torch.float32, (3,)), d=(torch.float32, (3,)),
                    ior=(torch.float32, (4,)), throughput=(torch.float32, (4,)),
                    active=(torch.bool, ()), geom_len=(torch.float32, ()),
                    opt_len=(torch.float32, (4,)), prev_pdf=(torch.float32, ()),
                    prev_random=(torch.bool, ()), prev_light_pdf=(torch.float32, ()))


def _check_state(name, st: LoopState, sample, k_next, n_acc):
    n = st.active.shape[0]
    dev = st.active.device
    for f, (dtype, tail) in _STATE_TYPES.items():
        x = getattr(st, f)
        if x.dtype != dtype or tuple(x.shape) != (n, *tail) or not x.is_contiguous():
            raise ValueError(f"{name}: state.{f} needs contiguous {dtype} {(n, *tail)}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    for f, x, dtype, shape in (("acc", st.acc, torch.float32, (n, n_acc)),
                               ("sample", sample, torch.int64, (n,)),
                               ("k_next", k_next, torch.int64, (n,)),
                               ("stats", st.stats, torch.int64, (2,))):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: {f} needs contiguous {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    for x in (*st, sample, k_next):
        if x.device != dev:
            raise ValueError(f"{name}: state tensors on {x.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return n, dev


def _state_c(st: LoopState, sample, k_next) -> _StateC:
    fields = st._asdict() | {"sample": sample, "k_next": k_next}
    return _StateC(*(fields[f].data_ptr() for f in _WAVE_STATE))


def _check_in_place(name, st: LoopState):
    """Raise unless the 4-wide fields the in-place kernels store 16 bytes at
    a time (ior, throughput, opt_len) start on a 16-byte boundary."""
    for f in ("ior", "throughput", "opt_len"):
        if getattr(st, f).data_ptr() % 16:
            raise ValueError(f"{name}: state.{f} must start on a 16-byte boundary")


def _copy_into(st: LoopState, new: LoopState) -> LoopState:
    """Write the plain version's state `new` into the tensors of `st` (the
    counters excepted, which the plain shades grow in place); returns st."""
    for f in LoopState._fields:
        dst, src = getattr(st, f), getattr(new, f)
        if f != "stats" and dst is not src:
            dst.copy_(src)
    return st


def _empty_state(st: LoopState, **keep) -> LoopState:
    """New output tensors for every field, but those given in `keep`."""
    return LoopState(**{f: keep[f] if f in keep else torch.empty_like(getattr(st, f))
                        for f in LoopState._fields})


def _camera_ptrs(cam: CameraParams, device):
    """Device pointers of the camera's centre [2], focal length [2], translation
    [3], rotation [4] and lens coefficients k [6] and p [2]: float32 tensors
    on `device`."""
    tf = cam.transformation
    parts = (cam.center_px, cam.focal_px, tf.translation, tf.rotation, cam.dist_k, cam.dist_p)
    for x, numel in zip(parts, (2, 2, 3, 4, 6, 2)):
        if (x.dtype != torch.float32 or x.numel() != numel or not x.is_contiguous()
                or x.device != device):
            raise ValueError(f"regen_pinhole: camera tensors need contiguous float32 on "
                             f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    return [x.data_ptr() for x in parts]


def _regen_on_cpu(st: LoopState, sample, k_next, cam, cam_cfg, lanes, randomize):
    """regen_plain, its result copied into the inputs (the kernels' contract)."""
    new, new_sample, new_k, t_max = regen_plain(st, sample, k_next, cam, cam_cfg, lanes,
                                                randomize)
    sample.copy_(new_sample)
    k_next.copy_(new_k)
    return _copy_into(st, new), sample, k_next, t_max


def regen_pinhole(st: LoopState, sample, k_next, cam: CameraParams, cam_cfg: CameraConfig,
                  lanes: BlockLanes, randomize: bool):
    """Regenerate dead lanes in place (wpt_regen_pinhole; `regen_plain` on
    CPU tensors, its result copied into the inputs): (st, sample, k_next,
    t_max), the first three the tensors given. The kernel takes a mono
    pinhole camera with or without a lens model (`_pinhole`)."""
    n, dev = _check_state("regen_pinhole", st, sample, k_next, st.acc.shape[1])
    if dev.type == "cpu":
        return _regen_on_cpu(st, sample, k_next, cam, cam_cfg, lanes, randomize)
    if not _pinhole(cam_cfg):
        raise ValueError("regen_pinhole: the kernel takes a mono pinhole camera (a lens model "
                         "allowed), no surround, stereo, depth of field or animation")
    if n != lanes.B * lanes.m:
        raise ValueError(f"regen_pinhole: {n} lanes, the block has {lanes.B * lanes.m}")
    _check_in_place("regen_pinhole", st)
    lib = native.load_kernels()
    t_max = torch.empty((n,), dtype=torch.float32, device=dev)
    args, keep = regen_args(st, sample, k_next, cam, cam_cfg, lanes, randomize, t_max)
    code = lib.wpt_regen_pinhole(*args, native.stream_ptr(t_max))
    del keep
    native.check(code, "regen_pinhole")
    native.LAUNCHES["regen_pinhole"] += 1
    return st, sample, k_next, t_max


def _surround_camera(cam: CameraParams, cam_cfg: CameraConfig, width: int, height: int, device):
    """The surround camera's arguments of wpt_regen_surround: the device
    pointers of its translation [3], rotation [4], scale [3] and eye
    distance [1] (float32 tensors on `device`), then the span, float32(1) /
    width and float32(1) / the height of one eye's half (the factors
    camera_rays multiplies by) and the stereo flag."""
    tf = cam.transformation
    parts = (tf.translation, tf.rotation, tf.scale, cam.eye_distance)
    for x, numel in zip(parts, (3, 4, 3, 1)):
        if (x.dtype != torch.float32 or x.numel() != numel or not x.is_contiguous()
                or x.device != device):
            raise ValueError(f"regen_surround: camera tensors need contiguous float32 on "
                             f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    span = math.pi if cam_cfg.surround == SurroundMode.S360 else math.pi / 2.0
    eff_height = height // 2 if cam_cfg.stereo else height
    return ([x.data_ptr() for x in parts]
            + [float(np.float32(span)), _recip(width), _recip(eff_height), int(cam_cfg.stereo)])


def regen_surround(st: LoopState, sample, k_next, cam: CameraParams, cam_cfg: CameraConfig,
                   lanes: BlockLanes, randomize: bool):
    """Regenerate dead lanes in place through a surround camera, mono or
    stereo (wpt_regen_surround; `regen_plain` on CPU tensors, its result
    copied into the inputs): (st, sample, k_next, t_max), the first three
    the tensors given."""
    n, dev = _check_state("regen_surround", st, sample, k_next, st.acc.shape[1])
    if dev.type == "cpu":
        return _regen_on_cpu(st, sample, k_next, cam, cam_cfg, lanes, randomize)
    if not _surround(cam_cfg):
        raise ValueError("regen_surround: the kernel takes a surround camera, mono or stereo, "
                         "without depth of field or animation")
    if n != lanes.B * lanes.m:
        raise ValueError(f"regen_surround: {n} lanes, the block has {lanes.B * lanes.m}")
    _check_in_place("regen_surround", st)
    lib = native.load_kernels()
    t_max = torch.empty((n,), dtype=torch.float32, device=dev)
    args, keep = regen_args(st, sample, k_next, cam, cam_cfg, lanes, randomize, t_max)
    code = lib.wpt_regen_surround(*args, native.stream_ptr(t_max))
    del keep
    native.check(code, "regen_surround")
    native.LAUNCHES["regen_surround"] += 1
    return st, sample, k_next, t_max


def regen_args(st: LoopState, sample, k_next, cam: CameraParams, cam_cfg: CameraConfig,
               lanes: BlockLanes, randomize: bool, t_max):
    """The arguments of wpt_regen_surround (a surround camera) or
    wpt_regen_pinhole but their stream, and the ctypes object they point
    into, which must live until the call returns."""
    dev = st.active.device
    s_c = _state_c(st, sample, k_next)
    if _surround(cam_cfg):
        camera = _surround_camera(cam, cam_cfg, lanes.width, lanes.height, dev)
    else:
        camera = _camera_ptrs(cam, dev) + [cam_cfg.distortion, cam_cfg.undistort_iters]
    args = [ctypes.addressof(s_c), t_max.data_ptr(), st.active.shape[0], *camera, lanes.blk,
            lanes.B, lanes.m, lanes.P, lanes.n_pix, lanes.width, lanes.height, lanes.ssqrt,
            int(randomize)]
    return args, s_c


_RGB, _TOF = 0, 1


def sensor_params(sensor):
    """(kind, [8] float32 numbers) of a sensor for the shade kernel: the
    window bounds of SensorRGB; float32(2 pi), float32(f / c), float32(tau),
    the contrast and the four factors from irradiance to energy of
    SensorTofAmcw, each the float32 value PyTorch multiplies by."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    if isinstance(sensor, SensorRGB):
        return _RGB, [f32(sensor.opl_min), f32(sensor.opl_max), f32(sensor.dtl_min),
                      f32(sensor.dtl_max), 0.0, 0.0, 0.0, 0.0]
    if isinstance(sensor, SensorTofAmcw):
        from ..core.constants import SPEED_OF_LIGHT

        return _TOF, [f32(2.0 * math.pi), f32(sensor.modulation_frequency / SPEED_OF_LIGHT),
                      f32(sensor.phase_index * (math.pi / 2.0)), f32(sensor.contrast),
                      f32(sensor.pixel_area), f32(sensor.aperture_factor),
                      f32(sensor.exposure_time), f32(sensor.duty_cycle)]
    raise ValueError(f"K4 shade: no kernel for sensor {type(sensor).__name__}")


def _check_hit(name, n, dev, pixel, t, prim, hr: HitRecord, fields):
    """Raise unless the closest hit's tensors and the hit record's `fields`
    are contiguous, of the kernel's dtype and shape, on `dev`."""
    shapes = dict(position=(torch.float32, (n, 3)), normal=(torch.float32, (n, 3)),
                  geom_normal=(torch.float32, (n, 3)), tangent=(torch.float32, (n, 3)),
                  backside=(torch.bool, (n,)), mat=(torch.int32, (n,)))
    for f, x, dtype, shape in (("pixel", pixel, torch.int64, (n,)),
                               ("t", t, torch.float32, (n,)), ("prim", prim, torch.int32, (n,)),
                               *((f, getattr(hr, f), *shapes[f]) for f in fields)):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name}: {f} needs contiguous {dtype} {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def shade_diffuse(tables: StepTables, sensor, params, st: LoopState, pixel, sample, t, prim,
                  hr: HitRecord):
    """One diffuse-class bounce after the closest hit (wpt_shade_diffuse;
    `shade_diffuse_plain` on CPU tensors): (state, shadow origin (the hit
    position), shadow direction, shadow t_max, pending deposit); st.stats
    grows in place."""
    n, dev = _check_state("shade_diffuse", st, sample, sample, sensor.n_acc)
    _check_hit("shade_diffuse", n, dev, pixel, t, prim, hr,
               ("position", "normal", "geom_normal", "backside", "mat"))
    _check_light_frames("shade_diffuse", tables)
    if dev.type == "cpu":
        return shade_diffuse_plain(tables, sensor, params, st, pixel, sample, t, prim, hr)
    if not tables.mat_types <= DIFFUSE_MATERIALS or tables.n_lights == 0:
        raise ValueError("shade_diffuse: the kernel takes the diffuse class only")
    kind, sp = sensor_params(sensor)
    lib = native.load_kernels()
    out = _empty_state(st, ior=st.ior, stats=st.stats)
    shadow_d = torch.empty((n, 3), dtype=torch.float32, device=dev)
    shadow_tmax = torch.empty((n,), dtype=torch.float32, device=dev)
    pending = torch.empty((n, sensor.n_acc), dtype=torch.float32, device=dev)
    s_in, s_out = _state_c(st, sample, sample), _state_c(out, sample, sample)
    sp_c = (ctypes.c_float * 8)(*sp)
    code = lib.wpt_shade_diffuse(
        ctypes.addressof(s_in), ctypes.addressof(s_out), st.stats.data_ptr(), n,
        pixel.data_ptr(), t.data_ptr(), prim.data_ptr(), hr.position.data_ptr(),
        hr.normal.data_ptr(), hr.geom_normal.data_ptr(), hr.backside.data_ptr(),
        hr.mat.data_ptr(), tables.mat.data_ptr(), tables.mat.shape[0],
        tables.pick_area.data_ptr(), tables.pick_area.shape[0], tables.light_tri.data_ptr(),
        tables.light_mat.data_ptr(), tables.light_w.data_ptr(), tables.alias_prob.data_ptr(),
        tables.alias_idx.data_ptr(), tables.n_lights, int(tables.per_light), kind,
        ctypes.addressof(sp_c), params.max_path_components, params.rr_start,
        float(params.rr_threshold), float(np.float32(1.0 - params.shadow_identity_eps)),
        float(params.min_hit_distance), shadow_d.data_ptr(), shadow_tmax.data_ptr(),
        pending.data_ptr(), native.stream_ptr(t))
    native.check(code, "shade_diffuse")
    native.LAUNCHES["shade_diffuse"] += 1
    return out, hr.position, shadow_d, shadow_tmax, pending


def _check_env(env: Optional[EnvMapArrays], dev):
    """Raise unless `env` is a sky the kernel takes (an equirect sky with
    importance tables, a cube sky with or without them, a constant sky
    without them) whose arrays are contiguous float32 (int32 alias indices)
    on `dev`."""
    if env is None or not ((env.kind == 1 and env.importance) or env.kind == 2
                           or (env.kind == 3 and not env.importance)):
        raise ValueError("shade_env: the kernel takes an equirect sky with importance tables, "
                         "a cube sky or a constant sky, got "
                         f"{'none' if env is None else f'kind {env.kind}'}")
    _check_env_arrays("shade_env", env, dev)


def _check_env_arrays(name, env: EnvMapArrays, dev):
    res = env.pdf_table.shape[0]
    img = {1: (*env.image.shape[:2], 4), 2: (6, *env.image.shape[1:3], 4), 3: (1, 1, 4)}[env.kind]
    for f, x, dtype, shape in (("image", env.image, torch.float32, img),
                               ("const_radiance", env.const_radiance, torch.float32, (4,)),
                               ("pdf_table", env.pdf_table, torch.float32, (res, res)),
                               ("alias_prob", env.alias_prob, torch.float32, (res * res,)),
                               ("alias_idx", env.alias_idx, torch.int32, (res * res,)),
                               ("rotation", env.rotation, torch.float32, (4,))):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name}: env.{f} needs contiguous {dtype} {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def shade_env(tables: StepTables, sensor, params, st: LoopState, pixel, sample, t, prim,
              hr: HitRecord):
    """One env-class bounce after the closest hit (wpt_shade_env;
    `shade_env_plain` on CPU tensors): (state, shadow origin (the hit
    position), shadow direction, shadow t_max, pending deposit), the last
    four None when the sky has no importance tables; st.stats grows in
    place. The kernel takes Lambertian, GGX, mirror and glass surfaces, an
    equirect sky with importance tables, a cube sky with or without them or
    a constant sky, and no light."""
    n, dev = _check_state("shade_env", st, sample, sample, sensor.n_acc)
    _check_hit("shade_env", n, dev, pixel, t, prim, hr,
               ("position", "normal", "tangent", "backside", "mat"))
    if tables.n_lights != 0 or not tables.mat_types <= ENV_MATERIALS:
        raise ValueError("shade_env: the kernel takes Lambertian, GGX, mirror and glass surfaces "
                         "and no light")
    if tables.scene.has_bvh and tables.scene.n_spheres > 0:
        raise ValueError("shade_env: spheres in a BVH scene (the BVH holds triangles only)")
    _check_env(tables.env, dev)
    if dev.type == "cpu":
        return shade_env_plain(tables, sensor, params, st, pixel, sample, t, prim, hr)
    kind, sp = sensor_params(sensor)
    env = tables.env
    glass = MaterialType.GLASS in tables.mat_types
    lib = native.load_kernels()
    # Without glass the ray IOR never changes: the next state shares it.
    out = _empty_state(st, prev_light_pdf=st.prev_light_pdf, stats=st.stats,
                       **({} if glass else {"ior": st.ior}))
    shadow_o = shadow_d = shadow_tmax = pending = None
    if env.importance:
        shadow_o = hr.position
        shadow_d = torch.empty((n, 3), dtype=torch.float32, device=dev)
        shadow_tmax = torch.empty((n,), dtype=torch.float32, device=dev)
        pending = torch.empty((n, sensor.n_acc), dtype=torch.float32, device=dev)
    s_in, s_out = _state_c(st, sample, sample), _state_c(out, sample, sample)
    sp_c = (ctypes.c_float * 8)(*sp)
    code = lib.wpt_shade_env(
        ctypes.addressof(s_in), ctypes.addressof(s_out), st.stats.data_ptr(), n,
        pixel.data_ptr(), t.data_ptr(), prim.data_ptr(), hr.position.data_ptr(),
        hr.normal.data_ptr(), hr.tangent.data_ptr(), hr.backside.data_ptr(), hr.mat.data_ptr(),
        tables.mat.data_ptr(), tables.mat.shape[0], int(glass), env.kind, env.image.data_ptr(),
        env.image.shape[-3], env.image.shape[-2], env.const_radiance.data_ptr(),
        env.pdf_table.data_ptr(), env.alias_prob.data_ptr(), env.alias_idx.data_ptr(),
        env.pdf_table.shape[0], env.rotation.data_ptr(), kind, ctypes.addressof(sp_c),
        params.max_path_components, params.rr_start, float(params.rr_threshold),
        _ptr(shadow_d), _ptr(shadow_tmax), _ptr(pending), native.stream_ptr(t))
    native.check(code, "shade_env")
    native.LAUNCHES["shade_env"] += 1
    return out, shadow_o, shadow_d, shadow_tmax, pending


def _check_lit_tables(tables: StepTables, dev):
    """Raise unless `tables` are of the lit class and lie on `dev`: light
    rows with per-light MIS, an equirect or cube sky with importance
    tables, RGL tables where RGL materials are."""
    if (tables.n_lights == 0 or not tables.per_light
            or not tables.mat_types <= LIT_MATERIALS):
        raise ValueError("shade_lit: the kernel takes Lambertian, GGX, mirror, glass, ModPhong "
                         "and RGL surfaces with triangle lights under per-light MIS")
    if tables.scene.has_bvh and tables.scene.n_spheres > 0:
        raise ValueError("shade_lit: spheres in a BVH scene (the BVH holds triangles only)")
    env = tables.env
    if env is None or env.kind not in (1, 2) or not env.importance:
        raise ValueError("shade_lit: the kernel takes an equirect or cube sky with importance "
                         f"tables, got {'none' if env is None else f'kind {env.kind}'}"
                         f"{'' if env is None or env.importance else ' without them'}")
    _check_env_arrays("shade_lit", env, dev)
    nl, npick = tables.n_lights, tables.pick_area.shape[0]
    for f, dtype, shape in (("mat", torch.float32, (tables.mat.shape[0], 23)),
                            ("pick_area", torch.float32, (npick, 2)),
                            ("light_tri", torch.float32, (nl, 9)),
                            ("light_mat", torch.int32, (nl,)), ("light_w", torch.float32, (nl,)),
                            ("alias_prob", torch.float32, (nl,)),
                            ("alias_idx", torch.int32, (nl,))):
        x = getattr(tables, f)
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"shade_lit: tables.{f} needs contiguous {dtype} {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if (MaterialType.RGL in tables.mat_types) != (tables.rgl is not None):
        raise ValueError("shade_lit: RGL tables go with RGL materials")
    if tables.rgl is not None and tables.rgl.device != dev:
        raise ValueError(f"shade_lit: RGL tables on {tables.rgl.device}, lanes on {dev}")


# (device, stream) -> the lit shade's lane counter, which its launch zeroes
# on the stream (a memset beside the kernel).
_LIT_COUNTER = {}


def shade_lit(tables: StepTables, sensor, params, st: LoopState, pixel, sample, t, prim,
              hr: HitRecord):
    """One lit-class bounce after the closest hit, in place (wpt_shade_lit;
    `shade_lit_plain` on CPU tensors, its state copied into st): (st, shadow
    origins [2N, 3], shadow directions [2N, 3], shadow t_max [2N], pending
    deposits [2N, n_acc]), the light's shadow rays in rows 0..N-1, the sky's
    in rows N..2N-1; st.stats grows in place. The kernel writes a shadow
    row's origin and direction only where it casts (t_max > 0). It takes
    Lambertian, GGX, mirror, glass, ModPhong and RGL surfaces, triangle
    lights under per-light MIS and an equirect or cube sky with importance
    tables."""
    n, dev = _check_state("shade_lit", st, sample, sample, sensor.n_acc)
    _check_hit("shade_lit", n, dev, pixel, t, prim, hr,
               ("position", "normal", "geom_normal", "tangent", "backside", "mat"))
    _check_lit_tables(tables, dev)
    if dev.type == "cpu":
        new, *rows = shade_lit_plain(tables, sensor, params, st, pixel, sample, t, prim, hr)
        return (_copy_into(st, new), *rows)
    _check_in_place("shade_lit", st)
    lib = native.load_kernels()
    f32 = dict(dtype=torch.float32, device=dev)
    rows = (torch.empty((2 * n, 3), **f32), torch.empty((2 * n, 3), **f32),
            torch.empty((2 * n,), **f32), torch.empty((2 * n, sensor.n_acc), **f32))
    stream = native.stream_ptr(t)
    counter = _LIT_COUNTER.get((dev, stream))
    if counter is None:
        counter = _LIT_COUNTER[(dev, stream)] = torch.empty((1,), dtype=torch.int32, device=dev)
    args, keep = lit_args(tables, sensor, params, st, pixel, sample, t, prim, hr, *rows)
    code = lib.wpt_shade_lit(*args, counter.data_ptr(), stream)
    del keep
    native.check(code, "shade_lit")
    native.LAUNCHES["shade_lit"] += 1
    return (st, *rows)


def lit_args(tables: StepTables, sensor, params, st: LoopState, pixel, sample, t, prim,
             hr: HitRecord, shadow_o, shadow_d, shadow_tmax, pending):
    """The arguments of wpt_shade_lit up to its pending deposits (its lane
    counter and stream follow), and the ctypes objects they point into,
    which must live until the call returns."""
    kind, sp = sensor_params(sensor)
    env = tables.env
    s_c = _state_c(st, sample, sample)
    sp_c = (ctypes.c_float * 8)(*sp)
    rgl_c = None if tables.rgl is None else c_tables(tables.rgl)
    args = [
        ctypes.addressof(s_c), st.stats.data_ptr(), st.active.shape[0],
        pixel.data_ptr(), t.data_ptr(), prim.data_ptr(), hr.position.data_ptr(),
        hr.normal.data_ptr(), hr.geom_normal.data_ptr(), hr.tangent.data_ptr(),
        hr.backside.data_ptr(), hr.mat.data_ptr(), tables.mat.data_ptr(), tables.mat.shape[0],
        tables.pick_area.data_ptr(), tables.pick_area.shape[0], tables.light_tri.data_ptr(),
        tables.light_mat.data_ptr(), tables.light_w.data_ptr(), tables.alias_prob.data_ptr(),
        tables.alias_idx.data_ptr(), tables.n_lights, env.kind, env.image.data_ptr(),
        env.image.shape[-3], env.image.shape[-2], env.pdf_table.data_ptr(),
        env.alias_prob.data_ptr(), env.alias_idx.data_ptr(), env.pdf_table.shape[0],
        env.rotation.data_ptr(), None if rgl_c is None else ctypes.addressof(rgl_c), kind,
        ctypes.addressof(sp_c), params.max_path_components, params.rr_start,
        float(params.rr_threshold), float(np.float32(1.0 - params.shadow_identity_eps)),
        float(params.min_hit_distance), shadow_o.data_ptr(), shadow_d.data_ptr(),
        shadow_tmax.data_ptr(), pending.data_ptr()]
    return args, (s_c, sp_c, rgl_c)


def _ptr(x: Optional[torch.Tensor]):
    """A tensor's device pointer, or None (NULL) for no tensor."""
    return None if x is None else x.data_ptr()


def nee_resolve(acc, pending, occluded, active, k_next, lanes: BlockLanes):
    """acc + pending where the shadow ray is not occluded, and the loop
    condition (wpt_nee_resolve; `nee_resolve_plain` on CPU tensors). A step
    without shadow rays passes pending and occluded as None: the loop
    condition alone, acc returned as it is; the lit class passes two
    pending deposits per lane ([2N, n_acc] and [2N], the light's first)."""
    n, c = acc.shape
    if (pending is None) != (occluded is None):
        raise ValueError("nee_resolve: pending and occluded go together")
    n_pend = 0 if pending is None else (2 if pending.shape[0] == 2 * n > 0 else 1)
    deposits = (() if pending is None else
                (("pending", pending, torch.float32, (n_pend * n, c)),
                 ("occluded", occluded, torch.bool, (n_pend * n,))))
    for name, x, dtype, shape in (("acc", acc, torch.float32, (n, c)), *deposits,
                                  ("active", active, torch.bool, (n,)),
                                  ("k_next", k_next, torch.int64, (n,))):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"nee_resolve: {name} needs contiguous {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != acc.device:
            raise ValueError(f"nee_resolve: {name} on {x.device}, acc on {acc.device}")
    if acc.device.type == "cpu":
        return nee_resolve_plain(acc, pending, occluded, active, k_next, lanes)
    if acc.device.type != "cuda":
        raise ValueError(f"nee_resolve: no kernel for device {acc.device}")
    lib = native.load_kernels()
    out = acc if pending is None else torch.empty_like(acc)
    work = torch.empty((1,), dtype=torch.int32, device=acc.device)
    code = lib.wpt_nee_resolve(acc.data_ptr(), _ptr(pending), _ptr(occluded), n_pend,
                               active.data_ptr(), k_next.data_ptr(), n, c, lanes.blk, lanes.B,
                               lanes.P, lanes.n_pix, out.data_ptr(), work.data_ptr(),
                               native.stream_ptr(acc))
    native.check(code, "nee_resolve")
    native.LAUNCHES["nee_resolve"] += 1
    return out, work


class K4Route(NamedTuple):
    """The kernels of one K4 step (`k4_route`)."""

    regen: Callable         # regen_pinhole or regen_surround
    shade: Callable         # shade_diffuse, shade_env or shade_lit
    shade_plain: Callable   # its plain version
    shadow_rows: int        # shadow rays per lane: 1, or the lit class's 2 (light, sky)


def k4_route(tables: StepTables, cam_cfg: CameraConfig) -> K4Route:
    """The regeneration, the shade and the shadow rows per lane of a K4
    step on a scene's step tables seen through `cam_cfg`: the class follows
    from the tables (no sky: diffuse; a sky and no light: env; both: lit),
    the regeneration from the camera. Every shade returns (state, shadow
    origins, directions, t_max, pending deposits)."""
    regen = regen_surround if _surround(cam_cfg) else regen_pinhole
    if tables.env is None:
        return K4Route(regen, shade_diffuse, shade_diffuse_plain, 1)
    if tables.n_lights == 0:
        return K4Route(regen, shade_env, shade_env_plain, 1)
    return K4Route(regen, shade_lit, shade_lit_plain, 2)
