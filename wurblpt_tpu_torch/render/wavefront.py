"""K4: one wavefront step of the diffuse class as hand-written kernels.

Port of the JAX package's bounce body (``wurblpt_tpu/render/integrator.py``
:400-752, `_make_bounce_fn`) and its regeneration (:973-1013) for the
scenes of the diffuse class (`diffuse_class`): Lambertian surfaces;
diffuse, spot and ToF triangle lights with mixture or per-light MIS; no
sky; a pinhole camera without lens distortion. One step is

    wpt_regen_pinhole  refill dead lanes with their pixel's next sample
    K1 closest hit, K3 hit assembly
    wpt_shade_diffuse  emission with its MIS weight, the Lambertian sample,
                       light NEE (the shadow ray and its pending deposit),
                       Russian roulette, the next state, the cast counters
    K2 any hit         the shadow rays
    wpt_nee_resolve    add the pending deposits of unoccluded lanes; flag
                       whether any lane still has work (the loop condition)

`regen_pinhole`, `shade_diffuse` and `nee_resolve` launch the kernels of
``csrc/wavefront.cu`` on CUDA tensors and run their plain versions
(`regen_plain`, `shade_diffuse_plain`, `nee_resolve_plain`) on CPU tensors.
The plain versions are built from the helpers of the generic torch-op bounce
(`emit`, `light_nee`, `advance`, here), which keeps serving the scenes
outside the diffuse class, so both routes compute the same thing in the
same order.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..core.rng import Salt, uniform2, uniform4
from ..core.sampler import power_heuristic
from ..core.vecmath import cross, dot
from ..scene.ir import MaterialFlags, MaterialType, SceneArrays
from .bsdf import (
    LIGHT_MATERIALS,
    ScatterKind,
    SceneStatic,
    bsdf_eval,
    bsdf_sample,
    emitted,
    gather_material_rows,
)
from .camera import CameraConfig, CameraParams, DistortionModel, SurroundMode, camera_rays
from .intersect import HitRecord
from .intersect_brute import BIG
from .lights import (
    light_pick_prob_of,
    lights_pdf_at_hit,
    lights_pdf_multi,
    lights_sample,
)
from .sensor import SensorEvent, SensorRGB, SensorTofAmcw

DIFFUSE_MATERIALS = frozenset({MaterialType.LAMBERTIAN}) | LIGHT_MATERIALS

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
    texture, animation or medium, the brute-force intersector."""
    return (static.mat_types <= DIFFUSE_MATERIALS and static.n_lights > 0
            and not (static.has_textures or static.has_anim or static.has_media
                     or static.has_bvh or static.sphere_lights)
            and static.env_kind == 0 and scene.light_alias_prob is not None
            and scene.light_weights is not None)


def diffuse_class(scene: SceneArrays, static: SceneStatic, cam_cfg: CameraConfig) -> bool:
    """Whether a scene and camera take K4 (the route is decided once per render):
    a scene of the diffuse class (`diffuse_scene`) seen by a pinhole camera
    without distortion."""
    return (diffuse_scene(scene, static)
            and cam_cfg.surround == SurroundMode.OFF and not cam_cfg.stereo
            and cam_cfg.distortion == DistortionModel.NONE and not cam_cfg.dof
            and cam_cfg.anim_id < 0)


# ---------------------------------------------------------------------------
# Pieces of the torch-op bounce, shared by the generic bounce and the plain versions
# ---------------------------------------------------------------------------

def light_emitted_at(scene: SceneArrays, prim, toward, mat_packed):
    """Emitted radiance of triangle light `prim` toward unit direction `toward`
    (from the light to the receiver); one-sided unless the material is
    two-sided, and a spot or ToF light only inside its cone, |cos| >= p0.x
    (the JAX package's integrator.py:241-250)."""
    T = scene.tris
    pl = prim.long()
    fn = cross(T.e1[pl], T.e2[pl])
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
              rgl, sr_direction, is_random, geom_len, opt_len, u3, mat_packed, per_light: bool):
    """NEE toward a picked hot spot (wurblpt.hpp:179-220), up to its shadow ray.

    Returns (shadow direction [N, 3], shadow t_max [N]: the light's distance
    shortened by `shadow_identity_eps` on RANDOM lanes, 0 elsewhere, the
    pending deposit [N, n_acc]: what the sensor takes if the shadow ray is
    not occluded, 0 on lanes that deposit nothing, and the light-mixture pdf
    of the bsdf sample for the next bounce's emission weight)."""
    ldir, lprim, ldist, lpick, pdf_sa = lights_sample(scene, hr.position, u3)
    if per_light:
        # The NEE strategy "pick light i, sample its solid angle" has density
        # pick(i) x pdf_i; the emitted side is weighted at the next hit.
        pdf_light = light_pick_prob_of(scene, lpick) * pdf_sa
        light_pdf_next = torch.zeros_like(pdf_sa)
    else:
        # One mixture evaluation for both directions that need it: the NEE
        # direction now, the bsdf sample at the next bounce.
        pdf_pair = lights_pdf_multi(scene, hr.position, torch.stack([ldir, sr_direction], 1))
        pdf_light, light_pdf_next = pdf_pair[:, 0], pdf_pair[:, 1]
    f_l, pdf_b = bsdf_eval(hr, st.d, ldir, mrow, mat_types, rgl=rgl)
    t_vis = torch.clamp_min(ldist * (1.0 - params.shadow_identity_eps), params.min_hit_distance)
    Le = light_emitted_at(scene, torch.clamp_min(lprim, 0), -ldir, mat_packed)
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
# The diffuse-class shade (integrator.py:456-752 without the env sections)
# ---------------------------------------------------------------------------

class StepTables(NamedTuple):
    """Loop-invariant inputs of the diffuse-class shade. The plain version
    reads the scene's arrays (`scene`, `mat`, `pick_area`), the kernel the
    packed rows."""

    scene: SceneArrays
    mat: torch.Tensor          # [M, 23] packed material rows (bsdf.pack_material_table)
    pick_area: torch.Tensor    # [P, 2] (pick probability, 1 / area) per prim (per-light MIS)
    light_tri: torch.Tensor    # [L, 9] f32 p0 | e1 | e2 of each hot spot, in pick order
    light_mat: torch.Tensor    # [L] int32 material of each hot spot
    light_w: torch.Tensor      # [L] f32 pick probability
    alias_prob: torch.Tensor   # [L] f32
    alias_idx: torch.Tensor    # [L] int32
    mat_types: frozenset
    n_lights: int
    per_light: bool


def build_step_tables(scene: SceneArrays, static: SceneStatic, mat, pick_area) -> StepTables:
    """The step tables of a scene of the diffuse class, from its packed
    material rows `mat` and its per-light MIS rows `pick_area` (None with
    mixture MIS)."""
    lp = scene.light_prims.long()
    T = scene.tris
    if pick_area is None:
        pick_area = torch.zeros((1, 2), dtype=torch.float32, device=scene.device)
    return StepTables(
        scene=scene, mat=mat, pick_area=pick_area,
        light_tri=torch.cat([T.p0[lp], T.e1[lp], T.e2[lp]], -1).contiguous(),
        light_mat=T.mat[lp].to(torch.int32).contiguous(),
        light_w=scene.light_weights.contiguous(),
        alias_prob=scene.light_alias_prob.contiguous(),
        alias_idx=scene.light_alias_idx.to(torch.int32).contiguous(),
        mat_types=static.mat_types, n_lights=static.n_lights,
        per_light=static.per_light_mis)


def shade_diffuse_plain(tables: StepTables, sensor, params, st: LoopState, pixel, sample, t,
                        prim, hr: HitRecord):
    """Plain version of wpt_shade_diffuse: one bounce of the diffuse class
    after the closest hit (t, prim) and its hit record `hr`.

    Returns (state, shadow direction [N, 3], shadow t_max [N], pending
    deposit [N, n_acc]); the counters of st.stats grow in place by the
    closest casts (active lanes) and the shadow casts (RANDOM lanes)."""
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
        is_random, geom_len, opt_len, u3, tables.mat, tables.per_light)
    new = advance(params, st, hit, hr, sr, is_random, is_explicit, u_aux[:, 2], acc, geom_len,
                  opt_len, light_pdf_next)
    n_closest = st.active.sum()
    st.stats.add_(torch.stack([n_closest, n_closest + is_random.sum()]))
    return new, ldir, t_shadow, pending


def nee_resolve_plain(acc, pending, occluded, active, k_next, lanes: BlockLanes):
    """Plain version of wpt_nee_resolve: acc + pending where the shadow ray is
    not occluded, and whether any lane of the block has work left (an active
    path, or samples to start): the wavefront loop's condition.

    Returns (acc, work [1] int32)."""
    acc = deposit_unoccluded(acc, pending, occluded)
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


def _empty_state(st: LoopState, **keep) -> LoopState:
    """New output tensors for every field, but those given in `keep`."""
    return LoopState(**{f: keep[f] if f in keep else torch.empty_like(getattr(st, f))
                        for f in LoopState._fields})


def _camera_ptrs(cam: CameraParams, device):
    """Device pointers of the camera's centre [2], focal length [2], translation
    [3] and rotation [4]: float32 tensors on `device`."""
    tf = cam.transformation
    parts = (cam.center_px, cam.focal_px, tf.translation, tf.rotation)
    for x, numel in zip(parts, (2, 2, 3, 4)):
        if (x.dtype != torch.float32 or x.numel() != numel or not x.is_contiguous()
                or x.device != device):
            raise ValueError(f"regen_pinhole: camera tensors need contiguous float32 on "
                             f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    return [x.data_ptr() for x in parts]


def regen_pinhole(st: LoopState, sample, k_next, cam: CameraParams, cam_cfg: CameraConfig,
                  lanes: BlockLanes, randomize: bool):
    """Regenerate dead lanes (wpt_regen_pinhole; `regen_plain` on CPU tensors).
    The kernel takes a pinhole camera without distortion only."""
    n, dev = _check_state("regen_pinhole", st, sample, k_next, st.acc.shape[1])
    if dev.type == "cpu":
        return regen_plain(st, sample, k_next, cam, cam_cfg, lanes, randomize)
    if (cam_cfg.surround != SurroundMode.OFF or cam_cfg.stereo
            or cam_cfg.distortion != DistortionModel.NONE or cam_cfg.dof):
        raise ValueError("regen_pinhole: the kernel takes a pinhole camera without distortion")
    if n != lanes.B * lanes.m:
        raise ValueError(f"regen_pinhole: {n} lanes, the block has {lanes.B * lanes.m}")
    lib = native.load_kernels()
    out = _empty_state(st, acc=st.acc, stats=st.stats)
    out_sample, out_k = torch.empty_like(sample), torch.empty_like(k_next)
    t_max = torch.empty((n,), dtype=torch.float32, device=dev)
    camera = _camera_ptrs(cam, dev)
    s_in, s_out = _state_c(st, sample, k_next), _state_c(out, out_sample, out_k)
    code = lib.wpt_regen_pinhole(
        ctypes.addressof(s_in), ctypes.addressof(s_out), t_max.data_ptr(), n, *camera,
        lanes.blk, lanes.B, lanes.m, lanes.P, lanes.n_pix, lanes.width, lanes.height,
        lanes.ssqrt, int(randomize), native.stream_ptr(t_max))
    native.check(code, "regen_pinhole")
    native.LAUNCHES["regen_pinhole"] += 1
    return out, out_sample, out_k, t_max


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
    raise ValueError(f"shade_diffuse: no kernel for sensor {type(sensor).__name__}")


def shade_diffuse(tables: StepTables, sensor, params, st: LoopState, pixel, sample, t, prim,
                  hr: HitRecord):
    """One diffuse-class bounce after the closest hit (wpt_shade_diffuse;
    `shade_diffuse_plain` on CPU tensors): (state, shadow direction, shadow
    t_max, pending deposit); st.stats grows in place."""
    n, dev = _check_state("shade_diffuse", st, sample, sample, sensor.n_acc)
    for name, x, dtype, shape in (("pixel", pixel, torch.int64, (n,)),
                                  ("t", t, torch.float32, (n,)), ("prim", prim, torch.int32, (n,)),
                                  ("position", hr.position, torch.float32, (n, 3)),
                                  ("normal", hr.normal, torch.float32, (n, 3)),
                                  ("geom_normal", hr.geom_normal, torch.float32, (n, 3)),
                                  ("backside", hr.backside, torch.bool, (n,)),
                                  ("mat", hr.mat, torch.int32, (n,))):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"shade_diffuse: {name} needs contiguous {dtype} {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
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
    return out, shadow_d, shadow_tmax, pending


def nee_resolve(acc, pending, occluded, active, k_next, lanes: BlockLanes):
    """acc + pending where the shadow ray is not occluded, and the loop
    condition (wpt_nee_resolve; `nee_resolve_plain` on CPU tensors)."""
    n, c = acc.shape
    for name, x, dtype, shape in (("acc", acc, torch.float32, (n, c)),
                                  ("pending", pending, torch.float32, (n, c)),
                                  ("occluded", occluded, torch.bool, (n,)),
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
    out = torch.empty_like(acc)
    work = torch.empty((1,), dtype=torch.int32, device=acc.device)
    code = lib.wpt_nee_resolve(acc.data_ptr(), pending.data_ptr(), occluded.data_ptr(),
                               active.data_ptr(), k_next.data_ptr(), n, c, lanes.blk, lanes.B,
                               lanes.P, lanes.n_pix, out.data_ptr(), work.data_ptr(),
                               native.stream_ptr(acc))
    native.check(code, "nee_resolve")
    native.LAUNCHES["nee_resolve"] += 1
    return out, work
