"""BSDF sampling / evaluation / emission (port of ``wurblpt_tpu/render/bsdf.py``
for LAMBERTIAN, GGX, MIRROR, GLASS, MODPHONG, RGL and the LIGHT_DIFFUSE,
LIGHT_SPOT and LIGHT_TOF materials).

Lobes are evaluated for the material types present in the scene
(`SceneStatic.mat_types`) and selected per lane, as the JAX package does:
cosine-sampled Lambertian, anisotropic GGX with Heitz's VNDF sampling
(material_ggx.hpp:89-171), the mirror and the dispersive glass
(material_glass.hpp:97-141) as delta (EXPLICIT) lobes, the
energy-normalized modified Phong with its opacity pass-through
(material_modphong.hpp:192-263; constant ks and opacity), and the measured
RGL BRDF through K7 (:mod:`wurblpt_tpu_torch.materials.rgl`).

Material attributes reach the lanes through one packed row per lane, fetched
by P0 (:func:`wurblpt_tpu_torch.render.gather.row_gather`).

`SceneStatic` carries the facts about a scene that select code paths; its
`check_slice` raises NotImplementedError for every feature this port does
not render yet, so such a scene is refused instead of rendered wrong.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import sampler
from ..core.fresnel import fresnel_schlick, fresnel_unpolarized
from ..core.onb import onb_from_normal, onb_from_normal_tangent, to_local, to_world
from ..core.vecmath import cross, dot, normalize, reflect, refract, safe_sqrt
from ..scene.ir import MaterialFlags, MaterialType, SceneArrays, anim_ids
from .gather import row_gather
from .intersect import HitRecord
from .texture import material_albedo, material_emissive

_INV_PI = 1.0 / math.pi
_TWO_PI = 2.0 * math.pi
# x / (2 pi) as XLA evaluates it: x times float32(1) / float32(2 pi).
_INV_TWO_PI = float(np.float32(1.0) / np.float32(_TWO_PI))

SLICE_MATERIALS = frozenset({MaterialType.LAMBERTIAN, MaterialType.GGX, MaterialType.MIRROR,
                             MaterialType.GLASS, MaterialType.MODPHONG, MaterialType.RGL,
                             MaterialType.LIGHT_DIFFUSE, MaterialType.LIGHT_SPOT,
                             MaterialType.LIGHT_TOF})
LIGHT_MATERIALS = frozenset({MaterialType.LIGHT_DIFFUSE, MaterialType.LIGHT_SPOT,
                             MaterialType.LIGHT_TOF})
# The lobes evaluated when a caller names no types: all but RGL, which needs tables.
ANALYTIC_MATERIALS = SLICE_MATERIALS - {MaterialType.RGL}
PER_LIGHT_MIS_MIN = 8  # lights; from here on the JAX package switches to per-light MIS


class ScatterKind:
    NONE = 0      # absorbed / light surface
    RANDOM = 1    # pdf-sampled lobe (takes part in MIS)
    EXPLICIT = 2  # delta lobe


class ScatterSample(NamedTuple):
    kind: torch.Tensor        # [N] int32
    direction: torch.Tensor   # [N, 3]
    atten: torch.Tensor       # [N, 4] f * cos
    pdf: torch.Tensor         # [N]
    ior: torch.Tensor         # [N, 4] refractive index for the continued ray


class SceneStatic(NamedTuple):
    """Host-side facts about a scene (bsdf.SceneStatic)."""

    mat_types: frozenset
    has_textures: bool
    has_anim: bool
    n_lights: int
    env_kind: int
    env_importance: bool
    has_media: bool
    has_bvh: bool
    bvh_spheres: bool       # spheres in a scene with a BVH (the port's BVH holds triangles)
    sphere_lights: bool
    per_light_mis: bool     # O(1) per-light MIS weights (lights_pdf_at_hit) instead of the mixture
    rgl_tables: bool        # the scene carries RGL tables
    lights_animated: bool = False   # a hot spot moves: NEE places it at the ray's time

    @staticmethod
    def from_scene(scene: SceneArrays) -> "SceneStatic":
        lp = scene.light_prims
        # global prim order, triangles then spheres, as light_prims counts
        prim_anim = torch.cat([anim_ids(scene.tris), anim_ids(scene.spheres)])
        lights_animated = bool(lp.shape[0] > 0 and scene.n_anims > 1
                               and (prim_anim[lp.long()] != 0).any())
        return SceneStatic(
            mat_types=frozenset(torch.unique(scene.materials.typ).tolist()),
            has_textures=scene.n_textures > 0,
            has_anim=scene.n_anims > 1,
            n_lights=int(lp.shape[0]),
            env_kind=int(scene.env_kind),
            env_importance=scene.envmap is not None and scene.envmap.importance,
            has_media=scene.n_media > 0,
            has_bvh=bool(scene.has_bvh),
            bvh_spheres=bool(scene.has_bvh and scene.n_spheres > 0),
            sphere_lights=bool((lp >= scene.n_tris).any()),
            per_light_mis=(int(lp.shape[0]) >= PER_LIGHT_MIS_MIN and not lights_animated
                           and scene.prim_light_pick is not None),
            rgl_tables=scene.rgl is not None,
            lights_animated=lights_animated,
        )

    def check_slice(self) -> None:
        """Raise NotImplementedError for any scene feature outside the ported slice."""
        off = {
            f"material types {sorted(self.mat_types - SLICE_MATERIALS)}":
                bool(self.mat_types - SLICE_MATERIALS),
            "textures": self.has_textures,
            # the BVH's leaves test world rays (B.1.3 ports the object-space ones)
            "animation in a BVH scene": self.has_anim and self.has_bvh,
            f"environment map kind {self.env_kind}"
            f"{'' if self.env_importance else ' without importance sampling'}":
                not (self.env_kind in (0, 2, 3) or (self.env_kind == 1 and self.env_importance)),
            "participating media": self.has_media,
            "spheres in a BVH scene": self.bvh_spheres,
            "sphere lights": self.sphere_lights,
            "RGL materials without tables":
                MaterialType.RGL in self.mat_types and not self.rgl_tables,
        }
        bad = [k for k, v in off.items() if v]
        if bad:
            raise NotImplementedError(f"scene features outside the ported slice: {bad}")


class MatRow(NamedTuple):
    """Per-lane material attributes from one gathered row."""

    typ: torch.Tensor       # [N] int32
    flags: torch.Tensor     # [N] int32
    albedo: torch.Tensor    # [N, 4]
    emissive: torch.Tensor  # [N, 4]
    p0: torch.Tensor        # [N, 4]
    p1: torch.Tensor        # [N, 4]
    p2: torch.Tensor        # [N, 4]
    rgl_id: torch.Tensor    # [N] int32


def pack_material_table(mt):
    """[M, 23] f32: albedo | emissive | p0 | p1 | p2, then typ, flags and
    rgl_id as int32 bit patterns (P0 copies words, never reads them as floats)."""
    ints = torch.stack([mt.typ, mt.flags, mt.rgl_id], -1).to(torch.int32)
    return torch.cat([mt.albedo, mt.emissive, mt.p0, mt.p1, mt.p2,
                      ints.view(torch.float32)], -1).contiguous()


def gather_material_rows(packed, mat_ids) -> MatRow:
    """One row gather (P0) of the packed table -> every per-lane attribute."""
    row = row_gather(packed, mat_ids.to(torch.int32).contiguous())
    ints = row[:, 20:23].view(torch.int32)
    return MatRow(typ=ints[:, 0], flags=ints[:, 1], albedo=row[:, 0:4], emissive=row[:, 4:8],
                  p0=row[:, 8:12], p1=row[:, 12:16], p2=row[:, 16:20], rgl_id=ints[:, 2])


def emitted(hr: HitRecord, view_dir, mrow: MatRow):
    """Radiance emitted from the hit toward the viewer (material.hpp:182-185).

    view_dir points from the hit toward the previous vertex (= -ray.dir).
    Lights and ModPhong surfaces emit; a spot or ToF light only inside its
    cone, cos(view, normal) >= cos(half angle) = p0.x (light_spot.hpp:32-75,
    light_tof.hpp:37-89)."""
    typ = mrow.typ
    is_cone = (typ == MaterialType.LIGHT_SPOT) | (typ == MaterialType.LIGHT_TOF)
    is_emitter = (typ == MaterialType.LIGHT_DIFFUSE) | is_cone | (typ == MaterialType.MODPHONG)
    two_sided = (mrow.flags & MaterialFlags.TWO_SIDED) > 0
    front_ok = (~hr.backside) | two_sided
    cos_view = dot(hr.normal, view_dir)
    in_cone = cos_view >= mrow.p0[:, 0]
    ok = is_emitter & front_ok & (cos_view > 0.0) & (in_cone | ~is_cone)
    return torch.where(ok[:, None], material_emissive(mrow), 0.0)


# ---------------------------------------------------------------------------
# GGX (anisotropic, local tangent frame with n = +z)
# ---------------------------------------------------------------------------

def _ggx_ndf(h, ax, ay):
    """Anisotropic GGX D (material_ggx.hpp:89-110)."""
    hx = h[..., 0] / ax
    hy = h[..., 1] / ay
    denom = hx * hx + hy * hy + h[..., 2] * h[..., 2]
    return torch.where(h[..., 2] > 0.0,
                       1.0 / torch.clamp_min(math.pi * ax * ay * denom * denom, 1e-12), 0.0)


def _ggx_lambda(w, ax, ay):
    wz = torch.clamp_min(torch.abs(w[..., 2]), 1e-6)
    a, b = ax * w[..., 0], ay * w[..., 1]
    return 0.5 * (-1.0 + torch.sqrt(1.0 + (a * a + b * b) / (wz * wz)))


def _ggx_sample_vndf(wo_local, ax, ay, u2):
    """Heitz 2018 VNDF sampling (material_ggx.hpp:138-171); wo_local.z > 0."""
    vh = normalize(torch.stack([ax * wo_local[..., 0], ay * wo_local[..., 1], wo_local[..., 2]], -1))
    lensq = vh[..., 0] * vh[..., 0] + vh[..., 1] * vh[..., 1]
    inv = 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-20))
    t1 = torch.where((lensq > 1e-12)[..., None],
                     torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv, torch.zeros_like(inv)], -1),
                     torch.tensor([1.0, 0.0, 0.0], device=vh.device))
    t2v = cross(vh, t1)
    r = safe_sqrt(u2[..., 0])
    phi = (2.0 * math.pi) * u2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    nh = (p1[..., None] * t1 + p2[..., None] * t2v
          + safe_sqrt(1.0 - p1 * p1 - p2 * p2)[..., None] * vh)
    return normalize(torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                                  torch.clamp_min(nh[..., 2], 1e-6)], -1))


def _ggx_eval_local(wo, wd, f0, ax, ay):
    """(f * cos [N, 4], VNDF pdf [N]) in the local frame; zero below the horizon."""
    up = (wo[..., 2] > 1e-6) & (wd[..., 2] > 1e-6)
    h = normalize(wo + wd)
    d_term = _ggx_ndf(h, ax, ay)
    lam_o = _ggx_lambda(wo, ax, ay)
    g2 = 1.0 / (1.0 + lam_o + _ggx_lambda(wd, ax, ay))
    g1 = 1.0 / (1.0 + lam_o)
    f = fresnel_schlick(torch.clamp_min(dot(wo, h), 1e-6)[..., None], f0)
    woz4 = 4.0 * torch.clamp_min(wo[..., 2], 1e-6)
    spec = f * (d_term * g2 / woz4)[..., None]
    return torch.where(up[..., None], spec, 0.0), torch.where(up, g1 * d_term / woz4, 0.0)


def _ggx_roughness(mrow):
    return torch.clamp_min(mrow.p0[:, 0], 1e-4), torch.clamp_min(mrow.p0[:, 1], 1e-4)


# ---------------------------------------------------------------------------
# ModPhong (material_modphong.hpp:192-263), constant ks and opacity
# ---------------------------------------------------------------------------

def _modphong_eval(wo, wd, n, kd, ks, shininess):
    """(f * cos [N, 4], mixture pdf [N]) of the energy-normalized modified
    Phong; world space, n front-facing."""
    cos_i = dot(wd, n)
    up = cos_i > 1e-6
    cos_a = torch.clamp(dot(reflect(-wo, n), wd), 0.0, 1.0)
    s = torch.clamp_min(shininess, 0.0)
    lobe = torch.pow(cos_a, s)
    f = kd * _INV_PI + ks * ((s + 2.0) * _INV_TWO_PI * lobe)[:, None]
    fcos = f * torch.clamp_min(cos_i, 0.0)[:, None]
    ps = _modphong_spec_prob(kd, ks)
    pdf = ((1.0 - ps) * (torch.clamp_min(cos_i, 0.0) * _INV_PI)
           + ps * ((s + 1.0) * _INV_TWO_PI * lobe))
    return torch.where(up[:, None], fcos, 0.0), torch.where(up, pdf, 0.0)


def _modphong_spec_prob(kd, ks):
    """Probability of the specular lobe: max(ks) / (max(kd) + max(ks))."""
    kd_max = kd[:, :3].amax(-1)
    ks_max = ks[:, :3].amax(-1)
    tot = kd_max + ks_max
    return torch.where(tot > 0, ks_max / torch.clamp_min(tot, 1e-12), 0.0)


def _sample_power_cosine(axis, exponent, u2):
    """A direction distributed as cos^exponent around `axis`."""
    ct = torch.pow(torch.clamp_min(u2[:, 0], 1e-12), 1.0 / (exponent + 1.0))
    st = safe_sqrt(1.0 - ct * ct)
    phi = _TWO_PI * u2[:, 1]
    t, b = onb_from_normal(axis)
    return to_world(torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1), t, b, axis)


def bsdf_sample(hr: HitRecord, ray_dir, ray_ior, u4, u_lobe, u_chan, mrow: MatRow,
                mat_types=ANALYTIC_MATERIALS, rgl=None) -> ScatterSample:
    """Sample the outgoing lobe at each hit (reference Material::scatter).

    u4: [N, 4] uniforms; the first two drive the direction. `u_lobe` and
    `u_chan` [N] are independent uniforms for the discrete picks: glass
    reflects or refracts by `u_lobe` and picks its dispersion channel by
    `u_chan`; ModPhong picks opacity pass-through by `u_lobe` and the
    specular or diffuse lobe by `u_chan`. Lights absorb (kind NONE). Lobes
    are computed for the types in `mat_types` only; RGL lanes need the
    scene's tables `rgl`."""
    n = hr.normal
    wo = -ray_dir
    u2 = u4[:, 0:2]
    albedo = material_albedo(mrow)
    kind = torch.zeros_like(mrow.typ)
    direction = n
    atten = torch.zeros_like(albedo)
    pdf = torch.zeros_like(n[:, 0])
    ior = ray_ior
    if MaterialType.LAMBERTIAN in mat_types:
        d_cos = sampler.cosine_direction(n, u2)
        p = torch.clamp_min(dot(d_cos, n), 0.0) * _INV_PI
        sel = mrow.typ == MaterialType.LAMBERTIAN
        kind = torch.where(sel, ScatterKind.RANDOM, kind)
        direction = torch.where(sel[:, None], d_cos, direction)
        atten = torch.where(sel[:, None], albedo * p[:, None], atten)
        pdf = torch.where(sel, p, pdf)
    if MaterialType.GGX in mat_types:
        ax, ay = _ggx_roughness(mrow)
        t, b = onb_from_normal_tangent(n, hr.tangent)
        wo_l = to_local(wo, t, b, n)
        wo_l = torch.cat([wo_l[:, :2], torch.clamp_min(wo_l[:, 2:], 1e-4)], -1)
        wd_l = reflect(-wo_l, _ggx_sample_vndf(wo_l, ax, ay, u2))
        fcos, p = _ggx_eval_local(wo_l, wd_l, albedo, ax, ay)
        sel = mrow.typ == MaterialType.GGX
        kind = torch.where(sel, ScatterKind.RANDOM, kind)
        direction = torch.where(sel[:, None], to_world(wd_l, t, b, n), direction)
        atten = torch.where(sel[:, None], fcos, atten)
        pdf = torch.where(sel, p, pdf)
    if MaterialType.MIRROR in mat_types:
        sel = mrow.typ == MaterialType.MIRROR
        kind = torch.where(sel, ScatterKind.EXPLICIT, kind)
        direction = torch.where(sel[:, None], reflect(ray_dir, n), direction)
        atten = torch.where(sel[:, None], albedo, atten)
        pdf = torch.where(sel, 1.0, pdf)
    if MaterialType.GLASS in mat_types:
        # Dielectric with per-channel IOR (material_glass.hpp:97-141): a
        # dispersive material refracts one channel, picked by u_chan and
        # weighted x4; Beer-Lambert absorption on backside hits.
        mat_ior, absorption = mrow.p0, mrow.p1
        dispersive = ((torch.abs(mat_ior[:, 0] - mat_ior[:, 1]) > 1e-6)
                      | (torch.abs(mat_ior[:, 1] - mat_ior[:, 2]) > 1e-6)
                      | (torch.abs(mat_ior[:, 2] - mat_ior[:, 3]) > 1e-6))
        chan = torch.clamp((u_chan * 4.0).to(torch.int32), 0, 3).long()
        n_mat = torch.where(dispersive, torch.gather(mat_ior, 1, chan[:, None])[:, 0],
                            mat_ior[:, 0])
        n_i = torch.where(hr.backside, n_mat, 1.0)
        n_t = torch.where(hr.backside, 1.0, n_mat)
        fres = fresnel_unpolarized(torch.clamp(dot(wo, n), 0.0, 1.0), n_i, n_t)
        d_refr, tir = refract(ray_dir, n, n_i / torch.clamp_min(n_t, 1e-6))
        keep = (u_lobe < fres) | tir          # reflect: the Fresnel pick, or TIR
        a_g = torch.where(dispersive[:, None],
                          torch.nn.functional.one_hot(chan, 4).to(atten.dtype) * 4.0, 1.0)
        a_g = a_g * torch.where(hr.backside[:, None], torch.exp(-absorption * hr.t[:, None]), 1.0)
        sel = mrow.typ == MaterialType.GLASS
        kind = torch.where(sel, ScatterKind.EXPLICIT, kind)
        direction = torch.where(sel[:, None],
                                torch.where(keep[:, None], reflect(ray_dir, n), d_refr), direction)
        atten = torch.where(sel[:, None], a_g, atten)
        pdf = torch.where(sel, 1.0, pdf)
        new_ior = torch.where(keep[:, None], ray_ior,
                              torch.where(hr.backside[:, None], 1.0, mat_ior))
        ior = torch.where(sel[:, None], new_ior, ior)
    if MaterialType.MODPHONG in mat_types:
        ks, shininess, opacity, mp_ior = mrow.p1, mrow.p0[:, 0], mrow.p0[:, 1], mrow.p0[:, 3]
        ps = _modphong_spec_prob(albedo, ks)
        # Opacity pass-through (material_modphong.hpp:241-261): with
        # probability 1 - opacity refract with the material's index,
        # attenuated by the transmissive colour; total internal reflection
        # and opaque backside hits absorb.
        pass_through = u_lobe > opacity
        eta = (torch.where(hr.backside, mp_ior, 1.0)
               / torch.where(hr.backside, 1.0, mp_ior))
        d_pass, tir = refract(ray_dir, n, eta)
        d_spec = _sample_power_cosine(reflect(ray_dir, n), shininess, u2)
        d_mp = torch.where((u_chan < ps)[:, None], d_spec, sampler.cosine_direction(n, u2))
        fcos, p = _modphong_eval(wo, d_mp, n, albedo, ks, shininess)
        kind_mp = torch.where(pass_through, ScatterKind.EXPLICIT, ScatterKind.RANDOM)
        kind_mp = torch.where((pass_through & tir) | (hr.backside & ~pass_through),
                              ScatterKind.NONE, kind_mp)
        sel = mrow.typ == MaterialType.MODPHONG
        kind = torch.where(sel, kind_mp, kind)
        direction = torch.where(sel[:, None], torch.where(pass_through[:, None], d_pass, d_mp),
                                direction)
        atten = torch.where(sel[:, None], torch.where(pass_through[:, None], mrow.p2, fcos),
                            atten)
        pdf = torch.where(sel, torch.where(pass_through, 1.0, p), pdf)
        ior = torch.where((sel & pass_through)[:, None],
                          torch.where(hr.backside, 1.0, mp_ior)[:, None], ior)
    if MaterialType.RGL in mat_types:
        from ..materials.rgl import rgl_sample_lanes

        d_r, fcos_r, p_r, ok_r = rgl_sample_lanes(rgl, hr, wo, u2, mrow.rgl_id)
        sel = (mrow.typ == MaterialType.RGL) & ok_r
        kind = torch.where(sel, ScatterKind.RANDOM, kind)
        direction = torch.where(sel[:, None], d_r, direction)
        atten = torch.where(sel[:, None], fcos_r, atten)
        pdf = torch.where(sel, p_r, pdf)
    return ScatterSample(kind=kind.to(torch.int32), direction=direction, atten=atten, pdf=pdf,
                         ior=ior)


def bsdf_eval(hr: HitRecord, ray_dir, wd, mrow: MatRow, mat_types=ANALYTIC_MATERIALS,
              rgl=None):
    """(f * cos [N, 4], pdf [N]) of scattering into direction wd
    (Material::scatterToDirection, material.hpp:173-179); zero for delta
    lobes (mirror) and lights. ModPhong evaluates its full lobe whatever its
    opacity (material_modphong.hpp:310-328)."""
    n = hr.normal
    albedo = material_albedo(mrow)
    fcos = torch.zeros_like(albedo)
    pdf = torch.zeros_like(n[:, 0])
    if MaterialType.LAMBERTIAN in mat_types:
        p = torch.clamp_min(dot(wd, n), 0.0) * _INV_PI
        sel = mrow.typ == MaterialType.LAMBERTIAN
        fcos = torch.where(sel[:, None], albedo * p[:, None], fcos)
        pdf = torch.where(sel, p, pdf)
    if MaterialType.GGX in mat_types:
        ax, ay = _ggx_roughness(mrow)
        t, b = onb_from_normal_tangent(n, hr.tangent)
        f_g, p_g = _ggx_eval_local(to_local(-ray_dir, t, b, n), to_local(wd, t, b, n), albedo,
                                   ax, ay)
        sel = mrow.typ == MaterialType.GGX
        fcos = torch.where(sel[:, None], f_g, fcos)
        pdf = torch.where(sel, p_g, pdf)
    if MaterialType.MODPHONG in mat_types:
        f_m, p_m = _modphong_eval(-ray_dir, wd, n, albedo, mrow.p1, mrow.p0[:, 0])
        sel = mrow.typ == MaterialType.MODPHONG
        fcos = torch.where(sel[:, None], f_m, fcos)
        pdf = torch.where(sel, p_m, pdf)
    if MaterialType.RGL in mat_types:
        from ..materials.rgl import rgl_eval_lanes

        f_r, p_r, ok_r = rgl_eval_lanes(rgl, hr, -ray_dir, wd, mrow.rgl_id)
        sel = (mrow.typ == MaterialType.RGL) & ok_r
        fcos = torch.where(sel[:, None], f_r, fcos)
        pdf = torch.where(sel, p_r, pdf)
    return fcos, pdf
