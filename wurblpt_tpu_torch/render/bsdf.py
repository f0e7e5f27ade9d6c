"""BSDF sampling / evaluation / emission (port of ``wurblpt_tpu/render/bsdf.py``
for LAMBERTIAN, GGX, MIRROR and LIGHT_DIFFUSE materials).

Lobes are evaluated for the material types present in the scene
(`SceneStatic.mat_types`) and selected per lane, as the JAX package does:
cosine-sampled Lambertian, anisotropic GGX with Heitz's VNDF sampling
(material_ggx.hpp:89-171), and the mirror as a delta (EXPLICIT) lobe.

`SceneStatic` carries the facts about a scene that select code paths; its
`check_slice` raises NotImplementedError for every feature this port does
not render yet, so such a scene is refused instead of rendered wrong.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import sampler
from ..core.fresnel import fresnel_schlick
from ..core.onb import onb_from_normal_tangent, to_local, to_world
from ..core.vecmath import cross, dot, normalize, reflect, safe_sqrt
from ..scene.ir import MaterialFlags, MaterialType, SceneArrays
from .intersect import HitRecord
from .texture import material_albedo, material_emissive

_INV_PI = 1.0 / math.pi

SLICE_MATERIALS = frozenset({MaterialType.LAMBERTIAN, MaterialType.GGX, MaterialType.MIRROR,
                             MaterialType.LIGHT_DIFFUSE})
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
    per_light_mis: bool

    @staticmethod
    def from_scene(scene: SceneArrays) -> "SceneStatic":
        lp = scene.light_prims
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
            per_light_mis=int(lp.shape[0]) >= PER_LIGHT_MIS_MIN,
        )

    def check_slice(self) -> None:
        """Raise NotImplementedError for any scene feature outside the ported slice."""
        off = {
            f"material types {sorted(self.mat_types - SLICE_MATERIALS)}":
                bool(self.mat_types - SLICE_MATERIALS),
            "textures": self.has_textures,
            "animation": self.has_anim,
            f"environment map kind {self.env_kind}"
            f"{'' if self.env_importance else ' without importance sampling'}":
                self.env_kind != 0 and not (self.env_kind == 1 and self.env_importance),
            "participating media": self.has_media,
            "spheres in a BVH scene": self.bvh_spheres,
            "sphere lights": self.sphere_lights,
            "per-light MIS": self.per_light_mis,
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


def pack_material_table(mt):
    """(floats [M, 12] = albedo | emissive | p0, ints [M, 2] = typ | flags)."""
    return (torch.cat([mt.albedo, mt.emissive, mt.p0], -1).contiguous(),
            torch.stack([mt.typ, mt.flags], -1).to(torch.int32).contiguous())


def gather_material_rows(packed, mat_ids) -> MatRow:
    """One row gather of each packed table -> every per-lane attribute."""
    f, i = packed[0][mat_ids], packed[1][mat_ids]
    return MatRow(typ=i[:, 0], flags=i[:, 1], albedo=f[:, 0:4], emissive=f[:, 4:8],
                  p0=f[:, 8:12])


def emitted(hr: HitRecord, view_dir, mrow: MatRow):
    """Radiance emitted from the hit toward the viewer (material.hpp:182-185).

    view_dir points from the hit toward the previous vertex (= -ray.dir)."""
    is_emitter = mrow.typ == MaterialType.LIGHT_DIFFUSE
    two_sided = (mrow.flags & MaterialFlags.TWO_SIDED) > 0
    front_ok = (~hr.backside) | two_sided
    vis = dot(hr.normal, view_dir) > 0.0
    ok = is_emitter & front_ok & vis
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


def bsdf_sample(hr: HitRecord, ray_dir, ray_ior, u4, mrow: MatRow,
                mat_types=SLICE_MATERIALS) -> ScatterSample:
    """Sample the outgoing lobe at each hit (reference Material::scatter).

    u4: [N, 4] uniforms; the first two drive the direction. Lights absorb
    (kind NONE). Lobes are computed for the types in `mat_types` only. The
    JAX version's lobe and channel uniforms serve materials outside the
    slice."""
    n = hr.normal
    wo = -ray_dir
    u2 = u4[:, 0:2]
    albedo = material_albedo(mrow)
    kind = torch.zeros_like(mrow.typ)
    direction = n
    atten = torch.zeros_like(albedo)
    pdf = torch.zeros_like(n[:, 0])
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
    return ScatterSample(kind=kind.to(torch.int32), direction=direction, atten=atten, pdf=pdf,
                         ior=ray_ior)


def bsdf_eval(hr: HitRecord, ray_dir, wd, mrow: MatRow, mat_types=SLICE_MATERIALS):
    """(f * cos [N, 4], pdf [N]) of scattering into direction wd
    (Material::scatterToDirection, material.hpp:173-179); zero for delta
    lobes (mirror) and lights."""
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
    return fcos, pdf
