"""Next-event-estimation light sampling and pdfs (port of
``wurblpt_tpu/render/lights.py``: triangle and sphere hot spots, static or
animated).

The pick is uniform, or power-proportional through the alias table when the
flattener attached one (`light_weights`). The NEE density is the mixture
sum_i w_i pdf_i over all hot spots (wurblpt.hpp:181-195), or, in scenes with
many lights (per-light MIS), the pick probability times the one relevant
light's density: `lights_pdf_at_hit` takes it from the hit itself, with the
per-prim (pick, 1 / area) row fetched by P0.

A sphere hot spot is sampled uniformly in the cone it subtends
(hitable_sphere.hpp:155-219): its density is 1 / the cone's solid angle,
its expected distance the near root of the sampled ray's quadratic. The
sphere branches are evaluated only in scenes with spheres, and selected
per light, as the JAX package does (lights.py:89-107, :122, :204, :243).

Animated hot spots (the JAX package's `light_frames`): each light's forward
map and translation at the frame's instant, from the animations' rows
(scene/animation.py anim_frames), or at each ray's own instant under motion
blur (anim_frames_per_ray: frames [N, L, ...]), move its triangle to world
space before the pdf, the sample and the emission. Per-light MIS needs static lights (its
areas are the flattener's), so a scene with an animated light takes the
mixture (`SceneStatic`).
"""

from __future__ import annotations

from typing import Optional

import torch

import math

from ..core import sampler
from ..core.onb import onb_from_normal, to_world
from ..core.vecmath import cross, dot, normalize, safe_sqrt
from ..scene.animation import matvec
from ..scene.ir import SceneArrays, anim_ids
from .gather import row_gather


def light_pick_probs(scene: SceneArrays) -> Optional[torch.Tensor]:
    """[L] pick probability per hot spot, or None for a uniform pick."""
    return scene.light_weights


def light_pick_prob_of(scene: SceneArrays, pick):
    """Pick probability of light index `pick` [N]."""
    w = light_pick_probs(scene)
    if w is None:
        return torch.full(pick.shape, 1.0 / max(scene.n_lights, 1), device=pick.device)
    return w[pick.long()]


_TWO_PI = 2.0 * math.pi


def light_anim_ids(scene: SceneArrays, spheres: bool = False):
    """[L] int32 animation id of each hot spot (0: static); `spheres`: some
    hot spots are spheres (SceneStatic.sphere_lights)."""
    lp = scene.light_prims.long()
    n_tri = scene.n_tris
    if not spheres:
        return anim_ids(scene.tris)[lp]
    a_sph = anim_ids(scene.spheres)[torch.clamp(lp - n_tri, 0, scene.n_spheres - 1)]
    if n_tri == 0:
        return a_sph
    return torch.where(lp < n_tri, anim_ids(scene.tris)[torch.clamp(lp, 0, n_tri - 1)], a_sph)


def light_frames(scene: SceneArrays, frames, spheres: bool = False):
    """Forward frames of every hot spot's animation: (m [L, 3, 3], t [L, 3])
    at the frame's instant from `frames` [A, 30] (scene/animation.anim_frames),
    or (m [N, L, 3, 3], t [N, L, 3]) at each ray's instant from [N, A, 30]
    (anim_frames_per_ray): the m_fwd and t_inv columns of its animation's
    row; `spheres` as `light_anim_ids`'."""
    rows = frames[..., light_anim_ids(scene, spheres).long(), :]
    return rows[..., 12:21].reshape(rows.shape[:-1] + (3, 3)), rows[..., 9:12]


def light_tris(scene: SceneArrays, frames=None, spheres: bool = True):
    """[L, 3] p0, e1, e2 of every hot spot, placed by `frames` (`light_frames`)
    where animated. Where `spheres` (some hot spots may be spheres) a
    sphere's rows are those of a clamped triangle index, or zeros in a
    scene without triangles."""
    lp = scene.light_prims.long()
    T = scene.tris
    if scene.n_tris == 0:
        z = torch.zeros((lp.shape[0], 3), dtype=torch.float32, device=lp.device)
        return z, z, z
    if spheres and scene.n_spheres > 0:
        lp = torch.clamp(lp, 0, scene.n_tris - 1)
    p0, e1, e2 = T.p0[lp], T.e1[lp], T.e2[lp]
    if frames is not None:
        m, t = frames
        p0, e1, e2 = matvec(m, p0) + t, matvec(m, e1), matvec(m, e2)
    return p0, e1, e2


def light_spheres(scene: SceneArrays, frames=None):
    """(centre [L, 3], radius [L]) of every hot spot's sphere, placed by
    `frames` where animated, the radius scaled by the mean column norm of
    the forward map (lights.py:89-107; a triangle's rows are a clamped
    sphere index's)."""
    S = scene.spheres
    si = torch.clamp(scene.light_prims.long() - scene.n_tris, 0, scene.n_spheres - 1)
    center, radius = S.center[si], S.radius[si]
    if frames is not None:
        m, t = frames
        center = matvec(m, center) + t
        radius = radius * torch.linalg.norm(m, dim=-2).mean(-1)
    return center, radius


def _sphere_cone(oc, radius):
    """(dist2, cos_max, solid angle, pdf) of the cone a sphere of `radius`
    subtends from a point `oc` away from its centre (hitable_sphere.hpp:155-219)."""
    dist2 = dot(oc, oc)
    r2 = radius * radius
    sin2_max = torch.clamp(r2 / torch.clamp_min(dist2, 1e-12), 0.0, 1.0)
    cos_max = safe_sqrt(1.0 - sin2_max)
    solid = _TWO_PI * (1.0 - cos_max)
    pdf = torch.where((dist2 > r2) & (solid > 1e-12), 1.0 / torch.clamp_min(solid, 1e-12), 0.0)
    return dist2, cos_max, solid, pdf


def _per_origin(x, dims: int = 2):
    """A light table [L, ...] of `dims` dims as [1, 1, L, ...], or one per
    ray [N, L, ...] as [N, 1, L, ...]."""
    return x[None, None] if x.dim() == dims else x[:, None]


def lights_pdf_multi(scene: SceneArrays, origin, dirs, frames=None):
    """Mixture pdf of each of K directions from `origin`: origin [N, 3], dirs
    [N, K, 3] -> [N, K]. Direction-independent terms are computed once.
    `frames` (`light_frames`) places animated lights at the frame's instant."""
    L = scene.n_lights
    N, K = dirs.shape[0], dirs.shape[1]
    if L == 0:
        return torch.zeros((N, K), device=dirs.device)
    # [1, 1, L, 3], or [N, 1, L, 3] with per-ray frames
    p0, e1, e2 = (_per_origin(x) for x in light_tris(scene, frames))
    o = origin[:, None, None, :]                                # [N, 1, 1, 3]
    d = dirs[:, :, None, :]                                     # [N, K, 1, 3]

    tvec = o - p0
    fn = cross(e1, e2)
    fn_len = torch.sqrt(dot(fn, fn))
    area = 0.5 * fn_len
    n_unit = fn / torch.clamp_min(fn_len, 1e-20)[..., None]
    qvec = cross(tvec, e1)

    pvec = cross(d, e2)                                         # [N, K, L, 3]
    det = dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > 1e-12,
                          1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    u = dot(tvec, pvec) * inv_det
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    tri_hit = (torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
    cos_l = torch.abs(dot(d, n_unit))
    # Triangle pdf: t^2 / (|cos| * area) (hitable_triangle.hpp:405-423).
    per_light = torch.where(tri_hit, t * t / torch.clamp_min(cos_l * area, 1e-12), 0.0)
    if scene.n_spheres > 0:
        # Sphere pdf: 1 / the cone's solid angle inside the cone, 0 outside.
        center, radius = light_spheres(scene, frames)
        oc = _per_origin(center) - o                             # [N, 1, L, 3]
        dist2, cos_max, solid, pdf_in = _sphere_cone(oc, _per_origin(radius, 1))
        inv_dist = 1.0 / torch.clamp_min(torch.sqrt(dist2), 1e-12)
        in_cone = dot(d, oc) * inv_dist >= cos_max
        pdf_sph = torch.where(in_cone, pdf_in, 0.0)
        is_tri = scene.light_prims < scene.n_tris
        per_light = torch.where(is_tri, per_light, pdf_sph)
    w = light_pick_probs(scene)
    if w is None:
        return per_light.sum(-1) / L
    return dot(per_light, w.expand(per_light.shape))


def pick_area_table(scene: SceneArrays):
    """[P, 2] f32 (pick probability, 1 / area) per prim: the rows of lights_pdf_at_hit."""
    return torch.stack([scene.prim_light_pick, scene.prim_inv_area], -1).contiguous()


def lights_pdf_at_hit(pick_area, d, t, prim, geom_normal, scene=None, o=None):
    """Per-light NEE density of rays (o, d) that hit `prim` at distance t
    (static lights): pick probability x t^2 / (|cos| x area) for a triangle,
    x 1 / its cone's solid angle from o for a sphere, 0 for prims that are
    not lights or for misses (prim < 0).

    `pick_area` is `pick_area_table(scene)`; its row per lane is one P0
    gather (lights.py:204-240). The sphere branch needs `scene` and `o`
    (a scene with sphere lights); without them every prim is taken as a
    triangle."""
    # clipped as the JAX package's gather: a medium scatter's prim lies past the table
    row = row_gather(pick_area, torch.clamp(prim, 0, pick_area.shape[0] - 1)
                     .to(torch.int32).contiguous())
    pp = torch.where(prim >= 0, row[:, 0], 0.0)
    cos = torch.abs(dot(d, geom_normal))
    pdf = t * t * row[:, 1] / torch.clamp_min(cos, 1e-12)
    if scene is not None and scene.n_spheres > 0:
        n_tri = scene.n_tris
        S = scene.spheres
        si = torch.clamp(torch.clamp_min(prim, 0).long() - n_tri, 0, scene.n_spheres - 1)
        _, _, _, pdf_sph = _sphere_cone(S.center[si] - o, S.radius[si])
        pdf = torch.where(prim < n_tri, pdf, pdf_sph)
    return pp * pdf


def lights_sample(scene: SceneArrays, origin, u3, frames=None):
    """Pick a hot spot and sample a direction toward it (wurblpt.hpp:187-190).

    Returns (direction [N, 3], picked prim [N], t_expected [N], pick [N],
    pdf_sa [N]): `t_expected` is the distance to the sampled light point and
    `pdf_sa` the solid-angle density under the picked light alone. `frames`
    (`light_frames`) places an animated light at the frame's instant."""
    L = scene.n_lights
    cell = torch.clamp((u3[:, 0] * L).to(torch.int32), 0, L - 1)
    if scene.light_alias_prob is not None:
        cl = cell.long()
        frac = u3[:, 0] * L - cell.to(u3.dtype)
        take_alias = frac >= scene.light_alias_prob[cl]
        pick = torch.where(take_alias, scene.light_alias_idx[cl], cell)
    else:
        pick = cell
    lp = scene.light_prims[pick.long()]
    n_tri = scene.n_tris
    m_pick = t_pick = None
    if frames is not None:
        m_pick, t_pick = pick_frame(frames, pick)
    d_tri = dist = pdf = None
    if n_tri > 0:
        T = scene.tris
        ti = torch.clamp(lp.long(), 0, n_tri - 1)
        p0, e1, e2 = (x[ti] for x in (T.p0, T.e1, T.e2))
        if m_pick is not None:
            p0, e1, e2 = matvec(m_pick, p0) + t_pick, matvec(m_pick, e1), matvec(m_pick, e2)
        bary = sampler.in_triangle(u3[:, 1:3])
        q = p0 + bary[:, 0:1] * e1 + bary[:, 1:2] * e2
        d_tri = q - origin
        dist = torch.sqrt(dot(d_tri, d_tri))
        d_tri = d_tri / torch.clamp_min(dist, 1e-12)[:, None]
        fn = cross(e1, e2)
        fn_len = torch.sqrt(dot(fn, fn))
        area = 0.5 * fn_len
        cos_tri = torch.abs(dot(d_tri, fn)) / torch.clamp_min(fn_len, 1e-20)
        pdf = dist * dist / torch.clamp_min(cos_tri * area, 1e-12)
    if scene.n_spheres > 0:
        # Cone sample; the expected distance is the near root of the sampled
        # ray's quadratic, its discriminant clamped at 0 (lights.py:353-376).
        S = scene.spheres
        si = torch.clamp(lp.long() - n_tri, 0, scene.n_spheres - 1)
        center, radius = S.center[si], S.radius[si]
        if m_pick is not None:
            center = matvec(m_pick, center) + t_pick
            radius = radius * torch.linalg.norm(m_pick, dim=-2).mean(-1)
        oc = center - origin
        dist2, cos_max, _, pdf_sph = _sphere_cone(oc, radius)
        axis = normalize(oc)
        tb, bb = onb_from_normal(axis)
        d_sph = to_world(sampler.cone_direction_local(cos_max, u3[:, 1:3]), tb, bb, axis)
        half_b = -dot(oc, d_sph)
        disc = torch.clamp_min(half_b * half_b - (dist2 - radius * radius), 0.0)
        dist_sph = -half_b - torch.sqrt(disc)
        if d_tri is None:
            return d_sph, lp, dist_sph, pick, pdf_sph
        is_tri = lp < n_tri
        d_tri = torch.where(is_tri[:, None], d_tri, d_sph)
        dist = torch.where(is_tri, dist, dist_sph)
        pdf = torch.where(is_tri, pdf, pdf_sph)
    return d_tri, lp, dist, pick, pdf


def pick_frame(frames, pick):
    """(m [N, 3, 3], t [N, 3]) of the picked light [N] from `light_frames`
    (at one instant, or each lane's own under motion blur)."""
    m, t = frames
    pick = pick.long()
    if m.dim() == 3:
        return m[pick], t[pick]
    lane = torch.arange(pick.shape[0], device=pick.device)
    return m[lane, pick], t[lane, pick]
