"""Next-event-estimation light sampling and pdfs (port of
``wurblpt_tpu/render/lights.py`` for triangle hot spots, static or animated).

The pick is uniform, or power-proportional through the alias table when the
flattener attached one (`light_weights`). The NEE density is the mixture
sum_i w_i pdf_i over all hot spots (wurblpt.hpp:181-195), or, in scenes with
many lights (per-light MIS), the pick probability times the one relevant
light's density: `lights_pdf_at_hit` takes it from the hit itself, with the
per-prim (pick, 1 / area) row fetched by P0.

Animated hot spots (the JAX package's `light_frames`): each light's forward
map and translation at the frame's instant, from the animations' rows
(scene/animation.py anim_frames), move its triangle to world space before
the pdf, the sample and the emission. Per-light MIS needs static lights (its
areas are the flattener's), so a scene with an animated light takes the
mixture (`SceneStatic`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import sampler
from ..core.vecmath import cross, dot
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


def light_anim_ids(scene: SceneArrays):
    """[L] int32 animation id of each hot spot (0: static)."""
    return anim_ids(scene.tris)[scene.light_prims.long()]


def light_frames(scene: SceneArrays, frames):
    """Forward frames of every hot spot's animation at the frame's instant:
    (m [L, 3, 3], t [L, 3]), the m_fwd and t_inv columns of its animation's
    row in `frames` (scene/animation.anim_frames, [A, 30])."""
    rows = frames[light_anim_ids(scene).long()]
    return rows[:, 12:21].reshape(-1, 3, 3), rows[:, 9:12]


def light_tris(scene: SceneArrays, frames=None):
    """[L, 3] p0, e1, e2 of every hot spot, placed by `frames` (`light_frames`)
    where animated."""
    lp = scene.light_prims.long()
    T = scene.tris
    p0, e1, e2 = T.p0[lp], T.e1[lp], T.e2[lp]
    if frames is not None:
        m, t = frames
        p0, e1, e2 = matvec(m, p0) + t, matvec(m, e1), matvec(m, e2)
    return p0, e1, e2


def lights_pdf_multi(scene: SceneArrays, origin, dirs, frames=None):
    """Mixture pdf of each of K directions from `origin`: origin [N, 3], dirs
    [N, K, 3] -> [N, K]. Direction-independent terms are computed once.
    `frames` (`light_frames`) places animated lights at the frame's instant."""
    L = scene.n_lights
    N, K = dirs.shape[0], dirs.shape[1]
    if L == 0:
        return torch.zeros((N, K), device=dirs.device)
    p0, e1, e2 = (x[None, None] for x in light_tris(scene, frames))   # [1, 1, L, 3]
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
    w = light_pick_probs(scene)
    if w is None:
        return per_light.sum(-1) / L
    return dot(per_light, w.expand(per_light.shape))


def pick_area_table(scene: SceneArrays):
    """[P, 2] f32 (pick probability, 1 / area) per prim: the rows of lights_pdf_at_hit."""
    return torch.stack([scene.prim_light_pick, scene.prim_inv_area], -1).contiguous()


def lights_pdf_at_hit(pick_area, d, t, prim, geom_normal):
    """Per-light NEE density of rays that hit `prim` at distance t (static
    triangle lights): pick probability x t^2 / (|cos| x area), 0 for prims
    that are not lights or for misses (prim < 0).

    `pick_area` is `pick_area_table(scene)`; its row per lane is one P0
    gather (lights.py:204-240, the triangle branch)."""
    row = row_gather(pick_area, torch.clamp_min(prim, 0).to(torch.int32).contiguous())
    pp = torch.where(prim >= 0, row[:, 0], 0.0)
    cos = torch.abs(dot(d, geom_normal))
    return pp * (t * t * row[:, 1] / torch.clamp_min(cos, 1e-12))


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
    T = scene.tris
    p0, e1, e2 = (x[lp.long()] for x in (T.p0, T.e1, T.e2))
    if frames is not None:
        m, t = pick_frame(frames, pick)
        p0, e1, e2 = matvec(m, p0) + t, matvec(m, e1), matvec(m, e2)
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
    return d_tri, lp, dist, pick, pdf


def pick_frame(frames, pick):
    """(m [N, 3, 3], t [N, 3]) of the picked light [N] from `light_frames`."""
    m, t = frames
    pick = pick.long()
    return m[pick], t[pick]
