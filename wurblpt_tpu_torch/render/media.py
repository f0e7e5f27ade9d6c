"""Homogeneous participating media: free-path sampling along traced segments
(port of ``wurblpt_tpu/render/media.py``).

Reference ``HitableMedium`` (hitable_medium.hpp:38-99): each medium's
boundary is probed twice per segment (the entry: a front-side hit, or t_min
where the segment starts inside; the exit: the next boundary hit), then an
exponential free path ``dist = -log(1 - u) / rho`` decides whether the
segment scatters inside the medium before the nearest solid surface. Media
never occlude for certain: shadow rays are blocked the same stochastic way.

`apply_media` is KM (``csrc/media.cu``): a hand-written CUDA kernel on CUDA
tensors, its plain PyTorch version `apply_media_plain` on CPU tensors. The
JAX package brute-forces every medium's boundary twice per segment as [N, P]
broadcasts (media.py:32-155), a hand-shaped XLA hot path of the same kind as
the brute-force casts; as PyTorch ops it would be some 60 launches a medium
per cast on a bounce that is already bound by its launches, so the port
runs it as one kernel: a thread a lane, the media in id order, each
medium's boundary rows one contiguous range (`MediumArrays.tri_off`,
`sph_off`).
"""

from __future__ import annotations

import torch

from .. import native
from ..core.rng import Salt, uniform1
from ..core.vecmath import cross, dot, safe_sqrt
from ..scene.ir import MediumArrays, SceneArrays
from .intersect_brute import BIG, _first_min

_EPS = 1e-4   # the exit probe starts this far past the entry


def _boundary_hit(media: MediumArrays, tri, sph, o, d, t_min):
    """Closest hit of one medium's boundary after t_min: (t [N], backside [N],
    found [N]); `tri` and `sph` are the medium's row ranges, each (lo, hi)
    (media.py:32-101, the JAX order of the rows and of the arithmetic)."""
    n = o.shape[0]
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    best_back = torch.zeros((n,), dtype=torch.bool, device=o.device)
    ox, dx, tm = o[:, None, :], d[:, None, :], t_min[:, None]
    lo, hi = tri
    if hi > lo:
        p0, e1, e2 = (x[lo:hi][None] for x in (media.tri_p0, media.tri_e1, media.tri_e2))
        pvec = cross(dx, e2)
        det = dot(e1, pvec)
        big = torch.abs(det) > 1e-12
        inv_det = torch.where(big, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
        tvec = ox - p0
        u = dot(tvec, pvec) * inv_det
        qvec = cross(tvec, e1)
        v = dot(dx, qvec) * inv_det
        t = dot(e2, qvec) * inv_det
        ok = big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tm)
        tj, j = _first_min(torch.where(ok, t, BIG))
        jl = j.long()
        # backside: the geometric normal faces along the ray (an exit)
        back = dot(d, cross(e1[0][jl], e2[0][jl])) > 0.0
        closer = tj < best_t
        best_back = torch.where(closer, back, best_back)
        best_t = torch.where(closer, tj, best_t)
    lo, hi = sph
    if hi > lo:
        center = media.sph_center[lo:hi]
        radius = media.sph_radius[lo:hi]
        oc = ox - center[None]
        a = dot(dx, dx)
        half_b = dot(oc, dx)
        c = dot(oc, oc) - (radius * radius)[None]
        disc = half_b * half_b - a * c
        sq = safe_sqrt(disc)
        q = -(half_b + torch.sign(half_b) * sq)
        t0 = q / torch.clamp_min(a, 1e-20)
        t1 = c / torch.where(torch.abs(q) > 1e-20, q, 1.0)
        tlo = torch.minimum(t0, t1)
        thi = torch.maximum(t0, t1)
        t = torch.where(tlo > tm, tlo, thi)
        ok = (disc > 0.0) & (t > tm)
        tj, j = _first_min(torch.where(ok, t, BIG))
        p = o + tj[:, None] * d
        back = dot(d, p - center[j.long()]) > 0.0
        closer = tj < best_t
        best_back = torch.where(closer, back, best_back)
        best_t = torch.where(closer, tj, best_t)
    return best_t, best_back, best_t < BIG


def apply_media_plain(scene: SceneArrays, o, d, t_min, t_solid, prim_solid, u_solid, v_solid,
                      pixel_id, sample_id, bounce, salt_ctx: int):
    """Plain version of KM (`apply_media`), step for step as media.py:104-155:
    for each medium in id order its entry, its exit, the free path drawn by
    Salt.MEDIUM + (salt_ctx << 8) + m, a scatter where it ends before the
    exit and before the nearest hit so far."""
    media = scene.media
    n_solid = scene.n_tris + scene.n_spheres
    t_best, prim_best = t_solid, prim_solid
    med_mask = torch.zeros(t_solid.shape, dtype=torch.bool, device=t_solid.device)
    med_mat = torch.zeros(t_solid.shape, dtype=torch.int32, device=t_solid.device)
    tri_off, sph_off = media.tri_off.tolist(), media.sph_off.tolist()
    for m in range(media.count):
        rows = (tri_off[m], tri_off[m + 1]), (sph_off[m], sph_off[m + 1])
        t1, back1, found1 = _boundary_hit(media, *rows, o, d, t_min)
        entry = torch.where(back1, t_min, t1)
        # Exit: starting inside, the first boundary hit is the exit; else the
        # next boundary hit after the entry.
        t2, _, _ = _boundary_hit(media, *rows, o, d, entry + _EPS)
        exit_t = torch.where(back1, t1, t2)
        u = uniform1(pixel_id, sample_id, bounce, Salt.MEDIUM + (salt_ctx << 8) + m)
        dist = (-torch.log1p(-torch.clamp(u, 0.0, 0.999999))
                / torch.clamp_min(media.density[m], 1e-20))
        t_sc = entry + dist
        hit_m = found1 & (t_sc < exit_t) & (t_sc < t_best)
        t_best = torch.where(hit_m, t_sc, t_best)
        prim_best = torch.where(hit_m, n_solid + m, prim_best)
        med_mask = med_mask | hit_m
        med_mat = torch.where(hit_m, media.phase_mat[m], med_mat)
    u_best = torch.where(med_mask, 0.0, u_solid)
    v_best = torch.where(med_mask, 0.0, v_solid)
    return t_best, prim_best.to(torch.int32), u_best, v_best, med_mask, med_mat


def _lane_words(x, n: int, device):
    """A counter word of every lane: int64 [n] (an int or a tensor broadcast to [n])."""
    return torch.as_tensor(x, device=device).to(torch.int64).expand(n).contiguous()


def apply_media(scene: SceneArrays, o, d, t_min, t_solid, prim_solid, u_solid, v_solid,
                pixel_id, sample_id, bounce, salt_ctx: int):
    """Fold medium scattering into the closest hit (t_solid, prim_solid,
    u_solid, v_solid) of segments (o, d) from t_min [N]: KM on CUDA tensors,
    the plain version on CPU tensors. pixel_id, sample_id and bounce (ints
    or integer tensors broadcast to [N]) key the free paths with `salt_ctx`
    (0 the bounce's closest cast, 1 light NEE, 2 env NEE). Returns (t, prim,
    u, v, med_mask, med_mat): a lane that scatters in medium m carries prim
    = n_tris + n_spheres + m, u = v = 0, med_mask True and the medium's phase
    material in med_mat (0 elsewhere)."""
    media = scene.media
    n = o.shape[0]
    for name, x, dtype, shape in (("o", o, torch.float32, (n, 3)), ("d", d, torch.float32, (n, 3)),
                                  ("t_min", t_min, torch.float32, (n,)),
                                  ("t_solid", t_solid, torch.float32, (n,)),
                                  ("prim_solid", prim_solid, torch.int32, (n,)),
                                  ("u_solid", u_solid, torch.float32, (n,)),
                                  ("v_solid", v_solid, torch.float32, (n,))):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"apply_media: {name} needs contiguous {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != o.device:
            raise ValueError(f"apply_media: {name} is on {x.device}, o on {o.device}")
    if media is None or media.density.device != o.device:
        raise ValueError(f"apply_media: the scene's media must live on {o.device}")
    pixel_id, sample_id, bounce = (_lane_words(x, n, o.device)
                                   for x in (pixel_id, sample_id, bounce))
    if o.device.type == "cpu":
        return apply_media_plain(scene, o, d, t_min, t_solid, prim_solid, u_solid, v_solid,
                                 pixel_id, sample_id, bounce, salt_ctx)
    if o.device.type != "cuda":
        raise ValueError(f"apply_media: no kernel for device {o.device}")
    lib = native.load_kernels()
    t = torch.empty_like(t_solid)
    prim = torch.empty_like(prim_solid)
    u, v = torch.empty_like(u_solid), torch.empty_like(v_solid)
    med_mask = torch.empty((n,), dtype=torch.bool, device=o.device)
    med_mat = torch.empty((n,), dtype=torch.int32, device=o.device)
    code = lib.wpt_apply_media(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_solid.data_ptr(), prim_solid.data_ptr(),
        u_solid.data_ptr(), v_solid.data_ptr(), pixel_id.data_ptr(), sample_id.data_ptr(),
        bounce.data_ptr(), Salt.MEDIUM + (salt_ctx << 8), n,
        media.tri_p0.data_ptr(), media.tri_e1.data_ptr(), media.tri_e2.data_ptr(),
        media.tri_off.data_ptr(), media.sph_center.data_ptr(), media.sph_radius.data_ptr(),
        media.sph_off.data_ptr(), media.density.data_ptr(), media.phase_mat.data_ptr(),
        media.count, scene.n_tris + scene.n_spheres, t.data_ptr(), prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), med_mask.data_ptr(), med_mat.data_ptr(),
        native.stream_ptr(o))
    native.check(code, "apply_media")
    native.LAUNCHES["apply_media"] += 1
    return t, prim, u, v, med_mask, med_mat
