"""The brute-force sweeps: KS1 (closest hit) and KS2 (any hit).

Port of the JAX package's tiled sweeps, ``wurblpt_tpu/render/intersect.py``
`_closest_tris` / `_closest_spheres` (:216, :271) and `_any_tris` /
`_any_spheres` (:397, :434), with their tests `ray_tri_tile` (:155,
Moller-Trumbore with a true division by the determinant) and
`ray_sphere_tile` (:189, the stable quadratic in world space). The JAX
package casts through them every scene without a BVH that its matrix form
does not take: an animated scene, or a static one past 8192 columns
(`intersect_brute.brute_eligible`). In an animated scene every primitive
tests its lane's ray in the object space of its own animation (row 0, the
identity, for static primitives; scene/animation.py).

The kernels (``csrc/sweep_closest.cu``, ``csrc/sweep_any.cu``) take one ray
per thread and walk the primitives in order; each has a plain PyTorch
version here, term for term the same arithmetic, which the wrappers run on
CPU tensors. Ties: the JAX package takes the first minimum within a tile of
up to 1024 triangles and a strict `<` across tiles, triangles before
spheres; a walk in prim order with a strict `<` takes the same first
minimum, so neither version needs the TPU's tiles.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import native
from ..core.vecmath import cross, dot
from ..scene.animation import FRAME_WIDTH, frames_ray_to_object
from ..scene.ir import anim_ids
from .intersect_brute import BIG, _check_rays, _first_min

PLAIN_PAIRS = 1 << 22   # ray/primitive pairs per tile of the plain versions (memory only)


class SweepScene(NamedTuple):
    """Primitive tables of the sweeps, world space (static) or each
    primitive's object space (animated)."""

    tri: torch.Tensor       # [T, 12] f32: p0 xyz, 0 | e1 xyz, 0 | e2 xyz, 0
    tri_anim: torch.Tensor  # [T] int32 animation id
    sph: torch.Tensor       # [S, 4] f32: centre, radius
    sph_anim: torch.Tensor  # [S] int32
    n_tris: int
    n_spheres: int
    n_anims: int            # animation rows the ids index (1: static)


def build_sweep_scene(scene) -> SweepScene:
    T, S = scene.tris, scene.spheres
    z = torch.zeros_like(T.p0[:, :1])
    tri = torch.cat([T.p0, z, T.e1, z, T.e2, z], -1)
    sph = torch.cat([S.center, S.radius[:, None]], -1)
    return SweepScene(tri.contiguous(), anim_ids(T).to(torch.int32).contiguous(),
                      sph.contiguous(), anim_ids(S).to(torch.int32).contiguous(),
                      scene.n_tris, scene.n_spheres, scene.n_anims)


def ray_tri_tile(o, d, p0, e1, e2, t_min, t_max):
    """Moller-Trumbore of rays o, d [N, 3] or [N, P, 3] against triangles
    [P, 3] (intersect.py:155): (t, u, v, valid), each [N, P]."""
    if o.dim() == 2:
        o, d = o[:, None, :], d[:, None, :]
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min[:, None])
             & (t < t_max[:, None]))
    return t, u, v, valid


def ray_sphere_tile(o, d, center, radius, t_min, t_max):
    """The stable sphere quadratic (intersect.py:189, hitable_sphere.hpp:128-151)
    of rays [N, 3] or [N, P, 3] against spheres [P]: (t, valid), t = BIG
    where not valid."""
    if o.dim() == 2:
        o, d = o[:, None, :], d[:, None, :]
    oc = o - center
    a = dot(d, d)
    half_b = dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 1e-20))
    q = -(half_b + torch.sign(half_b) * sq)
    t0 = q / torch.clamp_min(a, 1e-20)
    t1 = c / torch.where(torch.abs(q) > 1e-20, q, 1.0)
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)
    t = torch.where(tlo > t_min[:, None], tlo, thi)
    valid = (disc > 0.0) & (t > t_min[:, None]) & (t < t_max[:, None])
    return torch.where(valid, t, BIG), valid


def _object_rays(ss: SweepScene, o, d, frames):
    """Per animation [N, A, 3] object-space rays from the frames' rows (None:
    world rays for every primitive)."""
    if frames is None:
        return None
    a = torch.arange(ss.n_anims, dtype=torch.int32, device=o.device)
    o_a, d_a, _ = frames_ray_to_object(frames, a[None, :].expand(o.shape[0], -1), o, d)
    return o_a, d_a


def _tiles(n_rays, n_prims):
    step = max(32, min(1024, PLAIN_PAIRS // max(n_rays, 1)))
    return ((s, min(s + step, n_prims)) for s in range(0, n_prims, step))


def _rays_of(o, d, obj, aid):
    if obj is None:
        return o, d
    return obj[0][:, aid.long()], obj[1][:, aid.long()]


def closest_sweep_plain(ss: SweepScene, o, d, t_min, t_max, frames=None):
    """Plain version of KS1: (t, prim, u, v) of the closest hit in
    (t_min, t_max); prim = -1 and t = BIG on a miss, u = v = 0 on a sphere."""
    n = o.shape[0]
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros((n,), dtype=torch.float32, device=o.device)
    best_v = torch.zeros_like(best_u)
    obj = _object_rays(ss, o, d, frames)
    for s, e in _tiles(n, ss.n_tris):
        oi, di = _rays_of(o, d, obj, ss.tri_anim[s:e])
        rows = ss.tri[s:e]
        t, u, v, valid = ray_tri_tile(oi, di, rows[:, 0:3], rows[:, 4:7], rows[:, 8:11],
                                      t_min, t_max)
        tk, k = _first_min(torch.where(valid, t, BIG))
        closer = tk < best_t
        kl = k.long()[:, None]
        best_t = torch.where(closer, tk, best_t)
        best_p = torch.where(closer, s + k, best_p)
        best_u = torch.where(closer, torch.gather(u, 1, kl)[:, 0], best_u)
        best_v = torch.where(closer, torch.gather(v, 1, kl)[:, 0], best_v)
    for s, e in _tiles(n, ss.n_spheres):
        oi, di = _rays_of(o, d, obj, ss.sph_anim[s:e])
        rows = ss.sph[s:e]
        t, _ = ray_sphere_tile(oi, di, rows[:, 0:3], rows[:, 3], t_min, t_max)
        tk, k = _first_min(t)
        closer = tk < best_t
        best_t = torch.where(closer, tk, best_t)
        best_p = torch.where(closer, ss.n_tris + s + k, best_p)
        best_u = torch.where(closer, 0.0, best_u)
        best_v = torch.where(closer, 0.0, best_v)
    return best_t, best_p, best_u, best_v


def any_sweep_plain(ss: SweepScene, o, d, t_min, t_max, frames=None):
    """Plain version of KS2: True where any primitive is hit in (t_min, t_max)."""
    n = o.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=o.device)
    obj = _object_rays(ss, o, d, frames)
    for s, e in _tiles(n, ss.n_tris):
        oi, di = _rays_of(o, d, obj, ss.tri_anim[s:e])
        rows = ss.tri[s:e]
        occ |= ray_tri_tile(oi, di, rows[:, 0:3], rows[:, 4:7], rows[:, 8:11], t_min,
                            t_max)[3].any(1)
    for s, e in _tiles(n, ss.n_spheres):
        oi, di = _rays_of(o, d, obj, ss.sph_anim[s:e])
        rows = ss.sph[s:e]
        occ |= ray_sphere_tile(oi, di, rows[:, 0:3], rows[:, 3], t_min, t_max)[1].any(1)
    return occ


def check_frames(frames: Optional[torch.Tensor], n_anims: int, device):
    """Validate the animation rows a sweep or K3a reads: [A, 30] f32
    contiguous (every animation at the frame's one instant), A the scene's
    animation rows."""
    if frames is None:
        return
    if (frames.dtype != torch.float32 or tuple(frames.shape) != (n_anims, FRAME_WIDTH)
            or not frames.is_contiguous()):
        raise ValueError(f"frames: need contiguous float32 [{n_anims}, {FRAME_WIDTH}], "
                         f"got {frames.dtype} {tuple(frames.shape)}")
    if frames.device != device:
        raise ValueError(f"frames are on {frames.device}, rays on {device}")


def _check(name, ss: SweepScene, o, d, t_min, t_max, frames):
    _check_rays(o, d, t_min, t_max)
    if ss.tri.device != o.device or ss.sph.device != o.device:
        raise ValueError(f"{name}: SweepScene is on {ss.tri.device}, rays on {o.device}")
    check_frames(frames, ss.n_anims, o.device)
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {o.device}")


def closest_sweep(ss: SweepScene, o, d, t_min, t_max, frames=None):
    """Closest hit (t, prim, u, v) of rays [N] by the sweep (KS1); `frames`
    (scene/animation.anim_frames) takes each primitive's test into its
    animation's object space."""
    _check("closest_sweep", ss, o, d, t_min, t_max, frames)
    if o.device.type == "cpu":
        return closest_sweep_plain(ss, o, d, t_min, t_max, frames)
    lib = native.load_kernels()
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    code = lib.wpt_sweep_closest(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n, ss.tri.data_ptr(),
        ss.tri_anim.data_ptr(), ss.n_tris, ss.sph.data_ptr(), ss.sph_anim.data_ptr(),
        ss.n_spheres, 0 if frames is None else frames.data_ptr(), t.data_ptr(),
        prim.data_ptr(), u.data_ptr(), v.data_ptr(), native.stream_ptr(o))
    native.check(code, "sweep_closest")
    native.LAUNCHES["sweep_closest"] += 1
    return t, prim, u, v


def any_sweep(ss: SweepScene, o, d, t_min, t_max, frames=None):
    """Occlusion of rays [N] in (t_min, t_max) by the sweep (KS2); t_max <=
    t_min means not occluded."""
    _check("any_sweep", ss, o, d, t_min, t_max, frames)
    if o.device.type == "cpu":
        return any_sweep_plain(ss, o, d, t_min, t_max, frames)
    lib = native.load_kernels()
    n = o.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=o.device)
    code = lib.wpt_sweep_any(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n, ss.tri.data_ptr(),
        ss.tri_anim.data_ptr(), ss.n_tris, ss.sph.data_ptr(), ss.sph_anim.data_ptr(),
        ss.n_spheres, 0 if frames is None else frames.data_ptr(), occ.data_ptr(),
        native.stream_ptr(o))
    native.check(code, "sweep_any")
    native.LAUNCHES["sweep_any"] += 1
    return occ
