"""Brute-force ray casts for small static scenes: K1 (closest hit) and K2 (any hit).

Port of ``wurblpt_tpu/render/intersect_mxu.py``. The JAX package tests every
ray against every primitive with one feature-matrix product on the TPU's
matrix unit. On the GPU the same four linear functionals per triangle (and
two per sphere) are evaluated by hand-written CUDA kernels
(``csrc/closest_hit.cu``, ``csrc/any_hit.cu``) on the live rays of each
tile, queued in shared memory (``csrc/live_queue.cuh``), up to 8 threads to
a ray (K2 on a table of at most 16 primitives: a thread per lane).

Each kernel has a plain PyTorch version beside it, term for term the same
arithmetic. The wrappers `closest_hit` and `any_hit` run the plain version on
CPU tensors and the kernel on CUDA tensors; on CUDA there is no fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..core.vecmath import cross, dot

BIG = 3.0e37
# The JAX package's matrix form takes 4 columns per triangle and 2 per sphere,
# each kind padded to a multiple of 128, up to 4 x MXU_MAX_PRIMS (2048)
# (intersect.py:296-306). A scene without a BVH past it is swept
# (intersect_sweep.py), as is every animated one.
MAX_COLUMNS = 4 * 2048


class BruteScene(NamedTuple):
    """Loop-invariant primitive tables of the brute-force casts (see brute_common.cuh)."""

    tri: torch.Tensor      # [T, 16] f32: n, p0n | a2, e2.x | e2.yz, a1.xy | a1.z, e1
    sph: torch.Tensor      # [S, 4] f32: centre - c, |centre - c|^2 - r^2
    center: tuple          # scene centre c (3 Python floats)
    n_tris: int
    n_spheres: int


def feature_columns(n_tris: int, n_spheres: int) -> int:
    """Columns of the JAX package's feature matrix: 4 per triangle, 2 per
    sphere, each kind padded to a multiple of 128."""
    return 4 * (-(-n_tris // 128) * 128) + 2 * (-(-n_spheres // 128) * 128)


def brute_eligible(scene) -> bool:
    """Whether K1/K2 cast the scene: the JAX package's `mxu_eligible` (a
    static scene, no BVH, 0 < columns <= 8192). Other scenes without a BVH
    take the sweeps (KS1/KS2)."""
    return (not scene.has_bvh and scene.n_anims <= 1
            and 0 < feature_columns(scene.n_tris, scene.n_spheres) <= MAX_COLUMNS)


def _window_sums(x):
    """Sums over axis 1 of [k, w, 3], each window added in order."""
    acc = torch.zeros_like(x[:, 0])
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def scene_centre(pts):
    """Mean of the points [n, 3] as the JAX package's build_mxu_scene gets it
    from XLA on the CPU: a tree of sums over windows of 32 rows (the rows
    zero-padded evenly at both ends to a multiple of 32), each window summed
    in order, times float32(1 / n). The casts depend on the centre's last
    bits (a sphere's quadratic cancels against it), so the port takes the
    same ones. All windows of a level are summed together: 32 adds per level."""
    n = pts.shape[0]
    rows = pts
    while rows.shape[0] > 32:
        pad = -rows.shape[0] % 32
        z = torch.zeros((1, 3), dtype=rows.dtype, device=rows.device)
        rows = torch.cat([z.expand(pad // 2, 3), rows, z.expand(pad - pad // 2, 3)])
        rows = _window_sums(rows.reshape(-1, 32, 3))
    return _window_sums(rows[None])[0] * float(np.float32(1.0) / np.float32(n))


def build_brute_scene(scene) -> BruteScene:
    """Primitive tables, re-centred on the mean of the primitives' reference
    points so the o x d cancellation stays bounded by the scene extent."""
    nt, ns = scene.n_tris, scene.n_spheres
    c = scene_centre(torch.cat([scene.tris.p0, scene.spheres.center], 0))
    p = scene.tris.p0 - c
    e1, e2 = scene.tris.e1, scene.tris.e2
    n = cross(e1, e2)
    tri = torch.cat([n, dot(p, n, keepdim=True), cross(p, e2), e2, cross(p, e1), e1], -1)
    sc = scene.spheres.center - c
    r = scene.spheres.radius
    sph = torch.cat([sc, (dot(sc, sc) - r * r)[:, None]], -1)
    return BruteScene(tri.contiguous(), sph.contiguous(), tuple(c.tolist()), nt, ns)


def _ray_terms(bs: BruteScene, o, d):
    c = torch.tensor(bs.center, dtype=o.dtype, device=o.device)
    oc = o - c
    return oc, cross(oc, d), fma_dot(oc, d), fma_dot(oc, oc), fma_dot(d, d)


def _tri_terms(bs: BruteScene, o, d, t_min, t_max):
    """[N, T] (valid, det, t_num, u_num, v_num) of every ray/triangle pair."""
    oc, x, _, _, _ = _ray_terms(bs, o, d)
    k = bs.tri.T[:, None, :]                           # [16, 1, T]
    r = [v[:, None] for v in (*oc.unbind(-1), *d.unbind(-1), *x.unbind(-1))]
    ox, oy, oz, dx, dy, dz, xx, xy, xz = r
    det = -(dx * k[0] + dy * k[1] + dz * k[2])
    tn = -k[3] + ox * k[0] + oy * k[1] + oz * k[2]
    un = dx * k[4] + dy * k[5] + dz * k[6] + xx * k[7] + xy * k[8] + xz * k[9]
    vn = -(dx * k[10] + dy * k[11] + dz * k[12] + xx * k[13] + xy * k[14] + xz * k[15])
    s = torch.sign(det)
    ad = torch.abs(det)
    valid = ((ad > 1e-12) & (un * s >= 0.0) & (vn * s >= 0.0) & ((un + vn) * s <= ad)
             & (tn * s > t_min[:, None] * ad) & (tn * s < t_max[:, None] * ad))
    return valid, det, tn, un, vn


def fma(a, b, c):
    """float32 a * b + c rounded once, as the kernels' fmaf rounds it.

    float64 holds the product of two float32 exactly; their sum s is exact up
    to e (TwoSum). Rounding s to float32 is then right unless s sits exactly
    halfway between two float32 values while e != 0: there e picks the side."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.to(torch.float32)
    half = s - r.double()                      # s - r; a tie when r + 2 half is a float32
    other = (r.double() + 2.0 * half).to(torch.float32)
    tie = (half != 0) & (other.double() == r.double() + 2.0 * half)
    return torch.where(tie & (e != 0) & ((e > 0) == (half > 0)), other, r)


def fma_dot(a, b):
    """a . b over the last axis of [..., 3], accumulated with fused
    multiply-adds from the first component on."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _sphere_terms(bs: BruteScene, o, d, t_min, t_max):
    """[N, S] (valid, t) of every ray/sphere pair.

    The rounding is that of the JAX package's feature product as XLA's CPU
    backend evaluates it inside the render: one dot accumulated with fused
    multiply-adds in column order (cq from its constant term on), the ray's
    dot products and the discriminant contracted into FMAs too. On the ray's
    own sphere cq cancels down to its last bits, and they decide a
    self-intersection: another rounding of the same formula moved rtiow's
    cast count by 1-3 %."""
    oc, _, od, oo, dd = _ray_terms(bs, o, d)
    k = bs.sph.T[:, None, :]                           # [4, 1, S]
    ox, oy, oz, dx, dy, dz = (v[:, None] for v in (*oc.unbind(-1), *d.unbind(-1)))
    od, oo, dd = od[:, None], oo[:, None], dd[:, None]
    half_b = fma(dz, -k[2], fma(dy, -k[1], dx * -k[0])) + od
    cq = fma(oz, -2.0 * k[2], fma(oy, -2.0 * k[1], fma(ox, -2.0 * k[0], k[3]))) + oo
    disc = fma(half_b, half_b, -(dd * cq))
    sq = torch.sqrt(torch.clamp_min(disc, 1e-20))
    q = -(half_b + torch.sign(half_b) * sq)
    t0 = q / torch.clamp_min(dd, 1e-20)
    t1 = cq / torch.where(torch.abs(q) > 1e-20, q, 1.0)
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)
    ts = torch.where(tlo > t_min[:, None], tlo, thi)
    valid = (disc > 0.0) & (ts > t_min[:, None]) & (ts < t_max[:, None])
    return valid, ts


def candidate_t(bs: BruteScene, o, d, t_min, t_max):
    """[N, T + S] hit distance of every ray/primitive pair, BIG where invalid."""
    valid, det, tn, _, _ = _tri_terms(bs, o, d, t_min, t_max)
    t_tri = torch.where(valid, tn / torch.where(det == 0.0, 1.0, det), BIG)
    valid_s, ts = _sphere_terms(bs, o, d, t_min, t_max)
    return torch.cat([t_tri, torch.where(valid_s, ts, BIG)], 1)


def _first_min(t_all):
    """(min, lowest index attaining it) per row."""
    tk = t_all.min(1).values
    ids = torch.arange(t_all.shape[1], device=t_all.device, dtype=torch.int32)
    k = torch.where(t_all <= tk[:, None], ids, 0x7FFFFFFF).min(1).values
    return tk, k


def closest_hit_plain(bs: BruteScene, o, d, t_min, t_max):
    """Plain version of K1: (t, prim, u, v); prim = -1 and t = BIG on a miss.

    Ties go to the lowest prim id, triangles before spheres
    (intersect_mxu._decode_closest)."""
    n = o.shape[0]
    dev = o.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    if bs.n_tris:
        valid, det, tn, un, vn = _tri_terms(bs, o, d, t_min, t_max)
        t_all = torch.where(valid, tn / torch.where(det == 0.0, 1.0, det), BIG)
        tk, k = _first_min(t_all)
        hit = tk < best_t
        kl = k.long()[:, None]
        inv_det = 1.0 / torch.gather(torch.where(det == 0.0, 1.0, det), 1, kl)[:, 0]
        best_u = torch.where(hit, torch.gather(un, 1, kl)[:, 0] * inv_det, 0.0)
        best_v = torch.where(hit, torch.gather(vn, 1, kl)[:, 0] * inv_det, 0.0)
        best_t = torch.where(hit, tk, best_t)
        best_prim = torch.where(hit, k, best_prim)
    if bs.n_spheres:
        valid_s, ts = _sphere_terms(bs, o, d, t_min, t_max)
        tj, j = _first_min(torch.where(valid_s, ts, BIG))
        closer = tj < best_t
        best_prim = torch.where(closer, bs.n_tris + j, best_prim)
        best_t = torch.where(closer, tj, best_t)
        best_u = torch.where(closer, 0.0, best_u)
        best_v = torch.where(closer, 0.0, best_v)
    return best_t, best_prim, best_u, best_v


def any_hit_plain(bs: BruteScene, o, d, t_min, t_max):
    """Plain version of K2: True where any primitive is hit in (t_min, t_max)."""
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    if bs.n_tris:
        occ |= _tri_terms(bs, o, d, t_min, t_max)[0].any(1)
    if bs.n_spheres:
        occ |= _sphere_terms(bs, o, d, t_min, t_max)[0].any(1)
    return occ


def _check_rays(o, d, t_min, t_max):
    n = o.shape[0]
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("t_min", t_min, (n,)), ("t_max", t_max, (n,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: need contiguous float32 {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, o on {o.device}")


def _check_scene(bs: BruteScene, device):
    if bs.tri.device != device or bs.sph.device != device:
        raise ValueError(f"BruteScene is on {bs.tri.device}, rays on {device}")


def closest_hit(bs: BruteScene, o, d, t_min, t_max):
    """Closest hit (t, prim, u, v) of rays [N] against the whole scene (K1)."""
    _check_rays(o, d, t_min, t_max)
    _check_scene(bs, o.device)
    if o.device.type == "cpu":
        return closest_hit_plain(bs, o, d, t_min, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"closest_hit: no kernel for device {o.device}")
    lib = native.load_kernels()
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    prim = torch.empty((n,), dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    code = lib.wpt_closest_hit(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n,
        bs.tri.data_ptr(), bs.n_tris, bs.sph.data_ptr(), bs.n_spheres, *bs.center,
        t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), native.stream_ptr(o))
    native.check(code, "closest_hit")
    native.LAUNCHES["closest_hit"] += 1
    return t, prim, u, v


def any_hit(bs: BruteScene, o, d, t_min, t_max):
    """Occlusion of rays [N] in (t_min, t_max) (K2); t_max <= t_min means not occluded."""
    _check_rays(o, d, t_min, t_max)
    _check_scene(bs, o.device)
    if o.device.type == "cpu":
        return any_hit_plain(bs, o, d, t_min, t_max)
    if o.device.type != "cuda":
        raise ValueError(f"any_hit: no kernel for device {o.device}")
    lib = native.load_kernels()
    n = o.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=o.device)
    code = lib.wpt_any_hit(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), n,
        bs.tri.data_ptr(), bs.n_tris, bs.sph.data_ptr(), bs.n_spheres, *bs.center,
        occ.data_ptr(), native.stream_ptr(o))
    native.check(code, "any_hit")
    native.LAUNCHES["any_hit"] += 1
    return occ
