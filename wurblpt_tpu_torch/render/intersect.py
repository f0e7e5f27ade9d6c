"""Closest/any hit and hit-record assembly (port of ``wurblpt_tpu/render/intersect.py``
for static scenes).

`scene_raw_hit` and `scene_any_hit` dispatch on the scene's accelerator: the
port's BVH (K5/K6, :mod:`wurblpt_tpu_torch.accel.traverse`) or the
brute-force table (K1/K2, :mod:`.intersect_brute`). `watertight_tri` is the
leaf test of the BVH path, op for op as the JAX package computes it.

`assemble_hit` is K3: a hand-written CUDA kernel (``csrc/assemble_hit.cu``)
on CUDA tensors, its plain PyTorch version `assemble_hit_plain` on CPU
tensors. Both read the winner's row of the packed tables of `HitTables`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import native
from ..core.onb import onb_from_normal
from ..core.vecmath import cross, dot, normalize, safe_sqrt
from ..scene.ir import BVHArrays
from .intersect_brute import BIG, any_hit, closest_hit

_INV_2PI = 1.0 / (2.0 * math.pi)
_INV_PI = 1.0 / math.pi


class HitRecord(NamedTuple):
    """Per-ray hit data (reference HitRecord, hitable.hpp:39-64)."""

    t: torch.Tensor           # [N] hit distance (BIG on a miss)
    hit: torch.Tensor         # [N] bool
    prim: torch.Tensor        # [N] int32 global prim id (tri i, sphere T + j), -1 on a miss
    position: torch.Tensor    # [N, 3]
    normal: torch.Tensor      # [N, 3] shading normal (front-facing)
    geom_normal: torch.Tensor  # [N, 3] geometric normal (front-facing)
    tangent: torch.Tensor     # [N, 3]
    uv: torch.Tensor          # [N, 2]
    backside: torch.Tensor    # [N] bool
    mat: torch.Tensor         # [N] int32


class HitTables(NamedTuple):
    """Per-primitive attribute rows that K3 reads (one row per winner)."""

    tri_f: torch.Tensor    # [T, 27] f32: n0 n1 n2 | uv0 uv1 uv2 | tan0 tan1 tan2 | gn
    tri_i: torch.Tensor    # [T, 2] int32: material, flags
    sph_f: torch.Tensor    # [S, 4] f32: centre, radius
    sph_mat: torch.Tensor  # [S] int32
    n_tris: int
    n_spheres: int


def build_hit_tables(scene) -> HitTables:
    T, S = scene.tris, scene.spheres
    gn = normalize(cross(T.e1, T.e2))
    tri_f = torch.cat([T.n0, T.n1, T.n2, T.uv0, T.uv1, T.uv2, T.tan0, T.tan1, T.tan2, gn], -1)
    tri_i = torch.stack([T.mat, T.flags], -1).to(torch.int32)
    sph_f = torch.cat([S.center, S.radius[:, None]], -1)
    return HitTables(tri_f.contiguous(), tri_i.contiguous(), sph_f.contiguous(),
                     S.mat.to(torch.int32).contiguous(), scene.n_tris, scene.n_spheres)


def _two_prod(a, b):
    """Dekker/Veltkamp exact product: a * b == p + err in f32, without an FMA."""
    p = a * b
    ac = a * 4097.0
    ah = ac - (ac - a)
    al = a - ah
    bc = b * 4097.0
    bh = bc - (bc - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _diff_of_products(a, b, c, d):
    """a * b - c * d, compensated: its sign is right under cancellation."""
    p1, e1 = _two_prod(a, b)
    p2, e2 = _two_prod(c, d)
    return (p1 - p2) + (e1 - e2)


def _comp(x, k):
    """x[..., k] for a per-element axis index k (broadcast against x[..., 0])."""
    return torch.where(k == 0, x[..., 0], torch.where(k == 1, x[..., 1], x[..., 2]))


def watertight_tri(o, d, v0, v1, v2, t_min, t_max):
    """Watertight ray/triangle test (Woop et al.; hitable_triangle.hpp:189-274).

    o, d [..., 3] broadcast against the ABSOLUTE vertices v0/v1/v2 [..., 3];
    t_min/t_max broadcast to the result. Returns (t, u, v, valid) with u, v
    the barycentric weights of v1, v2 and t = BIG where not valid. Where an
    edge function falls under 1.1e-19 (the reference's long-double epsilon)
    all three are recomputed with two-product compensation instead of f64."""
    kz = torch.argmax(torch.abs(d), -1)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    dz = _comp(d, kz)
    neg = dz < 0
    kx, ky = torch.where(neg, ky, kx), torch.where(neg, kx, ky)
    dx = _comp(d, kx)
    dy = _comp(d, ky)
    sz = 1.0 / dz
    sx = dx * sz
    sy = dy * sz

    def shear(p):
        rel = p - o
        pz = _comp(rel, kz)
        return _comp(rel, kx) - sx * pz, _comp(rel, ky) - sy * pz, pz

    ax, ay, az = shear(v0)
    bx, by, bz = shear(v1)
    cx, cy, cz = shear(v2)
    u_e = cx * by - cy * bx
    v_e = ax * cy - ay * cx
    w_e = bx * ay - by * ax
    eps = 1.1e-19
    near = (torch.abs(u_e) < eps) | (torch.abs(v_e) < eps) | (torch.abs(w_e) < eps)
    u_e = torch.where(near, _diff_of_products(cx, by, cy, bx), u_e)
    v_e = torch.where(near, _diff_of_products(ax, cy, ay, cx), v_e)
    w_e = torch.where(near, _diff_of_products(bx, ay, by, ax), w_e)

    mixed = (((u_e < 0.0) | (v_e < 0.0) | (w_e < 0.0))
             & ((u_e > 0.0) | (v_e > 0.0) | (w_e > 0.0)))
    det = u_e + v_e + w_e
    tn = u_e * (sz * az) + v_e * (sz * bz) + w_e * (sz * cz)
    ds = torch.sign(det)
    in_range = (tn * ds > t_min * det * ds) & (tn * ds < t_max * det * ds)
    valid = (~mixed) & (det != 0.0) & in_range
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    return torch.where(valid, tn * inv_det, BIG), v_e * inv_det, w_e * inv_det, valid


def scene_raw_hit(accel, o, d, t_min, t_max):
    """Closest hit over all primitives: (t, prim, u, v); prim = -1 on a miss.

    `accel` is the scene's BVHArrays (K5) or its BruteScene (K1)."""
    if isinstance(accel, BVHArrays):
        from ..accel.traverse import bvh_closest_hit  # imports this module: bind late

        return bvh_closest_hit(accel, o, d, t_min, t_max)
    return closest_hit(accel, o, d, t_min, t_max)


def scene_any_hit(accel, o, d, t_min, t_max):
    """Occlusion test (shadow rays): True where any primitive is hit in
    (t_min, t_max); K6 on a BVH, K2 on a BruteScene."""
    if isinstance(accel, BVHArrays):
        from ..accel.traverse import bvh_any_hit

        return bvh_any_hit(accel, o, d, t_min, t_max)
    return any_hit(accel, o, d, t_min, t_max)


def _sphere_uv_tangent(n):
    """Lat/long texcoords + pole-safe tangent (hitable_sphere.hpp:43-75)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    u = 0.5 + torch.atan2(x, z) * _INV_2PI
    v = 0.5 + torch.asin(torch.clamp(y, -1.0, 1.0)) * _INV_PI
    tangent = torch.stack([z, torch.zeros_like(y), -x], -1)
    ln = safe_sqrt(dot(tangent, tangent, keepdim=True))
    one_x = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    tangent = torch.where(ln < 1e-6, one_x, tangent / torch.clamp_min(ln, 1e-20))
    return torch.stack([u, v], -1), tangent


def assemble_hit_plain(ht: HitTables, o, d, t, prim, u, v) -> HitRecord:
    """Plain version of K3 (intersect.assemble_hit, static scenes).

    Interpolated normal / uv / Gram-Schmidt tangent, front-face flip and
    backside flag as hitable_triangle.hpp:276-325."""
    hit = prim >= 0
    prim_safe = torch.clamp_min(prim, 0).long()
    is_tri = hit & (prim_safe < ht.n_tris)
    t_pos = torch.where(hit, t, 1.0)
    position = o + t_pos[..., None] * d
    zeros3 = torch.zeros_like(position)

    if ht.n_tris:
        row = ht.tri_f[torch.clamp(prim_safe, 0, ht.n_tris - 1)]
        ints = ht.tri_i[torch.clamp(prim_safe, 0, ht.n_tris - 1)]
        n0, n1, n2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        uv0, uv1, uv2 = row[:, 9:11], row[:, 11:13], row[:, 13:15]
        t0, t1, t2 = row[:, 15:18], row[:, 18:21], row[:, 21:24]
        gn = row[:, 24:27]
        w = (1.0 - u - v)[:, None]
        uu, vv = u[:, None], v[:, None]
        n_interp = normalize(w * n0 + uu * n1 + vv * n2)
        uv_tri = w * uv0 + uu * uv1 + vv * uv2
        tan_raw = w * t0 + uu * t1 + vv * t2
        has_tan = (ints[:, 1] & 2) > 0
        tan_gs = tan_raw - dot(tan_raw, n_interp, keepdim=True) * n_interp
        tan_len = safe_sqrt(dot(tan_gs, tan_gs))
        tan_fb, _ = onb_from_normal(n_interp)
        tan_tri = torch.where((has_tan & (tan_len > 1e-8))[:, None],
                              tan_gs / torch.clamp_min(tan_len, 1e-20)[:, None], tan_fb)
        mat_tri = ints[:, 0]
    else:
        n_interp = gn = tan_tri = zeros3
        uv_tri = torch.zeros_like(position[:, :2])
        mat_tri = torch.zeros_like(prim)

    if ht.n_spheres:
        si = torch.clamp(prim_safe - ht.n_tris, 0, ht.n_spheres - 1)
        srow = ht.sph_f[si]
        local = (position - srow[:, 0:3]) / torch.clamp_min(srow[:, 3], 1e-20)[:, None]
        n_sph = normalize(local)
        uv_sph, tan_sph = _sphere_uv_tangent(n_sph)
        mat_sph = ht.sph_mat[si]
    else:
        n_sph = tan_sph = zeros3
        uv_sph = torch.zeros_like(position[:, :2])
        mat_sph = torch.zeros_like(prim)

    sel = is_tri[:, None]
    normal = torch.where(sel, n_interp, n_sph)
    geom_normal = torch.where(sel, gn, n_sph)
    uv_out = torch.where(sel, uv_tri, uv_sph)
    tangent = torch.where(sel, tan_tri, tan_sph)
    mat = torch.where(is_tri, mat_tri, mat_sph)

    backside = dot(d, geom_normal) > 0.0
    flip = torch.where(backside, -1.0, 1.0)[:, None]
    return HitRecord(t=t, hit=hit, prim=torch.where(hit, prim, -1), position=position,
                     normal=normal * flip, geom_normal=geom_normal * flip, tangent=tangent,
                     uv=uv_out, backside=backside & hit,
                     mat=torch.where(hit, mat, 0).to(torch.int32))


def assemble_hit(ht: HitTables, o, d, t, prim, u, v) -> HitRecord:
    """HitRecord of the winners of a closest-hit cast (K3)."""
    n = o.shape[0]
    for name, x, dtype, shape in (("o", o, torch.float32, (n, 3)), ("d", d, torch.float32, (n, 3)),
                                  ("t", t, torch.float32, (n,)), ("prim", prim, torch.int32, (n,)),
                                  ("u", u, torch.float32, (n,)), ("v", v, torch.float32, (n,))):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != o.device or ht.tri_f.device != o.device:
            raise ValueError("assemble_hit: tensors on different devices")
    if o.device.type == "cpu":
        return assemble_hit_plain(ht, o, d, t, prim, u, v)
    if o.device.type != "cuda":
        raise ValueError(f"assemble_hit: no kernel for device {o.device}")
    lib = native.load_kernels()
    pos = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    nrm, gn, tan = torch.empty_like(pos), torch.empty_like(pos), torch.empty_like(pos)
    uv = torch.empty((n, 2), dtype=torch.float32, device=o.device)
    mat = torch.empty((n,), dtype=torch.int32, device=o.device)
    backside = torch.empty((n,), dtype=torch.bool, device=o.device)
    code = lib.wpt_assemble_hit(
        o.data_ptr(), d.data_ptr(), t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
        n, ht.tri_f.data_ptr(), ht.tri_i.data_ptr(), ht.n_tris, ht.sph_f.data_ptr(),
        ht.sph_mat.data_ptr(), ht.n_spheres, pos.data_ptr(), nrm.data_ptr(), gn.data_ptr(),
        tan.data_ptr(), uv.data_ptr(), mat.data_ptr(), backside.data_ptr(),
        native.stream_ptr(o))
    native.check(code, "assemble_hit")
    native.LAUNCHES["assemble_hit"] += 1
    hit = prim >= 0
    return HitRecord(t=t, hit=hit, prim=prim, position=pos, normal=nrm, geom_normal=gn,
                     tangent=tan, uv=uv, backside=backside, mat=mat)
