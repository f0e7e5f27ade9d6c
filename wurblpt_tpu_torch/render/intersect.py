"""Closest/any hit and hit-record assembly (port of ``wurblpt_tpu/render/intersect.py``).

`scene_raw_hit` and `scene_any_hit` dispatch on the scene's accelerator: the
port's BVH (K5/K6, :mod:`wurblpt_tpu_torch.accel.traverse`), the
brute-force table of the K1 form (K1/K2, :mod:`.intersect_brute`) or the
sweeps (KS1/KS2, :mod:`.intersect_sweep`), as `integrator.prepare_scene`
chose it by the JAX package's rule. An animated scene passes its
animations' frames (scene/animation.anim_frames), which the sweeps and the
BVH take. `watertight_tri` is the BVH's triangle leaf test, op for op as the
JAX package computes it.

`assemble_hit` is K3 (``csrc/assemble_hit.cu``; with animation frames its
animated branch K3a): a hand-written CUDA kernel on CUDA tensors, its plain
PyTorch version `assemble_hit_plain` on CPU tensors. Both read the
winner's row of the packed tables of `HitTables`; K3a builds the hit in the
winner's object space and pushes its frame back to world, with the rows at
the frame's instant or, under motion blur, each lane's own.
Where the ray, the hit tables or the frame rows require grad,
`assemble_hit` runs on the tape through `backward.AssembleHit` (its
backward is K3T, or K3aT with frames, which also differentiate the
winner's intersection). `assemble_hit_k4` is its K4
form, which a K4 step calls: the fields of one
shade class's set (`K4_FIELDS`) on hit lanes only, into buffers the step
allocates once (`hit_buffers`); a miss lane's record and the fields outside
the set are left as they were, and no K4 reader looks at them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import native
from ..core.onb import onb_from_normal
from ..core.vecmath import cross, dot, normalize, safe_sqrt
from ..scene.animation import frames_ray_to_object, matvec
from ..scene.ir import BVHArrays, anim_ids
from .intersect_brute import BIG, any_hit, closest_hit
from .intersect_sweep import SweepScene, any_sweep, check_frames, closest_sweep

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
    tri_anim: torch.Tensor  # [T] int32 animation id (K3a)
    sph_anim: torch.Tensor  # [S] int32
    n_anims: int
    tri_g: Optional[torch.Tensor] = None  # [T, 9] f32: p0 e1 e2, the winners' geometry (K3T)


def build_hit_tables(scene) -> HitTables:
    T, S = scene.tris, scene.spheres
    gn = normalize(cross(T.e1, T.e2))
    tri_f = torch.cat([T.n0, T.n1, T.n2, T.uv0, T.uv1, T.uv2, T.tan0, T.tan1, T.tan2, gn], -1)
    tri_i = torch.stack([T.mat, T.flags], -1).to(torch.int32)
    sph_f = torch.cat([S.center, S.radius[:, None]], -1)
    return HitTables(tri_f.contiguous(), tri_i.contiguous(), sph_f.contiguous(),
                     S.mat.to(torch.int32).contiguous(), scene.n_tris, scene.n_spheres,
                     anim_ids(T).to(torch.int32).contiguous(),
                     anim_ids(S).to(torch.int32).contiguous(), scene.n_anims,
                     torch.cat([T.p0, T.e1, T.e2], -1).contiguous())


# The hit record's fields that each K4 shade reads (csrc/wavefront.cu
# wpt_shade_diffuse, wpt_shade_env, wpt_shade_lit): the K4 form of K3 computes
# and writes these only. No shade reads uv, the diffuse shade no tangent, the
# env shade no geometric normal.
K4_FIELDS = {
    "diffuse": ("position", "normal", "geom_normal", "backside", "mat"),
    "env": ("position", "normal", "tangent", "backside", "mat"),
    "lit": ("position", "normal", "geom_normal", "tangent", "backside", "mat"),
}
# A field's bit in wpt_assemble_hit_k4's `fields` (csrc/assemble_hit.cu F_*),
# its dtype and its width per lane.
_FIELDS = {"position": (1, torch.float32, 3), "normal": (2, torch.float32, 3),
           "geom_normal": (4, torch.float32, 3), "tangent": (8, torch.float32, 3),
           "mat": (32, torch.int32, 0), "backside": (64, torch.bool, 0)}


def hit_buffers(fields, n: int, device) -> HitRecord:
    """The K4 form's output buffers for n lanes and the field set `fields`
    (one of K4_FIELDS'): an empty tensor for each field of the set, None for
    every other field (t, hit and prim too)."""
    _k4_bits(fields)
    rec = dict.fromkeys(HitRecord._fields)
    for f in fields:
        _, dtype, width = _FIELDS[f]
        rec[f] = torch.empty((n, width) if width else (n,), dtype=dtype, device=device)
    return HitRecord(**rec)


def _k4_bits(fields) -> int:
    """wpt_assemble_hit_k4's `fields` for a field set; raises unless the set
    is one of K4_FIELDS'."""
    if set(fields) not in [set(v) for v in K4_FIELDS.values()]:
        raise ValueError(f"assemble_hit_k4: no field set {sorted(fields)}; the K4 form takes "
                         f"those of {sorted(K4_FIELDS)} (K4_FIELDS)")
    return sum(_FIELDS[f][0] for f in fields)


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


def _static_only(accel, frames):
    if frames is not None:
        raise ValueError(f"animation frames need the sweeps or a BVH, not "
                         f"{type(accel).__name__}")


def scene_raw_hit(accel, o, d, t_min, t_max, frames=None):
    """Closest hit over all primitives: (t, prim, u, v); prim = -1 on a miss.

    `accel` is the scene's BVHArrays (K5), its BruteScene (K1) or its
    SweepScene (KS1); `frames` the animations' rows of an animated scene
    (the sweeps and the BVH)."""
    if isinstance(accel, SweepScene):
        return closest_sweep(accel, o, d, t_min, t_max, frames)
    if isinstance(accel, BVHArrays):
        from ..accel.traverse import bvh_closest_hit  # imports this module: bind late

        return bvh_closest_hit(accel, o, d, t_min, t_max, frames)
    _static_only(accel, frames)
    return closest_hit(accel, o, d, t_min, t_max)


def scene_any_hit(accel, o, d, t_min, t_max, frames=None):
    """Occlusion test (shadow rays): True where any primitive is hit in
    (t_min, t_max); K6 on a BVH, K2 on a BruteScene, KS2 on a SweepScene."""
    if isinstance(accel, SweepScene):
        return any_sweep(accel, o, d, t_min, t_max, frames)
    if isinstance(accel, BVHArrays):
        from ..accel.traverse import bvh_any_hit

        return bvh_any_hit(accel, o, d, t_min, t_max, frames)
    _static_only(accel, frames)
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


def assemble_hit_plain(ht: HitTables, o, d, t, prim, u, v, frames=None) -> HitRecord:
    """Plain version of K3 (intersect.assemble_hit) and, with the animations'
    `frames`, of K3a.

    Interpolated normal / uv / Gram-Schmidt tangent, front-face flip and
    backside flag as hitable_triangle.hpp:276-325. With `frames` the
    attributes are those of the winner's object space (a sphere's normal
    from the hit point there), and the normals go back to world by the
    normal matrix R diag(1/s), the tangent by the forward map R diag(s), each
    normalized (intersect.py:510-530, :605-620). A miss lane's object-space
    point uses t = 1, as its position does (the JAX package's uses BIG: a
    placeholder either way)."""
    hit = prim >= 0
    prim_safe = torch.clamp_min(prim, 0).long()
    is_tri = hit & (prim_safe < ht.n_tris)
    t_pos = torch.where(hit, t, 1.0)
    position = o + t_pos[..., None] * d
    zeros3 = torch.zeros_like(position)
    pos_local = position
    if frames is not None:
        zi = torch.zeros_like(prim)
        aid_t = ht.tri_anim[torch.clamp(prim_safe, 0, ht.n_tris - 1)] if ht.n_tris else zi
        aid_s = (ht.sph_anim[torch.clamp(prim_safe - ht.n_tris, 0, ht.n_spheres - 1)]
                 if ht.n_spheres else zi)
        o_obj, d_obj, rows = frames_ray_to_object(frames, torch.where(is_tri, aid_t, aid_s), o, d)
        pos_local = o_obj + t_pos[..., None] * d_obj

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
        local = (pos_local - srow[:, 0:3]) / torch.clamp_min(srow[:, 3], 1e-20)[:, None]
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
    if frames is not None:
        m_fwd = rows[:, 12:21].reshape(-1, 3, 3)
        m_nrm = rows[:, 21:30].reshape(-1, 3, 3)
        normal = normalize(matvec(m_nrm, normal))
        geom_normal = normalize(matvec(m_nrm, geom_normal))
        tangent = normalize(matvec(m_fwd, tangent))

    backside = dot(d, geom_normal) > 0.0
    flip = torch.where(backside, -1.0, 1.0)[:, None]
    return HitRecord(t=t, hit=hit, prim=torch.where(hit, prim, -1), position=position,
                     normal=normal * flip, geom_normal=geom_normal * flip, tangent=tangent,
                     uv=uv_out, backside=backside & hit,
                     mat=torch.where(hit, mat, 0).to(torch.int32))


def _check_hit_inputs(name, ht: HitTables, o, d, t, prim, u, v, frames) -> int:
    """Raise unless a closest cast's winners are contiguous rows of the
    kernels' dtypes and shapes on the tables' device; returns n."""
    n = o.shape[0]
    for f, x, dtype, shape in (("o", o, torch.float32, (n, 3)), ("d", d, torch.float32, (n, 3)),
                               ("t", t, torch.float32, (n,)), ("prim", prim, torch.int32, (n,)),
                               ("u", u, torch.float32, (n,)), ("v", v, torch.float32, (n,))):
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{f}: need contiguous {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != o.device or ht.tri_f.device != o.device:
            raise ValueError(f"{name}: tensors on different devices")
    check_frames(frames, ht.n_anims, o.device, n)
    return n


def _table_args(ht: HitTables, o, d, t, prim, u, v, n):
    return (o.data_ptr(), d.data_ptr(), t.data_ptr(), prim.data_ptr(), u.data_ptr(),
            v.data_ptr(), n, ht.tri_f.data_ptr(), ht.tri_i.data_ptr(), ht.n_tris,
            ht.sph_f.data_ptr(), ht.sph_mat.data_ptr(), ht.n_spheres)


def _needs_grad(ht: HitTables, o, d, frames=None) -> bool:
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (o, d, ht.tri_f, ht.sph_f, ht.tri_g, frames))


def assemble_hit(ht: HitTables, o, d, t, prim, u, v, frames=None) -> HitRecord:
    """HitRecord of the winners of a closest-hit cast (K3; K3a with the
    animations' `frames`, scene/animation.anim_frames [A, 30] or
    anim_frames_per_ray [N, A, 30]): every field of every lane (the full
    form). Where the ray, the hit tables or the frame rows require grad (and
    grad mode is on), the record and its t are on the tape, differentiated
    through the winner's intersection too: the backward is K3T, K3aT with
    `frames` (render/backward.py `AssembleHit`)."""
    if _needs_grad(ht, o, d, frames):
        if ht.tri_g is None:
            raise ValueError("assemble_hit: a differentiable assembly needs HitTables.tri_g")
        from .backward import AssembleHit

        t_, pos, nrm, gn, tan, uv, mat, backside = AssembleHit.apply(
            ht, o, d, t, prim, u, v, ht.tri_g, ht.tri_f, ht.sph_f, frames)
        return HitRecord(t=t_, hit=prim >= 0, prim=prim, position=pos, normal=nrm,
                         geom_normal=gn, tangent=tan, uv=uv, backside=backside, mat=mat)
    return assemble_hit_raw(ht, o, d, t, prim, u, v, frames)


def assemble_hit_raw(ht: HitTables, o, d, t, prim, u, v, frames=None) -> HitRecord:
    """K3 (K3a with `frames`) without a tape: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    n = _check_hit_inputs("assemble_hit", ht, o, d, t, prim, u, v, frames)
    stride = check_frames(frames, ht.n_anims, o.device, n)
    if o.device.type == "cpu":
        return assemble_hit_plain(ht, o, d, t, prim, u, v, frames)
    if o.device.type != "cuda":
        raise ValueError(f"assemble_hit: no kernel for device {o.device}")
    lib = native.load_kernels()
    pos = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    nrm, gn, tan = torch.empty_like(pos), torch.empty_like(pos), torch.empty_like(pos)
    uv = torch.empty((n, 2), dtype=torch.float32, device=o.device)
    mat = torch.empty((n,), dtype=torch.int32, device=o.device)
    backside = torch.empty((n,), dtype=torch.bool, device=o.device)
    args = _table_args(ht, o, d, t, prim, u, v, n)
    outs = (pos.data_ptr(), nrm.data_ptr(), gn.data_ptr(), tan.data_ptr(), uv.data_ptr(),
            mat.data_ptr(), backside.data_ptr(), native.stream_ptr(o))
    if frames is None:
        code = lib.wpt_assemble_hit(*args, *outs)
        name = "assemble_hit"
    else:
        code = lib.wpt_assemble_hit_anim(*args, ht.tri_anim.data_ptr(), ht.sph_anim.data_ptr(),
                                         frames.data_ptr(), stride, *outs)
        name = "assemble_hit_anim"
    native.check(code, name)
    native.LAUNCHES[name] += 1
    hit = prim >= 0
    return HitRecord(t=t, hit=hit, prim=prim, position=pos, normal=nrm, geom_normal=gn,
                     tangent=tan, uv=uv, backside=backside, mat=mat)


def assemble_hit_k4(ht: HitTables, o, d, t, prim, u, v, frames, out: HitRecord) -> HitRecord:
    """K3's K4 form (wpt_assemble_hit_k4; K3a's with the animations'
    `frames`): the record of one K4 shade class, written into `out`
    (`hit_buffers` of one of K4_FIELDS' sets) on hit lanes (prim >= 0) only.
    Each field a hit lane gets is the full form's to the bit; a miss or dead
    lane's rows and the fields outside the set are not written (on CPU
    tensors the plain version's every lane is copied in). Returns the record
    with t and prim, the set's fields from `out`, and None for `hit` and
    every other field: a reader tests prim >= 0 itself. The rows are the
    frame's one instant's ([A, 30]): a frame over a shutter takes the pass
    renderer."""
    n = _check_hit_inputs("assemble_hit_k4", ht, o, d, t, prim, u, v, frames)
    if frames is not None and frames.dim() != 2:
        raise ValueError("assemble_hit_k4: the K4 form takes the frame's one instant's rows "
                         "[A, 30], not per-ray rows")
    fields = [f for f in HitRecord._fields[3:] if getattr(out, f) is not None]
    bits = _k4_bits(fields)
    for f in fields:
        x, (_, dtype, width) = getattr(out, f), _FIELDS[f]
        shape = (n, width) if width else (n,)
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() or \
                x.device != o.device:
            raise ValueError(f"assemble_hit_k4: out.{f} needs contiguous {dtype} {shape} on "
                             f"{o.device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    rec = out._replace(t=t, prim=prim, hit=None)
    if o.device.type == "cpu":
        plain = assemble_hit_plain(ht, o, d, t, prim, u, v, frames)
        for f in fields:
            getattr(out, f).copy_(getattr(plain, f))
        return rec
    if o.device.type != "cuda":
        raise ValueError(f"assemble_hit_k4: no kernel for device {o.device}")
    lib = native.load_kernels()
    anim = frames is not None
    code = lib.wpt_assemble_hit_k4(
        *_table_args(ht, o, d, t, prim, u, v, n), ht.tri_anim.data_ptr(), ht.sph_anim.data_ptr(),
        frames.data_ptr() if anim else None, bits,
        *(None if getattr(out, f) is None else getattr(out, f).data_ptr()
          for f in ("position", "normal", "geom_normal", "tangent", "mat", "backside")),
        native.stream_ptr(o))
    name = "assemble_hit_k4_anim" if anim else "assemble_hit_k4"
    native.check(code, name)
    native.LAUNCHES[name] += 1
    return rec
