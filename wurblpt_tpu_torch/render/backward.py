"""Backward passes of the kernels on a differentiable render's path: P0's row
gather, K3's hit assembly with the winner's intersection, K8's sky
radiance and importance sample, and (re-exported) K7's measured BRDF.

The JAX package differentiates its render by autodiff through every
gather, the intersection arithmetic and the sky's bilinear lookup. Here the
forward kernels produce no tape, so each is wrapped in a
`torch.autograd.Function` whose forward is the existing wrapper (the kernel
on CUDA tensors, its plain version on CPU tensors) and whose backward is a
kernel of its own (``csrc/backward.cu``) with a plain PyTorch version:

* P0T (`row_scatter`): ``grad_table[idx[i], c] += grad_out[i, c]``, the
  scatter-add that JAX's autodiff makes of every gather; the plain version
  is `index_add_`. A table's int32 columns (bit patterns, as in the packed
  material rows) get zero cotangents: their readers reinterpret the words,
  which cuts the tape.
* K3T and K3aT (`assemble_hit_bwd`): given each lane's winner (prim, t, u, v) and
  the cotangents of the record's t, position, shading and geometric
  normal, tangent and uv, the cotangents of the ray (o, d) and,
  scatter-added into the winner's rows, of the triangle's geometry (p0,
  e1, e2: HitTables.tri_g), its attribute row (n0 n1 n2, uv, tangents and
  the geometric normal: tri_f) and the sphere's centre and radius (sph_f).
  The cast gives t, u and v without a tape; their derivatives are those of
  the hit equations: a triangle's o + t d = p0 + u e1 + v e2 (Cramer's rule
  on [d, -e1, -e2], as the Moller-Trumbore formulas of the JAX package's
  cast differentiate), a sphere's |o + t d - c| = r. K3aT, the animated
  branch, also gives the cotangent of the winner's 30-float frame row
  (scene/animation.py: r_inv, t_inv, m_fwd, m_nrm), added into the [A, 30]
  rows of the frame's instant or written to the lane's own row of [N, A,
  30] per-ray rows; autograd through the rows' construction carries it to
  the keyframe tables.
* K8T (`env_radiance_bwd`): the equirect map's bilinear lookup (wrap in u,
  clamp in v), the cube map's per-face bilinear lookup with edge clamp and
  the constant sky: cotangents of the texels (scatter-added) or of the
  constant radiance, of the direction and, where it is on the tape, of the
  map's rotation (each lane's term of dm = R(conj q) d, summed). K3T's and
  K8T's kernels sum a warp's terms for one row or texel cell before adding
  them: K3T per block in shared memory where its tables fit 48 KB, else to
  the tables; K8T to the map. K8T's sample backward (`env_sample_bwd`):
  the cotangent of the rotation from that of env_sample's direction R(q)
  d_map (the pdf carries none); its kernel skips the lanes whose cotangent
  is zero. The generic bounce's K8 pairs (`envmap.env_miss_lanes`,
  `env_nee_lanes`: one launch each under a lane mask) go on the tape as
  `EnvMiss` (K8T on the radiance) and `EnvNee` (K8T on the radiance at the
  sampled directions, then the sample's backward on the directions'
  cotangent plus K8T's); a masked lane's outputs are constants, so both
  kernels take the mask and give such a lane no cotangent.
* K7T (`rgl_bwd`): K7's eval or sample (the measured RGL BRDF). Its tail
  form, where only the tables its reflectance tail reads are on the tape,
  max(rgb, 0) x ndf / max(4 sigma, 1e-12) (`materials.rgl.TAIL_TABLES`):
  their cotangents, scatter-added into their bilinear cells, from that of
  its f*cos. Its full form, where a warp table, a parameter grid or a lane
  direction is on the tape: every float table's cotangent
  (`materials.rgl.GRAD_TABLES`) and the directions' (eval's wi and wo,
  sample's wi) from those of f*cos, the pdf and sample's wo. The plain
  version is autograd through `rgl_eval_plain` / `rgl_sample_plain`. Its
  wrapper and `autograd.Function`s live beside K7's in `materials/rgl.py`
  and are re-exported here; its kernel is in ``csrc/backward.cu`` with the
  others.

On CPU tensors each backward runs its plain version; on CUDA tensors it
launches its kernel or raises. The tests hold each plain backward to
autograd through a differentiable plain forward (`row_gather_diff_plain`,
`assemble_hit_diff_plain`, and K8's own plain versions, `envmap.env_radiance_plain`
and `envmap.env_sample_plain`), and the card holds each kernel to its plain
backward (utils/grad_check.py).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import native
from ..core.onb import onb_from_normal
from ..core.transform import quat_rotate
from ..core.vecmath import cross, dot
from ..scene.animation import frame_rows, matvec
from ..materials.rgl import RglEval, RglSample, rgl_bwd, rgl_bwd_plain  # noqa: F401  (K7T)
from . import envmap as _env
from . import intersect as _isect
from .gather import row_gather_raw

_INV_2PI = 1.0 / (2.0 * math.pi)
_INV_PI = 1.0 / math.pi


def _cuda_lib(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return native.load_kernels()


# ---------------------------------------------------------------------------
# P0T: row scatter-add
# ---------------------------------------------------------------------------

def row_scatter_plain(grad_out, idx, rows: int):
    """Plain version of P0T: [rows, C] with grad_out's row i added to row
    clamp(idx[i], 0, rows - 1) (index_add_)."""
    out = torch.zeros((rows, grad_out.shape[1]), dtype=grad_out.dtype, device=grad_out.device)
    return out.index_add_(0, torch.clamp(idx.long(), 0, rows - 1), grad_out)


def row_scatter(grad_out, idx, rows: int):
    """P0T: the cotangent [rows, C] of a row gather's table from that of its
    output grad_out [N, C] (float32) and its indices idx (int32 [N])."""
    if grad_out.dtype != torch.float32 or grad_out.dim() != 2:
        raise ValueError(f"row_scatter: need float32 [N, C], got {grad_out.dtype} "
                         f"{tuple(grad_out.shape)}")
    grad_out = grad_out.contiguous()
    if idx.dtype != torch.int32 or tuple(idx.shape) != (grad_out.shape[0],):
        raise ValueError(f"row_scatter: need int32 [{grad_out.shape[0]}] indices")
    if grad_out.device.type == "cpu":
        return row_scatter_plain(grad_out, idx, rows)
    lib = _cuda_lib("row_scatter", grad_out)
    out = torch.zeros((rows, grad_out.shape[1]), dtype=torch.float32, device=grad_out.device)
    code = lib.wpt_row_scatter(grad_out.data_ptr(), idx.contiguous().data_ptr(),
                               grad_out.shape[0], grad_out.shape[1], rows, out.data_ptr(),
                               native.stream_ptr(grad_out))
    native.check(code, "row_scatter")
    native.LAUNCHES["row_scatter"] += 1
    return out


class RowGather(torch.autograd.Function):
    """P0 forward, P0T backward."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return row_gather_raw(table, idx)

    @staticmethod
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        return row_scatter(grad_out.contiguous(), idx, ctx.rows), None


def row_gather_diff_plain(table, idx):
    """The row gather as differentiable PyTorch indexing (the reference the
    tests hold P0T's plain version to)."""
    return table[torch.clamp(idx.long(), 0, table.shape[0] - 1)]


# ---------------------------------------------------------------------------
# K3T: hit assembly and the winner's intersection
# ---------------------------------------------------------------------------

def _normalize_bwd(a, g):
    """Cotangent of a from that of a * rsqrt(max(a.a, 1e-20))."""
    aa = dot(a, a, keepdim=True)
    inv = torch.rsqrt(torch.clamp_min(aa, 1e-20))
    n = a * inv
    return torch.where(aa >= 1e-20, (g - n * dot(n, g, keepdim=True)) * inv, g * inv)


def _onb_tangent_bwd(n, g):
    """Cotangent of n from that of core/onb.onb_from_normal(n)[0]."""
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nz)
    gx = g[:, 0] * (2.0 * s * nx * a) + g[:, 1] * (s * ny * a) - g[:, 2] * s
    gy = g[:, 1] * (s * nx * a)
    gz = (g[:, 0] * nx * nx + g[:, 1] * nx * ny) * (s * a * a)
    return torch.stack([gx, gy, gz], -1)


class _Scatter:
    """Scatter-adds into a table and, where asked, the magnitudes of the
    terms into a second one (the scale a kernel's atomic sums are held to)."""

    def __init__(self, like, mags: bool):
        self.out = torch.zeros_like(like)
        self.mag = torch.zeros_like(like) if mags else None

    def add(self, idx, terms):
        self.out.index_add_(0, idx, terms)
        if self.mag is not None:
            self.mag.index_add_(0, idx, terms.abs())


def _winner_rows(ht, frames, is_tri, ps):
    """(the winners' animation ids [N], their frame rows [N, 30]) as K3a
    takes them: a triangle winner's animation, else the clamped sphere's."""
    zi = torch.zeros_like(ps)
    aid_t = ht.tri_anim[torch.clamp(ps, 0, ht.n_tris - 1)].long() if ht.n_tris else zi
    aid_s = (ht.sph_anim[torch.clamp(ps - ht.n_tris, 0, ht.n_spheres - 1)].long()
             if ht.n_spheres else zi)
    aid = torch.where(is_tri, aid_t, aid_s)
    return aid, frame_rows(frames, aid)


def _outer(a, b):
    """[N, 9] row-major a b^T of a, b [N, 3]."""
    return (a[:, :, None] * b[:, None, :]).reshape(-1, 9)


def _mat(rows, k):
    return rows[:, k:k + 9].reshape(-1, 3, 3)


def _matvec_t(m, v):
    """m^T v for m [N, 3, 3], v [N, 3]."""
    return matvec(m.transpose(-1, -2), v)


def assemble_hit_bwd_plain(ht, o, d, t, prim, u, v, backside, g_t, g_pos, g_nrm, g_gn, g_tan,
                           g_uv, magnitudes: bool = False, frames=None):
    """Plain version of K3T and, with the animations' `frames` ([A, 30] or
    per ray [N, A, 30]), of K3aT; see the module's docstring. Returns (g_o,
    g_d, g_tri_g [T, 9], g_tri_f [T, 27], g_sph_f [S, 4]) and, with
    `frames`, g_frames (frames' shape), with `magnitudes` also the tables'
    sums of |term| (the frame rows' last). Every lane assembles as K3's
    full form does (a miss lane as if its winner were prim 0 at t = 1);
    only hit lanes carry t's cotangent into the intersection.

    K3aT: the winner's hit is built in its animation's object space (o_s =
    r_inv (o - t_inv), d_s = r_inv d, the lane's row) and its normals pushed
    to world by m_nrm, its tangent by m_fwd, each normalized; so the
    cotangents of the world normals and tangent go back through those
    normalizations and maps (their outer products the cotangents of m_nrm
    and m_fwd), the object-space backward runs on (o_s, d_s), the hit
    equations hold in object space (t is the same in both), and (o_s, d_s)
    carry their cotangents to o, d, r_inv and t_inv."""
    zero = torch.zeros_like
    hit = prim >= 0
    ps = torch.clamp_min(prim, 0).long()
    is_tri = hit & (ps < ht.n_tris)
    tp = torch.where(hit, t, 1.0)
    pos = o + tp[:, None] * d
    flip = torch.where(backside, -1.0, 1.0)[:, None]
    g_pos = g_pos.clone()
    g_u = g_v = torch.zeros_like(t)
    g_tri_g = _Scatter(ht.tri_g, magnitudes)
    g_tri_f = _Scatter(ht.tri_f, magnitudes)
    g_sph_f = _Scatter(ht.sph_f, magnitudes)
    anim = frames is not None
    if anim:
        aid, rows = _winner_rows(ht, frames, is_tri, ps)
        r_inv, t_inv, m_fwd, m_nrm = _mat(rows, 0), rows[:, 9:12], _mat(rows, 12), _mat(rows, 21)
        oo = o - t_inv
        o_s, d_s = matvec(r_inv, oo), matvec(r_inv, d)
        pos_s = o_s + tp[:, None] * d_s
        g_ps = zero(o)           # the object-space hit point's cotangent
    else:
        d_s, pos_s = d, pos
        g_ps = g_pos
    # the object-space frame (the world's without animation) and its cotangents
    n_obj = gn_obj = tan_obj = zero(o)
    if ht.n_tris:
        ti = torch.clamp(ps, 0, ht.n_tris - 1)
        row = ht.tri_f[ti]
        n0, n1, n2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        uv0, uv1, uv2 = row[:, 9:11], row[:, 11:13], row[:, 13:15]
        t0, t1, t2 = row[:, 15:18], row[:, 18:21], row[:, 21:24]
        has_tan = (ht.tri_i[ti][:, 1] & 2) > 0
        w, uu, vv = (1.0 - u - v)[:, None], u[:, None], v[:, None]
        n_raw = w * n0 + uu * n1 + vv * n2
        n_i = n_raw * torch.rsqrt(torch.clamp_min(dot(n_raw, n_raw, keepdim=True), 1e-20))
        tan_raw = w * t0 + uu * t1 + vv * t2
        tdn = dot(tan_raw, n_i, keepdim=True)
        tan_gs = tan_raw - tdn * n_i
        tan_len = torch.sqrt(torch.clamp_min(dot(tan_gs, tan_gs, keepdim=True), 1e-20))
        use_gs = (has_tan & (tan_len[:, 0] > 1e-8))[:, None]
        tan_tri = tan_gs / tan_len
        sel = is_tri[:, None]
        if anim:
            n_obj = torch.where(sel, n_i, n_obj)
            gn_obj = torch.where(sel, row[:, 24:27], gn_obj)
            tan_obj = torch.where(sel, torch.where(use_gs, tan_tri, onb_from_normal(n_i)[0]),
                                  tan_obj)
    if ht.n_spheres:
        si = torch.clamp(ps - ht.n_tris, 0, ht.n_spheres - 1)
        srow = ht.sph_f[si]
        c, r = srow[:, 0:3], srow[:, 3]
        rr = torch.clamp_min(r, 1e-20)[:, None]
        local = (pos_s - c) / rr
        ll = dot(local, local, keepdim=True)
        n_s = local * torch.rsqrt(torch.clamp_min(ll, 1e-20))
        x, y, z = n_s[:, 0], n_s[:, 1], n_s[:, 2]
        den = x * x + z * z
        ln = torch.sqrt(torch.clamp_min(den, 1e-20))
        qx, qz = z / ln, -x / ln
        sel_s = ~is_tri
        if anim:
            t_sph = torch.where((ln < 1e-6)[:, None], torch.tensor([1.0, 0.0, 0.0]).to(o),
                                torch.stack([qx, zero(x), qz], -1))
            n_obj = torch.where(sel_s[:, None], n_s, n_obj)
            gn_obj = torch.where(sel_s[:, None], n_s, gn_obj)
            tan_obj = torch.where(sel_s[:, None], t_sph, tan_obj)
    if anim:
        # world = normalize(m v): back through the normalization and the map
        wn, wg, wt = matvec(m_nrm, n_obj), matvec(m_nrm, gn_obj), matvec(m_fwd, tan_obj)
        a_n, a_g, a_t = (_normalize_bwd(wn, flip * g_nrm), _normalize_bwd(wg, flip * g_gn),
                         _normalize_bwd(wt, g_tan))
        g_nobj, g_gnobj, g_tobj = _matvec_t(m_nrm, a_n), _matvec_t(m_nrm, a_g), _matvec_t(m_fwd,
                                                                                        a_t)
        g_mnrm = _outer(a_n, n_obj) + _outer(a_g, gn_obj)
        g_mfwd = _outer(a_t, tan_obj)
    else:
        g_nobj, g_gnobj, g_tobj = flip * g_nrm, flip * g_gn, g_tan
    if ht.n_tris:
        g_ni = torch.where(sel, g_nobj, 0.0)
        g_gnr = torch.where(sel, g_gnobj, 0.0)
        g_tt = torch.where(sel, g_tobj, 0.0)
        g_uvt = torch.where(sel, g_uv, 0.0)
        # the Gram-Schmidt tangent, or the normal's ONB where it degenerates
        g_gs = torch.where(use_gs, (g_tt - tan_tri * dot(tan_tri, g_tt, keepdim=True)) / tan_len,
                           0.0)
        gsn = dot(g_gs, n_i, keepdim=True)
        g_traw = g_gs - gsn * n_i
        g_ni = g_ni - gsn * tan_raw - tdn * g_gs
        g_ni = g_ni + _onb_tangent_bwd(n_i, torch.where(use_gs, 0.0, g_tt))
        g_nraw = _normalize_bwd(n_raw, g_ni)
        g_u = dot(g_nraw, n1 - n0) + dot(g_traw, t1 - t0) + dot(g_uvt, uv1 - uv0)
        g_v = dot(g_nraw, n2 - n0) + dot(g_traw, t2 - t0) + dot(g_uvt, uv2 - uv0)
        g_row = torch.cat([w * g_nraw, uu * g_nraw, vv * g_nraw, w * g_uvt, uu * g_uvt,
                           vv * g_uvt, w * g_traw, uu * g_traw, vv * g_traw, g_gnr], -1)
        g_tri_f.add(ti, torch.where(sel, g_row, 0.0))
    if ht.n_spheres:
        g_ns = torch.where(sel_s[:, None], g_nobj + g_gnobj, 0.0)
        # lat/long uv: u = 1/2 + atan2(x, z) / 2 pi, v = 1/2 + asin(y) / pi
        g_us = torch.where(sel_s, g_uv[:, 0], 0.0)
        g_vs = torch.where(sel_s, g_uv[:, 1], 0.0)
        tu = torch.where(g_us != 0.0, g_us * _INV_2PI / den, 0.0)
        tv = torch.where((g_vs != 0.0) & (torch.abs(y) <= 1.0),
                         g_vs * _INV_PI / torch.sqrt(1.0 - y * y), 0.0)
        # the pole-safe tangent (z, 0, -x) / |(z, -x)|
        g_ts = torch.where((sel_s & (ln >= 1e-6))[:, None], g_tobj, 0.0)
        qg = qx * g_ts[:, 0] + qz * g_ts[:, 2]
        gqx = (g_ts[:, 0] - qx * qg) / ln
        gqz = (g_ts[:, 2] - qz * qg) / ln
        g_ns = g_ns + torch.stack([tu * z - gqz, tv, gqx - tu * x], -1)
        g_local = _normalize_bwd(local, g_ns)
        g_ps = g_ps + g_local / rr
        g_c = (-g_local) / rr
        g_r = torch.where(r >= 1e-20, -dot(g_local, local) / rr[:, 0], 0.0)
        # the sphere's t: |o + t d - c| = r
        qv = pos_s - c
        shit = hit & ~is_tri
    g_os = zero(o) + g_ps
    g_ds = zero(d) + tp[:, None] * g_ps
    g_tt_all = g_t + dot(g_ps, d_s)
    if anim:
        g_tt_all = g_tt_all + dot(g_pos, d)
    g_tt_all = torch.where(hit, g_tt_all, 0.0)
    if ht.n_tris:
        p0, e1, e2 = (x for x in ht.tri_g[ti].split(3, -1))
        nv, pv, qv_t = cross(e1, e2), cross(d_s, e2), cross(e1, d_s)
        den_t = torch.where(is_tri, dot(d_s, nv), 1.0)
        lam = torch.where(is_tri[:, None], (nv * g_tt_all[:, None] + pv * g_u[:, None]
                                            + qv_t * g_v[:, None]) / den_t[:, None], 0.0)
        g_os = g_os - lam
        g_ds = g_ds - t[:, None] * lam
        g_tri_g.add(ti, torch.cat([lam, u[:, None] * lam, v[:, None] * lam], -1))
    if ht.n_spheres:
        den_s = torch.where(shit, dot(qv, d_s), 1.0)
        s = torch.where(shit, g_tt_all / den_s, 0.0)[:, None]
        g_os = g_os - s * qv
        g_ds = g_ds - (s * t[:, None]) * qv
        g_c = g_c + s * qv
        g_r = g_r + s[:, 0] * r
        g_sph_f.add(si, torch.where(sel_s[:, None], torch.cat([g_c, g_r[:, None]], -1), 0.0))
    tables = [g_tri_g, g_tri_f, g_sph_f]
    if anim:
        # o_s = r_inv (o - t_inv), d_s = r_inv d
        g_o = g_pos + _matvec_t(r_inv, g_os)
        g_d = tp[:, None] * g_pos + _matvec_t(r_inv, g_ds)
        g_row = torch.cat([_outer(g_os, oo) + _outer(g_ds, d), -_matvec_t(r_inv, g_os),
                           g_mfwd, g_mnrm], -1)
        g_frames = _Scatter(frames.reshape(-1, frames.shape[-1]), magnitudes)
        lane = torch.arange(o.shape[0], device=o.device)
        g_frames.add(aid if frames.dim() == 2 else lane * frames.shape[1] + aid, g_row)
        g_frames.out = g_frames.out.view_as(frames)
        if magnitudes:
            g_frames.mag = g_frames.mag.view_as(frames)
        tables.append(g_frames)
    else:
        g_o, g_d = g_os, g_ds
    out = (g_o, g_d, *(x.out for x in tables))
    return (*out, *(x.mag for x in tables)) if magnitudes else out


def assemble_hit_bwd(ht, o, d, t, prim, u, v, backside, g_t, g_pos, g_nrm, g_gn, g_tan, g_uv,
                     frames=None):
    """K3T (K3aT with `frames`): `assemble_hit_bwd_plain`'s function, the
    kernel on CUDA tensors."""
    n = o.shape[0]
    g = [x.contiguous() for x in (g_t, g_pos, g_nrm, g_gn, g_tan, g_uv)]
    if o.device.type == "cpu":
        return assemble_hit_bwd_plain(ht, o, d, t, prim, u, v, backside, *g, frames=frames)
    lib = _cuda_lib("assemble_hit_bwd", o)
    g_o, g_d = torch.empty_like(o), torch.empty_like(d)
    g_tri_g, g_tri_f, g_sph_f = (torch.zeros_like(x) for x in (ht.tri_g, ht.tri_f, ht.sph_f))
    args = [o.data_ptr(), d.data_ptr(), t.data_ptr(), prim.data_ptr(), u.data_ptr(),
            v.data_ptr(), backside.contiguous().data_ptr(), n,
            ht.tri_g.detach().contiguous().data_ptr(), ht.tri_f.data_ptr(), ht.tri_i.data_ptr(),
            ht.n_tris, ht.sph_f.data_ptr(), ht.n_spheres, *(x.data_ptr() for x in g),
            g_o.data_ptr(), g_d.data_ptr(), g_tri_g.data_ptr(), g_tri_f.data_ptr(),
            g_sph_f.data_ptr()]
    if frames is None:
        code = lib.wpt_assemble_hit_bwd(*args, native.stream_ptr(o))
        name = "assemble_hit_bwd"
    else:
        stride = _isect.check_frames(frames.detach(), ht.n_anims, o.device, n)
        frames = frames.detach().contiguous()
        g_frames = torch.zeros_like(frames)
        code = lib.wpt_assemble_hit_anim_bwd(*args, ht.tri_anim.data_ptr(),
                                             ht.sph_anim.data_ptr(), frames.data_ptr(), stride,
                                             ht.n_anims, g_frames.data_ptr(),
                                             native.stream_ptr(o))
        name = "assemble_hit_anim_bwd"
    native.check(code, name)
    native.LAUNCHES[name] += 1
    if frames is None:
        return g_o, g_d, g_tri_g, g_tri_f, g_sph_f
    return g_o, g_d, g_tri_g, g_tri_f, g_sph_f, g_frames


class AssembleHit(torch.autograd.Function):
    """K3's full form forward (the winner's t passed through), K3T backward;
    with frame rows K3a's full form and K3aT."""

    @staticmethod
    def forward(ctx, ht, o, d, t, prim, u, v, tri_g, tri_f, sph_f, frames=None):
        rec = _isect.assemble_hit_raw(ht, o, d, t, prim, u, v,
                                      None if frames is None else frames.detach())
        ctx.ht = ht
        ctx.save_for_backward(o, d, t, prim, u, v, rec.backside, frames)
        ctx.mark_non_differentiable(rec.mat, rec.backside)
        return (t.clone(), rec.position, rec.normal, rec.geom_normal, rec.tangent, rec.uv,
                rec.mat, rec.backside)

    @staticmethod
    def backward(ctx, g_t, g_pos, g_nrm, g_gn, g_tan, g_uv, _mat, _back):
        o, d, t, prim, u, v, backside, frames = ctx.saved_tensors
        g = [torch.zeros_like(ref) if x is None else x
             for x, ref in ((g_t, t), (g_pos, o), (g_nrm, o), (g_gn, o), (g_tan, o),
                            (g_uv, o[:, :2]))]
        out = assemble_hit_bwd(ctx.ht, o, d, t, prim, u, v, backside, *g, frames=frames)
        g_fr = out[5] if frames is not None else None
        return (None, out[0], out[1], None, None, None, None, out[2], out[3], out[4], g_fr)


def assemble_hit_diff_plain(ht, o, d, t, prim, u, v, frames=None):
    """K3's plain version (K3a's with `frames`) with the winner's t, u, v
    recomputed on the tape (values those of the cast, derivatives those of
    the triangle's Moller-Trumbore formulas and of the sphere quadratic's
    root, in the winner's object space with `frames`): the reference the
    tests hold K3T's and K3aT's plain version to."""
    hit = prim >= 0
    ps = torch.clamp_min(prim, 0).long()
    is_tri = hit & (ps < ht.n_tris)
    t_rec, u_rec, v_rec = t, u, v
    o_w, d_w = o, d
    if frames is not None:
        rows = _winner_rows(ht, frames, is_tri, ps)[1]
        o, d = matvec(_mat(rows, 0), o - rows[:, 9:12]), matvec(_mat(rows, 0), d)
    if ht.n_tris:
        ti = torch.clamp(ps, 0, ht.n_tris - 1)
        p0, e1, e2 = ht.tri_g[ti].split(3, -1)
        pvec = cross(d, e2)
        det = torch.where(is_tri, dot(e1, pvec), 1.0)
        tvec = o - p0
        qvec = cross(tvec, e1)
        t_rec = torch.where(is_tri, dot(e2, qvec) / det, t_rec)
        u_rec = torch.where(is_tri, dot(tvec, pvec) / det, u_rec)
        v_rec = torch.where(is_tri, dot(d, qvec) / det, v_rec)
    if ht.n_spheres:
        si = torch.clamp(ps - ht.n_tris, 0, ht.n_spheres - 1)
        c, r = ht.sph_f[si, 0:3], ht.sph_f[si, 3]
        shit = hit & ~is_tri
        oc = o - c
        a = dot(d, d)
        hb = dot(oc, d)
        disc = torch.where(shit, hb * hb - a * (dot(oc, oc) - r * r), 1.0)
        sq = torch.sqrt(torch.clamp_min(disc, 1e-20))
        r1, r2 = (-hb - sq) / a, (-hb + sq) / a
        near = torch.abs(r1 - t) <= torch.abs(r2 - t)
        t_rec = torch.where(shit, torch.where(near, r1, r2), t_rec)
    t_d = torch.where(hit, t_rec + (t - t_rec).detach(), t)
    u_d = torch.where(is_tri, u_rec + (u - u_rec).detach(), u)
    v_d = torch.where(is_tri, v_rec + (v - v_rec).detach(), v)
    return _isect.assemble_hit_plain(ht, o_w, d_w, t_d, prim, u_d, v_d, frames)


# ---------------------------------------------------------------------------
# K8T: the sky's radiance
# ---------------------------------------------------------------------------

def _bilinear_bwd(g, fx, fy, c00, c01, c10, c11):
    """(cotangents of the 4 taps, of fx, of fy) of
    (c00 (1 - fx) + c01 fx) (1 - fy) + (c10 (1 - fx) + c11 fx) fy."""
    gx, gy = 1.0 - fx, 1.0 - fy
    taps = (g * (gx * gy), g * (fx * gy), g * (gx * fy), g * (fx * fy))
    g_fx = dot(g, (c01 - c00) * gy + (c11 - c10) * fy)
    g_fy = dot(g, (c10 * gx + c11 * fx) - (c00 * gx + c01 * fx))
    return taps, g_fx, g_fy


def quat_rotate_bwd_q(q, v, g):
    """Per-lane cotangent [N, 4] of q from that g [N, 3] of quat_rotate(q, v)
    = v + w t + u x t, t = 2 u x v (q = (u, w))."""
    u, w = q[..., :3], q[..., 3:4]
    t = 2.0 * cross(u, v)
    g_t = w * g + cross(g, u)
    g_u = cross(t, g) + 2.0 * cross(v, g_t)
    return torch.cat([g_u, dot(g, t, keepdim=True)], -1)


def _conj_rotate_bwd_q(q, d, g_dm):
    """Per-lane cotangent [N, 4] of q from that g_dm of quat_rotate(conj(q), d)."""
    gc = quat_rotate_bwd_q(_env.quat_conjugate(q), d, g_dm)
    return torch.cat([-gc[:, :3], gc[:, 3:]], -1)


def env_radiance_bwd_plain(env, d, g, magnitudes: bool = False):
    """Plain version of K8T: (g_d [N, 3], g_image like env.image, g_const
    [4], g_rotation [4]) from the cotangent g [N, 4] of env_radiance(env, d);
    with `magnitudes` also the image's, the constant's and the rotation's
    sums of |term|."""
    g_img = _Scatter(env.image.reshape(-1, 4), magnitudes)
    if env.kind == 3:
        zero = torch.zeros_like(env.rotation)
        out = (torch.zeros_like(d), g_img.out.view_as(env.image), g.sum(0), zero)
        return ((*out, g_img.mag.view_as(env.image), g.abs().sum(0), zero) if magnitudes
                else out)
    g_const = torch.zeros_like(env.const_radiance)
    q = env.rotation
    dm = quat_rotate(_env.quat_conjugate(q), d)
    x, y, z = dm[:, 0], dm[:, 1], dm[:, 2]
    if env.kind == 1:
        h, w = env.image.shape[0], env.image.shape[1]
        u, v = _env._equirect_uv(dm)
        fx_ = u * w - 0.5
        fy_ = v * h - 0.5
        x0, y0 = torch.floor(fx_), torch.floor(fy_)
        fx, fy = (fx_ - x0)[:, None], (fy_ - y0)[:, None]
        x0i = torch.remainder(x0.long(), w)
        y0i = torch.clamp(y0.long(), 0, h - 1)
        x1i = torch.remainder(x0i + 1, w)
        y1i = torch.clamp(y0i + 1, 0, h - 1)
        img = env.image
        taps, g_fx, g_fy = _bilinear_bwd(g, fx, fy, img[y0i, x0i], img[y0i, x1i],
                                         img[y1i, x0i], img[y1i, x1i])
        for (yy, xx), gt in zip(((y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i)), taps):
            g_img.add(yy * w + xx, gt)
        # u = atan2(x, -z) / 2 pi mod 1, v = acos(y) / pi
        g_u, g_v = g_fx * w, g_fy * h
        den = x * x + z * z
        tu = g_u * _INV_2PI / den
        tv = torch.where(torch.abs(y) <= 1.0, -g_v * _INV_PI / torch.sqrt(1.0 - y * y), 0.0)
        g_dm = torch.stack([-z * tu, tv, x * tu], -1)
    else:
        h, w = env.image.shape[1], env.image.shape[2]
        ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
        is_x = (ax >= ay) & (ax >= az)
        is_y = (~is_x) & (ay >= az)
        face = torch.where(is_x, torch.where(x > 0, 0, 1),
                           torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)))
        major = torch.where(is_x, ax, torch.where(is_y, ay, az))
        ma = torch.clamp_min(major, 1e-20)
        sc = torch.where(is_x, torch.where(x > 0, -z, z),
                         torch.where(is_y, x, torch.where(z > 0, x, -x)))
        tc = torch.where(is_x, -y, torch.where(is_y, torch.where(y > 0, z, -z), -y))
        u = 0.5 * (sc / ma + 1.0)
        v = 0.5 * (tc / ma + 1.0)
        us_ = u * w - 0.5
        vs_ = v * h - 0.5
        us, vs = torch.clamp_min(us_, 0.0), torch.clamp_min(vs_, 0.0)
        x0 = torch.clamp(us.to(torch.int32), 0, w - 1).long()
        y0 = torch.clamp(vs.to(torch.int32), 0, h - 1).long()
        a = (us - x0.to(torch.float32))[:, None]
        b = (vs - y0.to(torch.float32))[:, None]
        x1, y1 = torch.clamp_max(x0 + 1, w - 1), torch.clamp_max(y0 + 1, h - 1)
        img = env.image
        fl = face.long()
        taps, g_a, g_b = _bilinear_bwd(g, a, b, img[fl, y0, x0], img[fl, y0, x1],
                                       img[fl, y1, x0], img[fl, y1, x1])
        for (yy, xx), gt in zip(((y0, x0), (y0, x1), (y1, x0), (y1, x1)), taps):
            g_img.add((fl * h + yy) * w + xx, gt)
        g_u = torch.where(us_ >= 0.0, g_a * w, 0.0)
        g_v = torch.where(vs_ >= 0.0, g_b * h, 0.0)
        g_sc, g_tc = 0.5 * g_u / ma, 0.5 * g_v / ma
        g_ma = torch.where(major >= 1e-20, -(g_sc * sc + g_tc * tc) / ma, 0.0)
        # the face's major axis, sc and tc as signed components of dm
        gxx = torch.where(is_x, g_ma * torch.sign(x),
                          torch.where(is_y, g_sc, torch.where(z > 0, g_sc, -g_sc)))
        gyy = torch.where(is_x, -g_tc, torch.where(is_y, g_ma * torch.sign(y), -g_tc))
        gzz = torch.where(is_x, torch.where(x > 0, -g_sc, g_sc),
                          torch.where(is_y, torch.where(y > 0, g_tc, -g_tc),
                                      g_ma * torch.sign(z)))
        g_dm = torch.stack([gxx, gyy, gzz], -1)
    # dm = R(conj q) d: its adjoint in d is R(q) (the transpose of the
    # conjugate's map); in q, the rotation formula's own derivative
    g_q = _conj_rotate_bwd_q(q, d, g_dm)
    out = (quat_rotate(q, g_dm), g_img.out.view_as(env.image), g_const, g_q.sum(0))
    if magnitudes:
        return (*out, g_img.mag.view_as(env.image), g_const, g_q.abs().sum(0))
    return out


def _masked(g, active):
    """g [N, C] with the rows of lanes outside `active` (where given) zeroed:
    a masked lane's outputs are constants (the plain versions' mask)."""
    return g if active is None else torch.where(active[:, None], g, 0.0)


def _active_ptr(active, n: int, x):
    """The kernels' lane mask: a contiguous bool [n] on x's device, or None."""
    if active is None:
        return None
    if (active.dtype != torch.bool or tuple(active.shape) != (n,) or not active.is_contiguous()
            or active.device != x.device):
        raise ValueError(f"need a contiguous bool mask ({n},) on {x.device}, got "
                         f"{active.dtype} {tuple(active.shape)} on {active.device}")
    return active.data_ptr()


def env_radiance_bwd(env, d, g, *, rotation: bool, active=None):
    """K8T: `env_radiance_bwd_plain`'s function, the kernel on CUDA tensors:
    with `rotation` its rotation term too (counter env_radiance_bwd_rot),
    without it the kernel that skips that term (g_rotation None). `active`
    [N] (bool) where given: a lane outside it carries no cotangent (a
    masked lane of K8, whose radiance is a constant) and gets g_d = 0."""
    g = g.contiguous()
    if d.device.type == "cpu":
        out = env_radiance_bwd_plain(env, d, _masked(g, active))
        if active is not None:
            out = (_masked(out[0], active), *out[1:])
        return out if rotation else (*out[:3], None)
    lib = _cuda_lib("env_radiance_bwd", d)
    n = d.shape[0]
    g_d = torch.empty_like(d)
    g_img = torch.zeros_like(env.image)
    g_const = torch.zeros_like(env.const_radiance)
    g_rot = torch.zeros((4,), dtype=torch.float32, device=d.device) if rotation else None
    h, w = env.image.shape[-3], env.image.shape[-2]
    code = lib.wpt_env_radiance_bwd(d.data_ptr(), n, env.kind, env.image.data_ptr(), h, w,
                                    env.rotation.detach().contiguous().data_ptr(), g.data_ptr(),
                                    _active_ptr(active, n, d), g_d.data_ptr(), g_img.data_ptr(),
                                    g_const.data_ptr(),
                                    None if g_rot is None else g_rot.data_ptr(),
                                    native.stream_ptr(d))
    native.check(code, "env_radiance_bwd")
    native.LAUNCHES["env_radiance_bwd_rot" if rotation else "env_radiance_bwd"] += 1
    return g_d, g_img, g_const, g_rot


class EnvRadiance(torch.autograd.Function):
    """K8 radiance forward, K8T backward."""

    @staticmethod
    def forward(ctx, env, d, active, image, const_radiance, rotation):
        ctx.env = env
        ctx.save_for_backward(d, active)
        return _env.env_radiance_raw(env, d, active)

    @staticmethod
    def backward(ctx, g):
        d, active = ctx.saved_tensors
        g_d, g_img, g_const, g_rot = env_radiance_bwd(ctx.env, d, g,
                                                      rotation=ctx.needs_input_grad[5],
                                                      active=active)
        return None, g_d, None, g_img, g_const, g_rot


class EnvMiss(torch.autograd.Function):
    """K8's (radiance, pdf) of given directions in one launch forward
    (`envmap.env_miss_raw`), K8T backward: the radiance's, as EnvRadiance's;
    the pdf carries none."""

    @staticmethod
    def forward(ctx, env, d, active, pdf, image, const_radiance, rotation):
        ctx.env = env
        ctx.save_for_backward(d, active)
        rad, p = _env.env_miss_raw(env, d, active, pdf)
        if p is not None:
            ctx.mark_non_differentiable(p)
        return rad, p

    @staticmethod
    def backward(ctx, g, _g_pdf):
        d, active = ctx.saved_tensors
        g_d, g_img, g_const, g_rot = env_radiance_bwd(ctx.env, d, g,
                                                      rotation=ctx.needs_input_grad[6],
                                                      active=active)
        return None, g_d, None, None, g_img, g_const, g_rot


def env_sample_bwd_plain(env, u3, g_dir, magnitudes: bool = False):
    """Plain version of K8T's sample backward: the rotation's cotangent [4]
    from that g_dir [N, 3] of env_sample's direction quat_rotate(q, d_map),
    d_map recomputed from the uniforms u3 (the pdf carries none); with
    `magnitudes` also its sum of |term|."""
    rot = env.rotation
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype, device=rot.device)
    d_map, _ = _env.env_sample_plain(env._replace(rotation=ident), u3)
    g_q = quat_rotate_bwd_q(rot, d_map, g_dir)
    return (g_q.sum(0), g_q.abs().sum(0)) if magnitudes else g_q.sum(0)


# K8T's sample backward's scratch per (device, stream): room for the
# per-block partial sums and the count of finished blocks, which each
# launch leaves at 0 (zeroed once, here).
_SAMPLE_BLOCKS = 4096
_SAMPLE_SCRATCH = {}


def env_sample_bwd(env, u3, g_dir, active=None):
    """K8T's sample backward: `env_sample_bwd_plain`'s function, the kernel
    on CUDA tensors; `active` [N] (bool) where given: a lane outside it
    carries no cotangent (a masked lane of K8, whose direction is a
    constant)."""
    g_dir = g_dir.contiguous()
    if u3.device.type == "cpu":
        return env_sample_bwd_plain(env, u3, _masked(g_dir, active))
    lib = _cuda_lib("env_sample_bwd", u3)
    if u3.shape[0] == 0:
        return torch.zeros((4,), dtype=torch.float32, device=u3.device)
    stream = native.stream_ptr(u3)
    key = (u3.device, stream)
    if key not in _SAMPLE_SCRATCH:
        _SAMPLE_SCRATCH[key] = (
            torch.empty((_SAMPLE_BLOCKS, 4), dtype=torch.float32, device=u3.device),
            torch.zeros((1,), dtype=torch.int32, device=u3.device))
    partial, done = _SAMPLE_SCRATCH[key]
    g_rot = torch.empty((4,), dtype=torch.float32, device=u3.device)
    code = lib.wpt_env_sample_bwd(u3.data_ptr(), u3.shape[0], env.pdf_table.data_ptr(),
                                  env.alias_prob.data_ptr(), env.alias_idx.data_ptr(),
                                  env.pdf_table.shape[0],
                                  env.rotation.detach().contiguous().data_ptr(), g_dir.data_ptr(),
                                  _active_ptr(active, u3.shape[0], u3), partial.data_ptr(),
                                  _SAMPLE_BLOCKS, done.data_ptr(),
                                  g_rot.data_ptr(), stream)
    native.check(code, "env_sample_bwd")
    native.LAUNCHES["env_sample_bwd"] += 1
    return g_rot


class EnvSample(torch.autograd.Function):
    """K8 sample forward, K8T's sample backward: the direction's cotangent
    into the rotation; the pdf, a table lookup, carries none."""

    @staticmethod
    def forward(ctx, env, u3, active, rotation):
        d, pdf = _env.env_sample_raw(env, u3, active)
        ctx.env = env
        ctx.save_for_backward(u3, active)
        ctx.mark_non_differentiable(pdf)
        return d, pdf

    @staticmethod
    def backward(ctx, g_dir, _g_pdf):
        u3, active = ctx.saved_tensors
        return None, None, None, env_sample_bwd(ctx.env, u3, g_dir, active)


class EnvNee(torch.autograd.Function):
    """K8's (direction, pdf, radiance) of an importance sample in one launch
    forward (`envmap.env_nee_raw`). Backward: K8T on the radiance's
    cotangent at the sampled directions (with its rotation term where the
    rotation is on the tape), then, where it is, K8T's sample backward on
    the directions' cotangent plus K8T's: the rotation's two terms, as the
    sample followed by a lookup of its direction gives them. The
    direction carries a cotangent only where the rotation requires grad;
    the pdf carries none."""

    @staticmethod
    def forward(ctx, env, u3, active, image, const_radiance, rotation):
        d, pdf, rad = _env.env_nee_raw(env, u3, active)
        ctx.env = env
        ctx.save_for_backward(u3, active, d)
        ctx.mark_non_differentiable(pdf)
        if not ctx.needs_input_grad[5]:
            ctx.mark_non_differentiable(d)
        return d, pdf, rad

    @staticmethod
    def backward(ctx, g_dir, _g_pdf, g_rad):
        u3, active, d = ctx.saved_tensors
        rotation = ctx.needs_input_grad[5]
        g_img = g_const = g_rot = None
        if g_rad is not None:
            g_d, g_img, g_const, g_rot = env_radiance_bwd(ctx.env, d, g_rad, rotation=rotation,
                                                          active=active)
            if rotation:
                g_dir = g_d if g_dir is None else g_dir + g_d
        if rotation and g_dir is not None:
            g_s = env_sample_bwd(ctx.env, u3, g_dir, active)
            g_rot = g_s if g_rot is None else g_rot + g_s
        return None, None, None, g_img, g_const, g_rot
