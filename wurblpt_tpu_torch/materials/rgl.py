"""RGL (EPFL) measured BRDFs (port of ``wurblpt_tpu/materials/rgl.py``).

Host side (numpy): the ``tensor_file`` parser, the per-slice CDFs of
powitacq's Marginal2D constructor, `load_rgl_material` for RGB datasets and
`stack_rgl_tables`, which stacks every material of a scene, zero-padded, into
one :class:`RGLTables`. Spectral datasets wait for the colour module
(NotImplementedError).

Device side: K7, the measured BRDF's eval (f*cos and pdf for a pair of
tangent-space directions) and sample (a direction from two uniforms), is a
hand-written CUDA kernel with two entry points (``csrc/rgl.cu``). `rgl_eval`
and `rgl_sample` launch it on CUDA tensors and run the plain PyTorch versions
(`rgl_eval_plain`, `rgl_sample_plain`) on CPU tensors. The plain versions
keep the JAX package's semantics (powitacq_rgb.inl:326-583, 1016-1190):
parameter lookups and row searches are counts over a row masked by the
material's actual width (as JAX's `_search_row`, never a bisection), the
param-bilinear corner sums skip corners statically where the padded phi or
theta axis has length 1, and every expression is evaluated in the kernel's
order, so kernel and plain version agree bit for bit on the card. JAX's
one-hot `_extract` becomes a direct load: exactly one of its terms is
non-zero; its division by the constant 2 pi is the multiplication by the
float32 reciprocal that XLA executes.

`rgl_sample_lanes` / `rgl_eval_lanes` are the bsdf lane adapters: world
directions into the hit's tangent frame and back.
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .. import native
from ..core.onb import onb_from_normal_tangent, to_local, to_world
from ..core.vecmath import dot, normalize

_f32 = np.float32
_PI = math.pi
_ONE_MINUS_EPS = 0.999999940395355225   # powitacq_rgb.inl:22
# 1 / (2 pi) as XLA multiplies by it where the JAX package divides by 2 pi:
# float32(1) / float32(2 pi) (csrc/rgl.cu INV_TWO_PI_F).
_INV_TWO_PI = float(np.float32(1.0) / np.float32(2.0 * math.pi))

# ---------------------------------------------------------------------------
# Host side: tensor_file parsing and table preparation (numpy)
# ---------------------------------------------------------------------------

_DTYPES = {
    1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16, 5: np.uint32,
    6: np.int32, 7: np.uint64, 8: np.int64, 9: np.float16, 10: np.float32,
    11: np.float64,
}


def read_tensor_file(path: str) -> dict:
    """Parse the RGL 'tensor_file' container (powitacq_rgb.inl:729-801)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:12] != b"tensor_file\x00":
        raise ValueError(f"{path}: not a tensor_file")
    if (raw[12], raw[13]) != (1, 0):
        raise ValueError(f"{path}: unsupported tensor_file version {raw[12]}.{raw[13]}")
    (n_fields,) = struct.unpack_from("<I", raw, 14)
    pos = 18
    fields = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", raw, pos)
        pos += 2
        name = raw[pos:pos + name_len].decode("utf-8")
        pos += name_len
        ndim, dtype = struct.unpack_from("<HB", raw, pos)
        pos += 3
        (offset,) = struct.unpack_from("<Q", raw, pos)
        pos += 8
        shape = struct.unpack_from(f"<{ndim}Q", raw, pos)
        pos += 8 * ndim
        count = int(np.prod(shape)) if ndim else 1
        data = np.frombuffer(raw, np.dtype(_DTYPES[dtype]), count=count, offset=offset)
        fields[name] = np.array(data.reshape(shape))
    return fields


def _build_cdfs(data: np.ndarray):
    """Per-slice normalization and marginal/conditional CDFs, as Marginal2D's
    constructor builds them (powitacq_rgb.inl:242-283).

    data [..., H, W] -> (data_norm [..., H, W], marg [..., H], cond [..., H, W])."""
    d = np.asarray(data, np.float64)
    cond = np.zeros_like(d)
    cond[..., 1:] = np.cumsum(0.5 * (d[..., :-1] + d[..., 1:]), axis=-1)
    last = cond[..., -1]
    marg = np.zeros(last.shape, np.float64)
    marg[..., 1:] = np.cumsum(0.5 * (last[..., :-1] + last[..., 1:]), axis=-1)
    norm = 1.0 / np.maximum(marg[..., -1:], 1e-30)
    return ((d * norm[..., None]).astype(_f32), (marg * norm).astype(_f32),
            (cond * norm[..., None]).astype(_f32))


def load_rgl_material(source) -> dict:
    """One RGL dataset (a path or a parsed field dict) as numpy tables ready for
    stacking (powitacq_rgb.inl:891-1007). RGB datasets only: the NIR channel
    is the mean of RGB (material_rgl.hpp:45-46)."""
    fields = read_tensor_file(source) if isinstance(source, str) else dict(source)
    phi_i = np.asarray(fields["phi_i"], _f32).reshape(-1)
    theta_i = np.asarray(fields["theta_i"], _f32).reshape(-1)
    vndf = np.asarray(fields["vndf"], _f32)
    lum = np.asarray(fields["luminance"], _f32)
    if vndf.shape[:2] != (len(phi_i), len(theta_i)):
        raise ValueError("vndf shape does not match phi_i/theta_i grids")
    if "rgb" not in fields:
        if "spectra" in fields:
            raise NotImplementedError("spectral RGL datasets are not ported yet")
        raise ValueError("RGL dataset has neither 'rgb' nor 'spectra' field")
    rgb = np.asarray(fields["rgb"], _f32)                      # [P, T, 3, H, W]
    rgb4 = np.concatenate([rgb, rgb.mean(axis=2, keepdims=True)], axis=2)
    vndf_d, vndf_m, vndf_c = _build_cdfs(vndf)
    lum_d, lum_m, lum_c = _build_cdfs(lum)
    return dict(phi_i=phi_i, theta_i=theta_i, ndf=np.asarray(fields["ndf"], _f32),
                sigma=np.asarray(fields["sigma"], _f32),
                vndf_data=vndf_d, vndf_marg=vndf_m, vndf_cond=vndf_c,
                lum_data=lum_d, lum_marg=lum_m, lum_cond=lum_c,
                rgb=np.maximum(rgb4, 0.0), isotropic=bool(len(phi_i) <= 2))


class RGLTables(NamedTuple):
    """Every RGL material of a scene, stacked (zero-padded) along axis 0; the
    `*_hw` and `n_*` columns hold each material's actual sizes."""

    phi_i: torch.Tensor      # [M, P] f32
    theta_i: torch.Tensor    # [M, T] f32
    n_phi: torch.Tensor      # [M] int32
    n_theta: torch.Tensor    # [M] int32
    ndf: torch.Tensor        # [M, Hn, Wn] f32 raw values
    sigma: torch.Tensor      # [M, Hs, Ws] f32
    ndf_hw: torch.Tensor     # [M, 2] int32
    sigma_hw: torch.Tensor   # [M, 2] int32
    vndf_data: torch.Tensor  # [M, P, T, Hv, Wv] f32 normalized density
    vndf_marg: torch.Tensor  # [M, P, T, Hv]
    vndf_cond: torch.Tensor  # [M, P, T, Hv, Wv]
    vndf_hw: torch.Tensor    # [M, 2] int32
    lum_data: torch.Tensor   # [M, P, T, Hl, Wl]
    lum_marg: torch.Tensor   # [M, P, T, Hl]
    lum_cond: torch.Tensor   # [M, P, T, Hl, Wl]
    lum_hw: torch.Tensor     # [M, 2] int32
    rgb: torch.Tensor        # [M, P, T, 4, Hl, Wl] RGB + NIR reflectance
    isotropic: torch.Tensor  # [M] int32, 1 = isotropic (the JAX package keeps a bool)

    @property
    def count(self) -> int:
        return self.phi_i.shape[0]

    @property
    def device(self):
        return self.phi_i.device


_INT_FIELDS = ("n_phi", "n_theta", "ndf_hw", "sigma_hw", "vndf_hw", "lum_hw", "isotropic")


def _tables(arrays: dict, device) -> RGLTables:
    return RGLTables(**{k: torch.as_tensor(np.array(
        arrays[k], np.int32 if k in _INT_FIELDS else _f32), device=device)
        for k in RGLTables._fields})


def _pad_to(a: np.ndarray, shape) -> np.ndarray:
    out = np.zeros(shape, a.dtype)
    out[tuple(slice(0, s) for s in a.shape)] = a
    return out


def stack_rgl_tables(mats, device="cuda") -> RGLTables:
    """Stack per-material table dicts (`load_rgl_material`) into one RGLTables."""
    mats = list(mats)
    if not mats:
        raise ValueError("no RGL materials to stack")

    def mx(key, axis):
        return max(m[key].shape[axis] for m in mats)

    P, T = mx("phi_i", 0), mx("theta_i", 0)
    hv, wv = mx("vndf_data", 2), mx("vndf_data", 3)
    hl, wl = mx("lum_data", 2), mx("lum_data", 3)
    shapes = dict(phi_i=(P,), theta_i=(T,), ndf=(mx("ndf", 0), mx("ndf", 1)),
                  sigma=(mx("sigma", 0), mx("sigma", 1)), vndf_data=(P, T, hv, wv),
                  vndf_marg=(P, T, hv), vndf_cond=(P, T, hv, wv), lum_data=(P, T, hl, wl),
                  lum_marg=(P, T, hl), lum_cond=(P, T, hl, wl), rgb=(P, T, 4, hl, wl))
    arrays = {k: np.stack([_pad_to(m[k], s) for m in mats]) for k, s in shapes.items()}
    arrays.update(
        n_phi=[len(m["phi_i"]) for m in mats], n_theta=[len(m["theta_i"]) for m in mats],
        ndf_hw=[m["ndf"].shape for m in mats], sigma_hw=[m["sigma"].shape for m in mats],
        vndf_hw=[m["vndf_data"].shape[2:] for m in mats],
        lum_hw=[m["lum_data"].shape[2:] for m in mats],
        isotropic=[int(m["isotropic"]) for m in mats])
    return _tables(arrays, device)


def rgl_tables_from_numpy(t, device) -> RGLTables:
    """The JAX package's RGLTables, with numpy leaves, on `device`."""
    return _tables({k: np.asarray(getattr(t, k)) for k in RGLTables._fields}, device)


# ---------------------------------------------------------------------------
# Plain PyTorch version of K7 (powitacq_rgb.inl semantics, the kernel's order)
# ---------------------------------------------------------------------------

def _search_row(rowvals, n, u, strict: bool):
    """find_interval (powitacq_rgb.inl:132-151) as a count over the row: the
    largest i in [0, n-2] with row[i] < u (strict) or <= u."""
    iota = torch.arange(rowvals.shape[-1], device=rowvals.device)
    pred = (rowvals < u[:, None]) if strict else (rowvals <= u[:, None])
    cnt = (pred & (iota < n[:, None])).sum(-1)
    return torch.minimum(torch.clamp_min(cnt - 1, 0), torch.clamp_min(n - 2, 0))


def _param_weights(vals, nvals, mid, x):
    """Grid cell and lerp weight of x in a material's sorted parameter grid
    (powitacq_rgb.inl:335-355)."""
    row = vals[mid]
    n = nvals[mid].long()
    i0 = _search_row(row, n, x, strict=False)
    p0 = row.gather(1, i0[:, None])[:, 0]
    p1 = row.gather(1, torch.minimum(i0 + 1, torch.clamp_min(n - 1, 0))[:, None])[:, 0]
    w1 = torch.clamp((x - p0) / torch.where(p1 == p0, 1.0, p1 - p0), 0.0, 1.0)
    return i0, torch.where(n <= 1, 0.0, w1)


def _theta2u(theta):
    return torch.sqrt(torch.clamp_min(theta, 0.0) * (2.0 / _PI))


def _phi2u(phi):
    return (phi + _PI) * _INV_TWO_PI


def _elevation(d):
    """Robust acos(d.z) (powitacq_rgb.inl:1016-1018)."""
    dz = d[:, 2] - 1.0
    return 2.0 * torch.asin(torch.clamp(
        0.5 * torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + dz * dz), -1.0, 1.0))


class _Frame(NamedTuple):
    """Per-lane parameter frame of an incident direction: the material row and
    the (phi_i, theta_i) grid corners with their weights."""

    mid: torch.Tensor       # [N] int64
    corners: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]   # (weight, p, t)
    phi_i: torch.Tensor
    u_wi: torch.Tensor      # [N, 2]
    iso: torch.Tensor       # [N] bool


def _prepare(tables: RGLTables, mid, wi) -> _Frame:
    mid = mid.long()
    theta_i = _elevation(wi)
    phi_i = torch.atan2(wi[:, 1], wi[:, 0])
    pi, wp1 = _param_weights(tables.phi_i, tables.n_phi, mid, phi_i)
    ti, wt1 = _param_weights(tables.theta_i, tables.n_theta, mid, theta_i)
    P, T = tables.phi_i.shape[1], tables.theta_i.shape[1]
    # Corners along a padded axis of length 1 carry weight 0: skipped.
    pi1, ti1 = torch.clamp_max(pi + 1, P - 1), torch.clamp_max(ti + 1, T - 1)
    wp0, wt0 = 1.0 - wp1, 1.0 - wt1
    if P == 1 and T == 1:
        corners = [(torch.ones_like(wp0), pi, ti)]
    elif T == 1:
        corners = [(wp0, pi, ti), (wp1, pi1, ti)]
    elif P == 1:
        corners = [(wt0, pi, ti), (wt1, pi, ti1)]
    else:
        corners = [(wp0 * wt0, pi, ti), (wp0 * wt1, pi, ti1), (wp1 * wt0, pi1, ti),
                   (wp1 * wt1, pi1, ti1)]
    u_wi = torch.stack([_theta2u(theta_i), _phi2u(phi_i)], -1)
    return _Frame(mid, corners, phi_i, u_wi, tables.isotropic[mid] != 0)


def _g(fr: _Frame, arr, *idx):
    """Param-bilinear fetch: sum over the corners of arr[mid, p, t, *idx]."""
    out = None
    for w, p, t in fr.corners:
        v = arr[(fr.mid, p, t) + idx]
        w = w.reshape(w.shape + (1,) * (v.dim() - 1))
        out = w * v if out is None else out + w * v
    return out


class _Warp(NamedTuple):
    """One param-conditioned Marginal2D warp bound to the lanes' frame."""

    data: torch.Tensor      # [M, P, T, H, W]
    marg: torch.Tensor      # [M, P, T, H]
    cond: torch.Tensor      # [M, P, T, H, W]
    fr: _Frame
    h: torch.Tensor         # [N] int64 actual rows
    w: torch.Tensor         # [N] actual columns

    @property
    def _area(self):
        return ((self.w - 1) * (self.h - 1)).to(torch.float32)

    def _cell(self, pos):
        fx = pos[:, 0] * (self.w - 1).to(torch.float32)
        fy = pos[:, 1] * (self.h - 1).to(torch.float32)
        x0 = torch.minimum(torch.clamp_min(fx.to(torch.int32).long(), 0), self.w - 2)
        y0 = torch.minimum(torch.clamp_min(fy.to(torch.int32).long(), 0), self.h - 2)
        return x0, y0, fx - x0.to(torch.float32), fy - y0.to(torch.float32)

    def _next_row(self, y):
        return torch.clamp_max(y + 1, self.data.shape[-2] - 1)

    def eval(self, pos):
        """Bilinear density at pos in the unit square (powitacq_rgb.inl:530-583)."""
        x0, y0, sx, sy = self._cell(pos)
        y1 = self._next_row(y0)
        v00, v10 = _g(self.fr, self.data, y0, x0), _g(self.fr, self.data, y0, x0 + 1)
        v01, v11 = _g(self.fr, self.data, y1, x0), _g(self.fr, self.data, y1, x0 + 1)
        return ((1.0 - sy) * ((1.0 - sx) * v00 + sx * v10)
                + sy * ((1.0 - sx) * v01 + sx * v11)) * self._area

    def invert(self, pos):
        """Warped position back to the unit square, and the density there
        (powitacq_rgb.inl:434-527)."""
        x0, y0, sx, sy = self._cell(pos)
        y1 = self._next_row(y0)
        fr, data, cond = self.fr, self.data, self.cond
        v00, v10 = _g(fr, data, y0, x0), _g(fr, data, y0, x0 + 1)
        v01, v11 = _g(fr, data, y1, x0), _g(fr, data, y1, x0 + 1)
        c0 = (1.0 - sy) * v00 + sy * v01
        c1 = (1.0 - sy) * v10 + sy * v11
        pdf = (1.0 - sx) * c0 + sx * c1
        ux = sx * (c0 + 0.5 * sx * (c1 - c0))
        ux = ux + ((1.0 - sy) * _g(fr, cond, y0, x0) + sy * _g(fr, cond, y1, x0))
        wlast = torch.clamp_min(self.w - 1, 0)
        r0, r1 = _g(fr, cond, y0, wlast), _g(fr, cond, y1, wlast)
        ux = ux / torch.clamp_min((1.0 - sy) * r0 + sy * r1, 1e-20)
        uy = sy * (r0 + 0.5 * sy * (r1 - r0)) + _g(fr, self.marg, y0)
        return torch.stack([ux, uy], -1), pdf * self._area

    def sample(self, u):
        """Warp a uniform sample; (position, density) (powitacq_rgb.inl:326-432)."""
        fr = self.fr
        u = torch.clamp(u, 1.0 - _ONE_MINUS_EPS, _ONE_MINUS_EPS)
        ux, uy = u[:, 0], u[:, 1]
        marg_row = _g(fr, self.marg)                                  # [N, H]
        row = _search_row(marg_row, self.h, uy, True)
        uy = uy - marg_row.gather(1, row[:, None])[:, 0]
        row1 = self._next_row(row)
        cr0, cr1 = _g(fr, self.cond, row), _g(fr, self.cond, row1)   # [N, W]
        wlast = torch.clamp_min(self.w - 1, 0)[:, None]
        r0, r1 = cr0.gather(1, wlast)[:, 0], cr1.gather(1, wlast)[:, 0]
        is_const = torch.abs(r0 - r1) < 1e-4 * (r0 + r1)
        disc = torch.sqrt(torch.clamp_min(r0 * r0 - 2.0 * uy * (r0 - r1), 0.0))
        uy = torch.where(is_const, 2.0 * uy / torch.clamp_min(r0 + r1, 1e-20),
                         (r0 - disc) / torch.where(is_const | (r0 == r1), 1.0, r0 - r1))
        ux = ux * ((1.0 - uy) * r0 + uy * r1)
        fc_row = (1.0 - uy)[:, None] * cr0 + uy[:, None] * cr1
        col = _search_row(fc_row, self.w, ux, True)
        ux = ux - fc_row.gather(1, col[:, None])[:, 0]
        v00, v10 = _g(fr, self.data, row, col), _g(fr, self.data, row, col + 1)
        v01, v11 = _g(fr, self.data, row1, col), _g(fr, self.data, row1, col + 1)
        c0 = (1.0 - uy) * v00 + uy * v01
        c1 = (1.0 - uy) * v10 + uy * v11
        is_const2 = torch.abs(c0 - c1) < 1e-4 * (c0 + c1)
        disc2 = torch.sqrt(torch.clamp_min(c0 * c0 - 2.0 * ux * (c0 - c1), 0.0))
        ux = torch.where(is_const2, 2.0 * ux / torch.clamp_min(c0 + c1, 1e-20),
                         (c0 - disc2) / torch.where(is_const2 | (c0 == c1), 1.0, c0 - c1))
        pos = torch.stack([(col.to(torch.float32) + ux) / (self.w - 1).to(torch.float32),
                           (row.to(torch.float32) + uy) / (self.h - 1).to(torch.float32)], -1)
        return pos, ((1.0 - ux) * c0 + ux * c1) * self._area


def _warp(tables: RGLTables, fr: _Frame, which: str) -> _Warp:
    if which == "vndf":
        data, marg, cond, hw = tables.vndf_data, tables.vndf_marg, tables.vndf_cond, tables.vndf_hw
    else:
        data, marg, cond, hw = tables.lum_data, tables.lum_marg, tables.lum_cond, tables.lum_hw
    hw = hw[fr.mid].long()
    return _Warp(data, marg, cond, fr, hw[:, 0], hw[:, 1])


def _eval0(arr, hw, mid, pos):
    """Plain bilinear of a raw [M, H, W] table (Warp2D0 without normalization,
    powitacq_rgb.inl:286-312, 530-583)."""
    hw = hw[mid].long()
    h, w = hw[:, 0], hw[:, 1]
    fx = torch.clamp(pos[:, 0], 0.0, 1.0) * (w - 1).to(torch.float32)
    fy = torch.clamp(pos[:, 1], 0.0, 1.0) * (h - 1).to(torch.float32)
    x0 = torch.minimum(torch.clamp_min(fx.to(torch.int32).long(), 0), w - 2)
    y0 = torch.minimum(torch.clamp_min(fy.to(torch.int32).long(), 0), h - 2)
    sx, sy = fx - x0.to(torch.float32), fy - y0.to(torch.float32)
    y1 = torch.clamp_max(y0 + 1, arr.shape[1] - 1)
    v00, v10 = arr[mid, y0, x0], arr[mid, y0, x0 + 1]
    v01, v11 = arr[mid, y1, x0], arr[mid, y1, x0 + 1]
    return (1.0 - sy) * ((1.0 - sx) * v00 + sx * v10) + sy * ((1.0 - sx) * v01 + sx * v11)


def _rgb_eval(tables: RGLTables, lum: _Warp, pos):
    """The four reflectance channels at a warp position (powitacq_rgb.inl:995-1007,
    1084-1099), clipped at 0."""
    x0, y0, sx, sy = lum._cell(pos)
    y1 = lum._next_row(y0)
    rgb, fr, ch = tables.rgb, lum.fr, slice(None)
    v00, v10 = _g(fr, rgb, ch, y0, x0), _g(fr, rgb, ch, y0, x0 + 1)
    v01, v11 = _g(fr, rgb, ch, y1, x0), _g(fr, rgb, ch, y1, x0 + 1)
    sx, sy = sx[:, None], sy[:, None]
    out = (1.0 - sy) * ((1.0 - sx) * v00 + sx * v10) + sy * ((1.0 - sx) * v01 + sx * v11)
    return torch.clamp_min(out, 0.0)


def _u_wm(fr: _Frame, wm):
    theta_m = _elevation(wm)
    phi_m = torch.atan2(wm[:, 1], wm[:, 0])
    um_y = _phi2u(torch.where(fr.iso, phi_m - fr.phi_i, phi_m))
    return torch.stack([_theta2u(theta_m), um_y - torch.floor(um_y)], -1)


def _fr_common(tables: RGLTables, fr: _Frame, wm_pos, u_wm):
    """Reflectance x ndf / (4 sigma(wi)), the shared tail of eval and sample."""
    fval = _rgb_eval(tables, _warp(tables, fr, "lum"), wm_pos)
    ndf_v = _eval0(tables.ndf, tables.ndf_hw, fr.mid, u_wm)
    sigma_v = _eval0(tables.sigma, tables.sigma_hw, fr.mid, fr.u_wi)
    return fval * (ndf_v / torch.clamp_min(4.0 * sigma_v, 1e-12))[:, None]


def _jacobian(wi, wm, u_wm):
    sin_theta_m = torch.sqrt(wm[:, 0] * wm[:, 0] + wm[:, 1] * wm[:, 1])
    return (torch.clamp_min(2.0 * _PI * _PI * u_wm[:, 0] * sin_theta_m, 1e-6) * 4.0
            * dot(wi, wm))


def rgl_eval_plain(tables: RGLTables, mid, wi, wo):
    """Plain version of K7 eval: (f*cos [N, 4], pdf [N]) for tangent-space wi
    (toward the viewer) and wo (scatter direction); powitacq eval() + pdf()."""
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    wm = normalize(wi + wo)
    fr = _prepare(tables, mid, wi)
    u_wm = _u_wm(fr, wm)
    warp_pos, vndf_pdf = _warp(tables, fr, "vndf").invert(u_wm)
    fval = _fr_common(tables, fr, warp_pos, u_wm)
    lum_pdf = _warp(tables, fr, "lum").eval(warp_pos)
    pdf = vndf_pdf * lum_pdf / _jacobian(wi, wm, u_wm)
    return (torch.where(valid[:, None], fval, 0.0),
            torch.where(valid, torch.clamp_min(pdf, 0.0), 0.0))


def rgl_sample_plain(tables: RGLTables, mid, wi, u2):
    """Plain version of K7 sample: (wo [N, 3], f*cos [N, 4], pdf [N], ok [N])
    from uniforms u2 [N, 2]; powitacq sample()."""
    fr = _prepare(tables, mid, wi)
    sample, lum_pdf = _warp(tables, fr, "lum").sample(torch.stack([u2[:, 1], u2[:, 0]], -1))
    u_wm, ndf_pdf = _warp(tables, fr, "vndf").sample(sample)
    phi_m = (2.0 * u_wm[:, 1] - 1.0) * _PI
    theta_m = u_wm[:, 0] * u_wm[:, 0] * (_PI / 2.0)
    phi_m = torch.where(fr.iso, phi_m + fr.phi_i, phi_m)
    sin_t, cos_t = torch.sin(theta_m), torch.cos(theta_m)
    wm = torch.stack([torch.cos(phi_m) * sin_t, torch.sin(phi_m) * sin_t, cos_t], -1)
    wo = 2.0 * dot(wm, wi)[:, None] * wm - wi
    valid = (wi[:, 2] > 0) & (wo[:, 2] > 0)
    fval = _fr_common(tables, fr, sample, u_wm)
    pdf = ndf_pdf * lum_pdf / _jacobian(wi, wm, u_wm)
    ok = valid & (pdf > 0) & torch.isfinite(fval).all(-1)
    return wo, torch.where(ok[:, None], fval, 0.0), torch.where(ok, pdf, 0.0), ok


# ---------------------------------------------------------------------------
# K7 wrappers: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------

class _CTables(ctypes.Structure):
    """struct RglTables of csrc/rgl_common.cuh: 18 device pointers, then the padded sizes."""

    _fields_ = ([(k, ctypes.c_void_p) for k in RGLTables._fields]
                + [(k, ctypes.c_int) for k in ("M", "P", "T", "Hn", "Wn", "Hs", "Ws", "Hv", "Wv",
                                               "Hl", "Wl")])


def c_tables(t: RGLTables) -> _CTables:
    for k, x in zip(RGLTables._fields, t):
        if x.device != t.device or not x.is_contiguous():
            raise ValueError(f"RGL table {k}: need contiguous tensors on one device")
    M, P, T, Hv, Wv = t.vndf_data.shape
    return _CTables(*(x.data_ptr() for x in t), M, P, T, *t.ndf.shape[1:], *t.sigma.shape[1:],
                    Hv, Wv, *t.lum_data.shape[3:])


def _check_lanes(name, tables: RGLTables, mid, *lanes):
    n = mid.shape[0]
    if mid.dtype != torch.int32 or mid.dim() != 1 or not mid.is_contiguous():
        raise ValueError(f"{name}: mid must be a contiguous int32 [N] tensor")
    for x, cols in lanes:
        if x.dtype != torch.float32 or tuple(x.shape) != (n, cols) or not x.is_contiguous():
            raise ValueError(f"{name}: need contiguous float32 ({n}, {cols}), got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != mid.device:
            raise ValueError(f"{name}: lanes on different devices")
    if tables.device != mid.device:
        raise ValueError(f"{name}: tables on {tables.device}, lanes on {mid.device}")
    if mid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {mid.device}")


def rgl_eval(tables: RGLTables, mid, wi, wo):
    """(f*cos [N, 4], pdf [N]) of the measured BRDF for tangent-space wi, wo (K7 eval)."""
    _check_lanes("rgl_eval", tables, mid, (wi, 3), (wo, 3))
    if mid.device.type == "cpu":
        return rgl_eval_plain(tables, mid, wi, wo)
    lib = native.load_kernels()
    n = mid.shape[0]
    fcos = torch.empty((n, 4), dtype=torch.float32, device=mid.device)
    pdf = torch.empty((n,), dtype=torch.float32, device=mid.device)
    ct = c_tables(tables)
    code = lib.wpt_rgl_eval(ctypes.addressof(ct), mid.data_ptr(), wi.data_ptr(), wo.data_ptr(),
                            n, fcos.data_ptr(), pdf.data_ptr(), native.stream_ptr(mid))
    native.check(code, "rgl_eval")
    native.LAUNCHES["rgl_eval"] += 1
    return fcos, pdf


def rgl_sample(tables: RGLTables, mid, wi, u2):
    """(wo [N, 3], f*cos [N, 4], pdf [N], ok [N]) sampled from uniforms u2 (K7 sample)."""
    _check_lanes("rgl_sample", tables, mid, (wi, 3), (u2, 2))
    if mid.device.type == "cpu":
        return rgl_sample_plain(tables, mid, wi, u2)
    lib = native.load_kernels()
    n = mid.shape[0]
    dev = mid.device
    wo = torch.empty((n, 3), dtype=torch.float32, device=dev)
    fcos = torch.empty((n, 4), dtype=torch.float32, device=dev)
    pdf = torch.empty((n,), dtype=torch.float32, device=dev)
    ok = torch.empty((n,), dtype=torch.bool, device=dev)
    ct = c_tables(tables)
    code = lib.wpt_rgl_sample(ctypes.addressof(ct), mid.data_ptr(), wi.data_ptr(), u2.data_ptr(),
                              n, wo.data_ptr(), fcos.data_ptr(), pdf.data_ptr(), ok.data_ptr(),
                              native.stream_ptr(mid))
    native.check(code, "rgl_sample")
    native.LAUNCHES["rgl_sample"] += 1
    return wo, fcos, pdf, ok


# ---------------------------------------------------------------------------
# Lane adapters (render.bsdf dispatch)
# ---------------------------------------------------------------------------

def _lane_frame(tables: RGLTables, hr, wo_world, rgl_id):
    mid = torch.clamp(rgl_id, 0, tables.count - 1).to(torch.int32).contiguous()
    t, b = onb_from_normal_tangent(hr.normal, hr.tangent)
    # RGL convention: "wi" points toward the viewer (material_rgl.hpp:67-70).
    return mid, t, b, to_local(wo_world, t, b, hr.normal).contiguous()


def rgl_sample_lanes(tables: RGLTables, hr, wo_world, u2, rgl_id):
    """(world direction, f*cos, pdf, ok) of RGL lanes (MaterialRGL::scatter)."""
    mid, t, b, wi = _lane_frame(tables, hr, wo_world, rgl_id)
    wo, fval, pdf, ok = rgl_sample(tables, mid, wi, u2.contiguous())
    return normalize(to_world(wo, t, b, hr.normal)), fval, pdf, ok & ~hr.backside


def rgl_eval_lanes(tables: RGLTables, hr, wo_world, wd, rgl_id):
    """(f*cos, pdf, ok) toward world direction wd (MaterialRGL::scatterToDirection)."""
    mid, t, b, wi = _lane_frame(tables, hr, wo_world, rgl_id)
    fval, pdf = rgl_eval(tables, mid, wi, to_local(wd, t, b, hr.normal).contiguous())
    ok = (~hr.backside) & (dot(wd, hr.normal) > 0)
    return torch.where(ok[:, None], fval, 0.0), torch.where(ok, pdf, 0.0), ok

