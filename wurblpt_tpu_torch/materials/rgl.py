"""RGL (EPFL) measured BRDFs (port of ``wurblpt_tpu/materials/rgl.py``).

Host side (numpy): the ``tensor_file`` parser, the per-slice CDFs of
powitacq's Marginal2D constructor, `load_rgl_material` for RGB and spectral
datasets (a spectral table integrated to RGB + NIR at load time through
:mod:`wurblpt_tpu_torch.core.color`) and `stack_rgl_tables`, which stacks
every material of a scene, zero-padded, into one :class:`RGLTables`.

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

Backward: where a float table or a lane direction requires grad, `rgl_eval`
and `rgl_sample` go on the autograd tape (`RglEval`, `RglSample`), whose
backward is K7T (`rgl_bwd`, ``csrc/backward.cu``). Where only the
reflectance tail's tables (rgb, ndf, sigma: `TAIL_TABLES`) are on the
tape, its tail form gives their cotangents from that of f*cos,
scatter-added into their bilinear cells. Otherwise its full form runs
reverse mode through the whole forward: every float table (`GRAD_TABLES`,
the warps' and the parameter grids' too) and the directions (eval's wi and
wo, sample's wi) from the cotangents of f*cos, the pdf and sample's wo,
as `jax.grad` differentiates the JAX package's rgl_eval / rgl_sample
(searches are discrete: a cotangent lands on the entries read at the cell
found). Its plain version (`rgl_bwd_plain`) is autograd through the plain
forward.

`rgl_sample_lanes` / `rgl_eval_lanes` are the bsdf lane adapters: world
directions into the hit's tangent frame and back.
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

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


def _spectra_to_rgb4(spectra: np.ndarray, wavelengths: np.ndarray,
                     nir_wavelength: float = 850.0) -> np.ndarray:
    """Spectral tables [P, T, S, H, W] -> RGB + NIR [P, T, 4, H, W]
    (MaterialRGLSpectral::toAttenuation, material_rgl.hpp:137-153): the
    visible samples (360-780 nm) integrated against D65 x the CIE matching
    functions and taken to RGB, normalized so a flat unit spectrum is white,
    and the slice nearest `nir_wavelength` as NIR. Linear in the spectra, so
    exact per texel. The weights are float32, as the JAX package computes
    them; the sum over wavelengths float64."""
    from ..core.color import color_matching_function, d65, xyz_to_rgb

    wl = np.asarray(wavelengths, np.float64)
    first = int(np.argmax(wl >= 360.0)) if np.any(wl >= 360.0) else 0
    below = np.nonzero(wl <= 780.0)[0]
    last = int(below[-1]) if below.size else len(wl) - 1
    nearest = int(np.argmin(np.abs(wl - nir_wavelength)))
    sel = np.arange(first, last + 1)
    lam = wl[sel].astype(_f32)
    illum = np.asarray(d65(lam), np.float64)                           # [S']
    cmf = np.asarray(color_matching_function(lam), np.float64)         # [S', 3]
    # the reference's integration factor cancels out of xyz * 100 / N
    w_xyz = illum[:, None] * cmf * (1.0 / max(float(np.sum(illum * cmf[:, 1])), 1e-30))
    w_rgb = np.asarray(xyz_to_rgb(w_xyz.astype(_f32)), np.float64)
    rgb = np.einsum("ptshw,sc->ptchw", spectra[:, :, sel].astype(np.float64), w_rgb)
    nir = spectra[:, :, nearest:nearest + 1].astype(np.float64)
    return np.concatenate([rgb, nir], axis=2).astype(_f32)


def load_rgl_material(source, nir_wavelength: float = 850.0) -> dict:
    """One RGL dataset (a path or a parsed field dict) as numpy tables ready for
    stacking (powitacq_rgb.inl:891-1007). An RGB dataset's NIR channel is the
    mean of RGB (material_rgl.hpp:45-46); a spectral one's tables are taken to
    RGB + NIR by `_spectra_to_rgb4` (NIR the slice nearest `nir_wavelength`)."""
    fields = read_tensor_file(source) if isinstance(source, str) else dict(source)
    phi_i = np.asarray(fields["phi_i"], _f32).reshape(-1)
    theta_i = np.asarray(fields["theta_i"], _f32).reshape(-1)
    vndf = np.asarray(fields["vndf"], _f32)
    lum = np.asarray(fields["luminance"], _f32)
    if vndf.shape[:2] != (len(phi_i), len(theta_i)):
        raise ValueError("vndf shape does not match phi_i/theta_i grids")
    if "rgb" in fields:
        rgb = np.asarray(fields["rgb"], _f32)                  # [P, T, 3, H, W]
        rgb4 = np.concatenate([rgb, rgb.mean(axis=2, keepdims=True)], axis=2)
    elif "spectra" in fields:
        rgb4 = _spectra_to_rgb4(np.asarray(fields["spectra"], _f32),
                                np.asarray(fields["wavelengths"], _f32), nir_wavelength)
    else:
        raise ValueError("RGL dataset has neither 'rgb' nor 'spectra' field")
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


# While `rgl_bwd_plain` records the sums of |term| of each table's
# cotangent, the id of each leaf table -> its buffer of those sums.
_MAGS: Optional[Dict[int, torch.Tensor]] = None


def _read(arr, idx):
    """arr[idx]: a table read of the plain version. While `rgl_bwd_plain`
    records magnitudes, the read's |cotangent| is scatter-added into the
    table's buffer: the sum of |term| over the terms K7T's atomics add into
    each entry."""
    v = arr[idx]
    mag = None if _MAGS is None else _MAGS.get(id(arr))
    if mag is not None and v.requires_grad:
        if any(isinstance(i, slice) for i in idx):   # a whole axis: index it explicitly
            idx = tuple(torch.arange(arr.shape[k], device=arr.device)[None, :]
                        if isinstance(i, slice) else i[:, None] for k, i in enumerate(idx))

        def hook(g):
            mag.index_put_(idx, g.abs(), accumulate=True)

        v.register_hook(hook)
    return v


def _param_weights(vals, nvals, mid, x):
    """Grid cell and lerp weight of x in a material's sorted parameter grid
    (powitacq_rgb.inl:335-355)."""
    row = _read(vals, (mid,))
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
        v = _read(arr, (fr.mid, p, t) + idx)
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
    v00, v10 = _read(arr, (mid, y0, x0)), _read(arr, (mid, y0, x0 + 1))
    v01, v11 = _read(arr, (mid, y1, x0)), _read(arr, (mid, y1, x0 + 1))
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
    t = RGLTables(*(x.detach() for x in t))
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


# The tables the reflectance tail reads: a tape with only these on it takes
# K7T's tail form.
TAIL_TABLES = ("rgb", "ndf", "sigma")
# Every float table, in RGLTables' order: those K7T's full form carries
# (the integer fields take no gradient).
GRAD_TABLES = ("phi_i", "theta_i", "ndf", "sigma", "vndf_data", "vndf_marg", "vndf_cond",
               "lum_data", "lum_marg", "lum_cond", "rgb")


def _tape(tables: RGLTables, *lanes) -> Optional[str]:
    """The form of K7T a call's backward takes: None (no input requires
    grad, or grad mode is off), "tail" (only `TAIL_TABLES` require grad) or
    "full" (another table or a lane direction does)."""
    if not torch.is_grad_enabled():
        return None
    needs = {k for k in GRAD_TABLES if getattr(tables, k).requires_grad}
    if any(x.requires_grad for x in lanes) or needs - set(TAIL_TABLES):
        return "full"
    return "tail" if needs else None


def rgl_eval(tables: RGLTables, mid, wi, wo):
    """(f*cos [N, 4], pdf [N]) of the measured BRDF for tangent-space wi, wo
    (K7 eval). Where a float table, wi or wo requires grad (and grad mode is
    on), the call is on the tape: its backward is K7T (`RglEval`); the pdf
    carries a gradient where K7T's full form runs (only the warps, the
    parameter grids and the directions reach it)."""
    form = _tape(tables, wi, wo)
    if form:
        return RglEval.apply(tables, mid, wi, wo, form == "full",
                             *(getattr(tables, k) for k in GRAD_TABLES))
    return rgl_eval_raw(tables, mid, wi, wo)


def rgl_eval_raw(tables: RGLTables, mid, wi, wo):
    """K7 eval without a tape: the kernel on CUDA tensors, the plain version on CPU tensors."""
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
    """(wo [N, 3], f*cos [N, 4], pdf [N], ok [N]) sampled from uniforms u2
    (K7 sample); on the tape as `rgl_eval` (`RglSample`): f*cos carries a
    gradient, and where K7T's full form runs wo and the pdf do too."""
    form = _tape(tables, wi)
    if form:
        return RglSample.apply(tables, mid, wi, u2, form == "full",
                               *(getattr(tables, k) for k in GRAD_TABLES))
    return rgl_sample_raw(tables, mid, wi, u2)


def rgl_sample_raw(tables: RGLTables, mid, wi, u2):
    """K7 sample without a tape: the kernel on CUDA tensors, the plain version on CPU tensors."""
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
# K7T: the measured RGL BRDF's backward
# ---------------------------------------------------------------------------

def rgl_bwd_plain(tables, mid, wi, x, g_f, sample: bool, magnitudes: bool = False,
                  full: bool = False, g_pdf=None, g_wo=None):
    """Plain version of K7T, autograd through the plain forward of K7 eval (x
    = wo [N, 3]) or sample (x = the uniforms [N, 2]): a dict of cotangents.
    The tail form: those of `TAIL_TABLES` from g_f [N, 4], that of f*cos.
    With `full`: those of every table of `GRAD_TABLES` and of wi (eval: and
    of wo, "wo") from g_f, g_pdf [N] and (sample) g_wo [N, 3], the
    cotangents of f*cos, the pdf and the sampled direction (None: zeros).
    With `magnitudes`, also a dict of each table's sums of |term| over the
    terms its entries receive (each table read's |cotangent|, `_read`).

    The full form takes a lane whose cotangents are all zero at a stand-in
    direction (its terms are zero wherever they are taken): the chain rule
    at the lane's own directions can give 0 x NaN there (atan2's derivative
    at a zero direction, as a render hands the lanes of other materials,
    and a division by a zero jacobian)."""
    global _MAGS
    names = GRAD_TABLES if full else TAIL_TABLES
    with torch.enable_grad():
        leaves = {k: getattr(tables, k).detach().requires_grad_() for k in names}
        t = tables._replace(**leaves)
        if full:
            g_pdf = torch.zeros_like(g_f[:, 0]) if g_pdf is None else g_pdf
            g_wo = torch.zeros_like(wi) if g_wo is None else g_wo
            quiet = (g_f == 0).all(-1) & (g_pdf == 0) & ((g_wo == 0).all(-1) | (not sample))
            stand = torch.tensor([0.6, 0.0, 0.8], dtype=wi.dtype, device=wi.device)
            leaves["wi"] = wi.detach().requires_grad_()
            wi = torch.where(quiet[:, None], stand, leaves["wi"])
            if not sample:
                leaves["wo"] = x.detach().requires_grad_()
                x = torch.where(quiet[:, None], stand, leaves["wo"])
        _MAGS = {id(leaves[k]): torch.zeros_like(leaves[k]) for k in names} if magnitudes else None
        try:
            if sample:
                wo, f, pdf, _ = rgl_sample_plain(t, mid, wi, x)
            else:
                f, pdf = rgl_eval_plain(t, mid, wi, x)
            mags = _MAGS
        finally:
            _MAGS = None
        outs, cots = [f], [g_f]
        if full:
            outs.append(pdf)
            cots.append(g_pdf)
            if sample:
                outs.append(wo)
                cots.append(g_wo)
        grads = torch.autograd.grad(outs, list(leaves.values()), cots, allow_unused=True)
    out = {k: torch.zeros_like(v) if gr is None else gr
           for (k, v), gr in zip(leaves.items(), grads)}
    if magnitudes:
        return out, {k: mags[id(leaves[k])] for k in names}
    return out


class _CGrads(ctypes.Structure):
    """struct RglOut of csrc/backward_common.cuh: the cotangents of `GRAD_TABLES`,
    then of the lanes' wi and wo (null where a launch writes none)."""

    _fields_ = [(k, ctypes.c_void_p) for k in GRAD_TABLES + ("wi", "wo")]


def rgl_bwd(tables, mid, wi, x, g_f, sample: bool, full: bool = False, g_pdf=None, g_wo=None):
    """K7T (``csrc/backward.cu``): `rgl_bwd_plain`'s function (without
    magnitudes), the kernel on CUDA tensors: its tail form, or with `full`
    its full form."""
    g_f = g_f.contiguous()
    n = mid.shape[0]
    if full:
        g_pdf = torch.zeros_like(g_f[:, 0]) if g_pdf is None else g_pdf.contiguous()
        if sample:
            g_wo = torch.zeros_like(g_f[:, :3]) if g_wo is None else g_wo.contiguous()
    if wi.device.type == "cpu":
        return rgl_bwd_plain(tables, mid, wi, x, g_f, sample, full=full, g_pdf=g_pdf, g_wo=g_wo)
    if wi.device.type != "cuda":
        raise ValueError(f"rgl_bwd: no kernel for device {wi.device}")
    lib = native.load_kernels()
    names = GRAD_TABLES if full else TAIL_TABLES
    out = {k: torch.zeros_like(getattr(tables, k)) for k in names}
    if full:
        out["wi"] = torch.empty_like(wi)
        if not sample:
            out["wo"] = torch.empty_like(x)
    co = _CGrads(*(out[k].data_ptr() if k in out else None for k, _ in _CGrads._fields_))
    ct = c_tables(tables)
    code = lib.wpt_rgl_bwd(ctypes.addressof(ct), ctypes.addressof(co), mid.data_ptr(),
                           wi.detach().contiguous().data_ptr(),
                           x.detach().contiguous().data_ptr(), n, int(sample), int(full),
                           g_f.data_ptr(), None if g_pdf is None else g_pdf.data_ptr(),
                           g_wo.data_ptr() if full and sample else None,
                           native.stream_ptr(wi))
    native.check(code, "rgl_bwd")
    native.LAUNCHES["rgl_bwd_full" if full else "rgl_bwd"] += 1
    return out


class RglEval(torch.autograd.Function):
    """K7 eval forward, K7T backward: its tail form where only `TAIL_TABLES`
    are on the tape (the pdf reads none of them: not differentiable), else
    its full form (f*cos and the pdf into every table and wi, wo)."""

    @staticmethod
    def forward(ctx, tables, mid, wi, wo, full, *grad_tables):
        fcos, pdf = rgl_eval_raw(tables, mid, wi, wo)
        ctx.tables, ctx.full = tables, full
        ctx.save_for_backward(mid, wi, wo)
        if not full:
            ctx.mark_non_differentiable(pdf)
        return fcos, pdf

    @staticmethod
    def backward(ctx, g_f, g_pdf):
        mid, wi, wo = ctx.saved_tensors
        g = rgl_bwd(ctx.tables, mid, wi, wo, g_f, sample=False, full=ctx.full, g_pdf=g_pdf)
        return (None, None, g.get("wi"), g.get("wo"), None, *(g.get(k) for k in GRAD_TABLES))


class RglSample(torch.autograd.Function):
    """K7 sample forward, K7T backward: the tail form (f*cos only) or the
    full form (f*cos, the pdf and wo into every table and wi)."""

    @staticmethod
    def forward(ctx, tables, mid, wi, u2, full, *grad_tables):
        wo, fcos, pdf, ok = rgl_sample_raw(tables, mid, wi, u2)
        ctx.tables, ctx.full = tables, full
        ctx.save_for_backward(mid, wi, u2)
        ctx.mark_non_differentiable(ok, *(() if full else (wo, pdf)))
        return wo, fcos, pdf, ok

    @staticmethod
    def backward(ctx, g_wo, g_f, g_pdf, _g_ok):
        mid, wi, u2 = ctx.saved_tensors
        g = rgl_bwd(ctx.tables, mid, wi, u2, g_f, sample=True, full=ctx.full, g_pdf=g_pdf,
                    g_wo=g_wo)
        return (None, None, g.get("wi"), None, None, *(g.get(k) for k in GRAD_TABLES))


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

