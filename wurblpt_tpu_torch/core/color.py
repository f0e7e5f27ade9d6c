"""Color science (port of ``wurblpt_tpu/core/color.py``): CIE color matching,
D65, XYZ <-> linear RGB with Rec.709 primaries, the sRGB transfer functions,
luminance and byte <-> float.

Every function takes a torch tensor or a numpy array and returns the same
kind: torch ops on tensors (on their device), numpy on host arrays (the
scene flattener decodes sRGB textures and integrates RGL spectra on the
host). Both evaluate the JAX package's expressions in float32, op for op.
"""

from __future__ import annotations

import numpy as np
import torch

# Rec.709 / sRGB primaries, D65 white (row-major 3 x 3).
_XYZ_TO_RGB = np.array(
    [
        [3.2406255, -1.5372080, -0.4986286],
        [-0.9689307, 1.8757561, 0.0415175],
        [0.0557101, -0.2040211, 1.0569959],
    ],
    np.float32,
)
_RGB_TO_XYZ = np.array(
    [
        [0.4124, 0.3576, 0.1805],
        [0.2126, 0.7152, 0.0722],
        [0.0193, 0.1192, 0.9505],
    ],
    np.float32,
)


def _is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def _f32(x):
    return x.to(torch.float32) if _is_torch(x) else np.asarray(x, np.float32)


def _matvec(m, x):
    if _is_torch(x):
        return torch.einsum("ij,...j->...i", torch.as_tensor(m, device=x.device), x)
    return np.einsum("ij,...j->...i", m, np.asarray(x, np.float32)).astype(np.float32)


def xyz_to_rgb(xyz):
    return _matvec(_XYZ_TO_RGB, xyz)


def rgb_to_xyz(rgb):
    return _matvec(_RGB_TO_XYZ, rgb)


def _lib(x):
    return torch if _is_torch(x) else np


def _max(x, c):
    return torch.clamp_min(x, c) if _is_torch(x) else np.maximum(x, np.float32(c))


def _pow(x, e):
    return torch.pow(x, e) if _is_torch(x) else np.power(x, np.float32(e))


def _gauss(x, alpha, mu, s1, s2):
    xp = _lib(x)
    s = xp.where(x < mu, np.float32(s1), np.float32(s2))
    t = (x - np.float32(mu)) / s
    return np.float32(alpha) * xp.exp(np.float32(-0.5) * t * t)


def color_matching_function(lambda_nm):
    """Approximate CIE 1931 2-degree CMFs (Wyman, Sloan & Shirley, JCGT 2013,
    multi-lobe fit). Wavelength in nm; returns [..., 3] = (xbar, ybar, zbar)."""
    lam = _f32(lambda_nm)
    x = (_gauss(lam, 1.056, 599.8, 37.9, 31.0) + _gauss(lam, 0.362, 442.0, 16.0, 26.7)
         + _gauss(lam, -0.065, 501.1, 20.4, 26.2))
    y = _gauss(lam, 0.821, 568.8, 46.9, 40.5) + _gauss(lam, 0.286, 530.9, 16.3, 31.1)
    z = _gauss(lam, 1.217, 437.0, 11.8, 36.0) + _gauss(lam, 0.681, 459.0, 26.0, 13.8)
    return _lib(lam).stack([x, y, z], -1)


def d65(lambda_nm):
    """Relative spectral power of CIE D65 (a 6504 K Planck radiator),
    normalized to 100 at 560 nm."""
    lam = _f32(lambda_nm)
    xp = _lib(lam)
    lam_m = lam * np.float32(1e-9)
    c2 = np.float32(1.4388e-2)
    temp = np.float32(6503.5)
    planck = (lam_m ** np.float32(-5.0)) / (xp.exp(c2 / (lam_m * temp)) - np.float32(1.0))
    lam560 = np.float32(560e-9)
    planck560 = (lam560 ** np.float32(-5.0)) / (np.exp(c2 / (lam560 * temp)) - np.float32(1.0))
    return np.float32(100.0) * planck / np.float32(planck560)


def rgb_to_srgb(rgb):
    """Linear RGB -> sRGB-encoded (color.hpp:265-275)."""
    xp = _lib(rgb)
    rgb = _f32(rgb)
    rgb = torch.clamp(rgb, 0.0, 1.0) if _is_torch(rgb) else np.clip(rgb, 0.0, 1.0)
    lo = np.float32(12.92) * rgb
    hi = np.float32(1.055) * _pow(_max(rgb, 1e-8), 1.0 / 2.4) - np.float32(0.055)
    return xp.where(rgb <= np.float32(0.0031308), lo, hi)


def srgb_to_rgb(srgb):
    """sRGB-encoded -> linear RGB (color.hpp:277-285)."""
    srgb = _f32(srgb)
    lo = srgb / np.float32(12.92)
    hi = _pow((_max(srgb, 0.0) + np.float32(0.055)) / np.float32(1.055), 2.4)
    return _lib(srgb).where(srgb <= np.float32(0.04045), lo, hi)


def rgb_luminance(rgb):
    return rgb_to_xyz(rgb)[..., 1]


def vec4(c, nir=None) -> np.ndarray:
    """A colour (a scalar, RGB or RGB + NIR) as a float32 RGB + NIR vector;
    NIR defaults to mean(RGB), the reference's Lambertian NIR synthesis
    (builder._vec4, material_lambertian.hpp)."""
    c = np.asarray(c, np.float32).reshape(-1)
    if c.size == 4:
        return c
    if c.size == 1:
        c = np.repeat(c, 3)
    return np.array([c[0], c[1], c[2], float(np.mean(c[:3])) if nir is None else nir], np.float32)


def byte_to_float(b):
    return _f32(b) / np.float32(255.0)


def float_to_byte(f):
    """[0, 1] floats to uint8, rounding half to even as jnp.round does."""
    if _is_torch(f):
        return torch.clamp(torch.round(f * 255.0), 0, 255).to(torch.uint8)
    return np.clip(np.round(np.asarray(f, np.float32) * np.float32(255.0)), 0, 255).astype(np.uint8)
