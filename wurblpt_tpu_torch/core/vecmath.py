"""Small-vector helpers over trailing-dimension tensors (port of
``wurblpt_tpu/core/vecmath.py``, the subset the ported slice uses).

Sums over the trailing axis are written out term by term, left to right, so a
kernel that evaluates the same expression in the same order gets the same
bits: `torch.sum` may reduce in another order on another device.
"""

from __future__ import annotations

import torch


def safe_sqrt(x, eps: float = 1e-20):
    """sqrt clamped away from zero (finite derivative at 0)."""
    return torch.sqrt(torch.clamp_min(x, eps))


def dot(a, b, keepdim: bool = False):
    p = a * b
    s = p[..., 0]
    for i in range(1, p.shape[-1]):
        s = s + p[..., i]
    return s.unsqueeze(-1) if keepdim else s


def normalize(a, eps: float = 1e-20):
    return a * torch.reciprocal(torch.sqrt(torch.clamp_min(dot(a, a, keepdim=True), eps)))


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def reflect(d, n):
    """Mirror direction of incident d about normal n (both unit)."""
    return d - 2.0 * dot(d, n, keepdim=True) * n


def refract(d, n, eta):
    """Refract unit direction d at normal n with relative index eta = n_i / n_t [N].

    Returns (direction, total internal reflection mask); on TIR lanes the
    direction is the reflection."""
    eta = eta[..., None]
    cos_i = -dot(d, n, keepdim=True)
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    refr = eta * d + (eta * cos_i - cos_t) * n
    return torch.where(tir, reflect(d, n), normalize(refr)), tir[..., 0]
