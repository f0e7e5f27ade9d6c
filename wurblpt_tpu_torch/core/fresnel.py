"""Fresnel terms (port of ``wurblpt_tpu/core/fresnel.py:10-35``)."""

from __future__ import annotations

import torch

from .vecmath import safe_sqrt


def schlick_r0(n_i, n_t):
    """Normal-incidence reflectance from refractive indices (fresnel.py:10-13)."""
    r = (n_i - n_t) / (n_i + n_t)
    return r * r


def fresnel_schlick(cos_theta, r0):
    """Schlick approximation; broadcasts over channel dims of r0.

    c^5 as c * ((c * c) * (c * c)), the product order of JAX's integer_pow."""
    c = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    c2 = c * c
    return r0 + (1.0 - r0) * (c * (c2 * c2))


def fresnel_unpolarized(cos_i, n_i, n_t):
    """Exact unpolarized Fresnel reflectance of a dielectric interface
    (fresnel.py:22-35); cos_i >= 0 on the incident side, 1 under total
    internal reflection. Tensors broadcast."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    eta = n_i / n_t
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    r_s = (n_i * cos_i - n_t * cos_t) / torch.clamp_min(n_i * cos_i + n_t * cos_t, 1e-12)
    r_p = (n_i * cos_t - n_t * cos_i) / torch.clamp_min(n_i * cos_t + n_t * cos_i, 1e-12)
    f = 0.5 * (r_s * r_s + r_p * r_p)
    return torch.where(tir, 1.0, f)
