"""Fresnel terms (port of ``wurblpt_tpu/core/fresnel.py``, what GGX needs)."""

from __future__ import annotations

import torch


def fresnel_schlick(cos_theta, r0):
    """Schlick approximation; broadcasts over channel dims of r0.

    c^5 as c * ((c * c) * (c * c)), the product order of JAX's integer_pow."""
    c = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    c2 = c * c
    return r0 + (1.0 - r0) * (c * (c2 * c2))
