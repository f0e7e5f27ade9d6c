"""Orthonormal basis construction (port of ``wurblpt_tpu/core/onb.py``)."""

from __future__ import annotations

import torch

from .vecmath import cross, dot, normalize


def onb_from_normal(n):
    """(tangent, bitangent) for unit normal n, branch-free Duff et al. 2017.

    [t, b, n] is right-handed orthonormal."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    bvar = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * bvar, -sign * nx], -1)
    b = torch.stack([bvar, sign + ny * ny * a, -ny], -1)
    return t, b


def to_world(local_dir, t, b, n):
    """Tangent-space direction (x=t, y=b, z=n) to world space."""
    return local_dir[..., 0:1] * t + local_dir[..., 1:2] * b + local_dir[..., 2:3] * n


def onb_from_normal_tangent(n, t):
    """Gram-Schmidt a supplied tangent against n; returns (t, b)."""
    t = normalize(t - dot(t, n, keepdim=True) * n)
    return t, cross(n, t)


def to_local(world_dir, t, b, n):
    """World direction into the (t, b, n) tangent frame."""
    return torch.stack([dot(world_dir, t), dot(world_dir, b), dot(world_dir, n)], -1)
