"""Sampling warps (port of ``wurblpt_tpu/core/sampler.py``): uniforms in
[0, 1) -> geometric distributions."""

from __future__ import annotations

import math

import torch

from .onb import onb_from_normal, to_world
from .vecmath import normalize, safe_sqrt

_PI = math.pi


def in_unit_disk(u):
    """Concentric (Shirley) map of u[..., 2] to the unit disk; returns [..., 2]."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    safe_ox = torch.where(torch.abs(ox) > 0, ox, 1.0)
    safe_oy = torch.where(torch.abs(oy) > 0, oy, 1.0)
    theta = torch.where(
        use_x, (_PI / 4.0) * (oy / safe_ox), (_PI / 2.0) - (_PI / 4.0) * (ox / safe_oy))
    r = torch.where((ox == 0.0) & (oy == 0.0), 0.0, r)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)


def on_unit_sphere(u):
    """Uniform direction on the unit sphere from u[..., 2]."""
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * _PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def on_unit_hemisphere(u):
    """Uniform direction on the +z hemisphere from u[..., 2]."""
    z = u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * _PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def in_triangle(u):
    """Uniform barycentric (b1, b2) in a triangle (sqrt warp)."""
    su = safe_sqrt(u[..., 0])
    return torch.stack([1.0 - su, u[..., 1] * su], -1)


def cosine_hemisphere_local(u):
    """Cosine-weighted direction around local +z; pdf = cos(theta) / pi."""
    d = in_unit_disk(u)
    z = safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return torch.stack([d[..., 0], d[..., 1], z], -1)


def cosine_direction(n, u):
    """Cosine-weighted direction around world normal n (sampler.hpp cosineDirection)."""
    t, b = onb_from_normal(n)
    return to_world(cosine_hemisphere_local(u), t, b, n)


def cone_direction_local(cos_theta_max, u):
    """Uniform direction in the cone of half-angle acos(cos_theta_max) around
    local +z; pdf = 1 / (2 pi (1 - cos_theta_max)) (sampler.hpp toSphere)."""
    z = 1.0 + u[..., 0] * (cos_theta_max - 1.0)
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * _PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def to_sphere(center_dir, cos_theta_max, u):
    """Uniform direction in the cone subtended by a sphere seen along
    center_dir; cos_theta_max broadcasts against u[..., 0]."""
    axis = normalize(center_dir)
    t, b = onb_from_normal(axis)
    return to_world(cone_direction_local(cos_theta_max, u), t, b, axis)


def power_heuristic(pdf_a, pdf_b):
    """MIS power heuristic (beta = 2) weight for strategy a (wurblpt.hpp:101-106)."""
    a2 = pdf_a * pdf_a
    denom = a2 + pdf_b * pdf_b
    pos = denom > 0.0
    return torch.where(pos, a2 / torch.where(pos, denom, 1.0), 0.0)
