"""TRS poses and quaternions (port of ``wurblpt_tpu/core/transform.py``, the
subset the camera pose, the scene builder and keyframe animation need).
Quaternion layout: [x, y, z, w].

`quat_from_axis_angle` takes sin and cos of the half angle from the C
library's ``sinf``/``cosf``, which XLA's CPU backend also calls: PyTorch's
and numpy's vectorised sin differ from them by an ulp on about 5 % of
arguments, and a building's vertices would then differ from the JAX build.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import NamedTuple

import numpy as np
import torch

from .vecmath import cross, dot, normalize


class Transformation(NamedTuple):
    """TRS pose: applies scale, then rotation, then translation."""

    translation: torch.Tensor  # [..., 3]
    rotation: torch.Tensor     # [..., 4] quaternion
    scale: torch.Tensor        # [..., 3]

    def to(self, device) -> "Transformation":
        return Transformation(*(x.to(device) for x in self))

    @staticmethod
    def make(translation=(0.0, 0.0, 0.0), rotation=None, scale=(1.0, 1.0, 1.0)):
        """A host-side pose from Python values (float32 CPU tensors)."""
        f32 = dict(dtype=torch.float32)
        rotation = torch.tensor([0.0, 0.0, 0.0, 1.0], **f32) if rotation is None else rotation
        scale = torch.as_tensor(scale, **f32)
        if scale.ndim == 0:
            scale = scale.expand(3)
        return Transformation(torch.as_tensor(translation, **f32),
                              torch.as_tensor(rotation, **f32), scale)


@functools.lru_cache(maxsize=None)
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("sinf", "cosf"):
        getattr(lib, name).restype = ctypes.c_float
        getattr(lib, name).argtypes = [ctypes.c_float]
    return lib


def quat_from_axis_angle(axis, angle) -> torch.Tensor:
    """Unit quaternion [4] of a rotation by `angle` (radians) about `axis`."""
    axis = normalize(torch.as_tensor(axis, dtype=torch.float32))
    half = float(np.float32(0.5) * np.float32(angle))
    s, c = _libm().sinf(half), _libm().cosf(half)
    return torch.cat([axis * torch.tensor(s, dtype=torch.float32),
                      torch.tensor([c], dtype=torch.float32)])


def quat_mul(a, b):
    """Hamilton product a b of quaternions [..., 4] (the rotation b, then a)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], -1)


def quat_conjugate(q):
    """The inverse rotation of a unit quaternion [..., 4]."""
    return torch.cat([-q[..., :3], q[..., 3:4]], -1)


def transform_point(tf: Transformation, p):
    """Scale, rotate, then translate points p [..., 3]."""
    return quat_rotate(tf.rotation, p * tf.scale) + tf.translation


def inverse(tf: Transformation) -> Transformation:
    """The inverse pose (transform.py `inverse`; exact for uniform scales)."""
    inv_rot = quat_conjugate(tf.rotation)
    inv_scale = 1.0 / tf.scale
    return Transformation(-quat_rotate(inv_rot, tf.translation) * inv_scale, inv_rot, inv_scale)


def quat_rotate(q, v):
    """Rotate v by unit quaternion q (v + 2w(u x v) + 2 u x (u x v))."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def quat_slerp(a, b, t):
    """Spherical lerp with shortest-arc correction; t broadcasts over the
    batch dims. Nearly parallel keys (sin theta < 1e-4) take the normalised
    lerp (transform.py:65-80)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=a.device)[..., None]
    d = dot(a, b, keepdim=True)
    b = torch.where(d < 0.0, -b, b)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.acos(d)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-4
    den = torch.where(use_lerp, 1.0, sin_theta)
    wa = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / den)
    wb = torch.where(use_lerp, t, torch.sin(t * theta) / den)
    return normalize(wa * a + wb * b)


def quat_to_mat3(q):
    """[..., 4] unit quaternions -> [..., 3, 3] rotation matrices (row major)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                     2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                     2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def from_lookat(eye, center, up=(0.0, 1.0, 0.0), device="cuda") -> Transformation:
    """Camera pose looking from eye at center; the camera looks down -z, y is up."""
    eye = torch.as_tensor(eye, dtype=torch.float32, device=device)
    center = torch.as_tensor(center, dtype=torch.float32, device=device)
    up = torch.as_tensor(up, dtype=torch.float32, device=device)
    z = -normalize(center - eye)           # camera +z is backward
    x = normalize(cross(up, z))
    y = cross(z, x)
    # Rotation matrix with columns x, y, z -> quaternion (branch-free Shepperd).
    m00, m01, m02 = x[..., 0], y[..., 0], z[..., 0]
    m10, m11, m12 = x[..., 1], y[..., 1], z[..., 1]
    m20, m21, m22 = x[..., 2], y[..., 2], z[..., 2]
    w = torch.sqrt(torch.clamp_min(1.0 + (m00 + m11 + m22), 0.0)) / 2.0
    qx = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)) / 2.0
    qy = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)) / 2.0
    qz = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)) / 2.0
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    q = normalize(torch.stack([qx, qy, qz, w], -1))
    return Transformation(eye, q, torch.ones_like(eye))
