"""Procedural meshes (numpy, host side): the subset of
``wurblpt_tpu/scene/generator.py`` the mesh and city paths' scenes use.

Each generator returns a :class:`~wurblpt_tpu_torch.scene.flatten.MeshSpec`
with the same vertices, normals, texcoords and indices, bit for bit, as the
JAX package's generator of the same name.
"""

from __future__ import annotations

import numpy as np

from .flatten import MeshSpec

_f32 = np.float32


def generate_quad(half_w: float = 1.0, half_h: float = 1.0, slices: int = 1,
                  material: int = 0) -> MeshSpec:
    """Quad in the xy plane, +z normal, uv in [0, 1]^2, slices x slices cells."""
    n = slices + 1
    xs = np.linspace(-half_w, half_w, n, dtype=_f32)
    ys = np.linspace(-half_h, half_h, n, dtype=_f32)
    xx, yy = np.meshgrid(xs, ys, indexing="xy")
    pos = np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(-1, 3)
    uv = np.stack([(xx / (2 * half_w) + 0.5).reshape(-1), (yy / (2 * half_h) + 0.5).reshape(-1)],
                  -1).astype(_f32)
    nrm = np.tile(np.array([0, 0, 1], _f32), (len(pos), 1))
    idx = []
    for j in range(slices):
        for i in range(slices):
            a = j * n + i
            idx += [[a, a + 1, a + n + 1], [a, a + n + 1, a + n]]
    return MeshSpec(pos.astype(_f32), nrm, uv, np.array(idx, np.int32), material)


def generate_cube(half: float = 1.0, material: int = 0) -> MeshSpec:
    """Axis-aligned cube with per-face normals and uv (12 triangles)."""
    pos, nrm_l, uv, idx = [], [], [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            nrm = np.zeros(3, _f32)
            nrm[axis] = sign
            u_ax = np.zeros(3, _f32)
            v_ax = np.zeros(3, _f32)
            u_ax[(axis + 1) % 3] = 1.0
            v_ax[(axis + 2) % 3] = 1.0
            if sign < 0:
                u_ax = -u_ax
            center = nrm * half
            base = len(pos)
            pos += [center + (-u_ax - v_ax) * half, center + (u_ax - v_ax) * half,
                    center + (u_ax + v_ax) * half, center + (-u_ax + v_ax) * half]
            nrm_l += [nrm] * 4
            uv += [[0, 0], [1, 0], [1, 1], [0, 1]]
            idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return MeshSpec(np.array(pos, _f32), np.array(nrm_l, _f32), np.array(uv, _f32),
                    np.array(idx, np.int32), material)


def generate_sphere(radius: float = 1.0, slices: int = 32, stacks: int = 16,
                    material: int = 0) -> MeshSpec:
    """UV sphere: (stacks + 1) x (slices + 1) vertices, poles without slivers."""
    pos, nrm, uv, idx = [], [], [], []
    for j in range(stacks + 1):
        v = j / stacks
        theta = v * np.pi
        for i in range(slices + 1):
            u = i / slices
            phi = u * 2 * np.pi
            d = np.array([np.sin(theta) * np.sin(phi), np.cos(theta), np.sin(theta) * np.cos(phi)],
                         _f32)
            pos.append(radius * d)
            nrm.append(d)
            uv.append([u, 1.0 - v])
    w = slices + 1
    for j in range(stacks):
        for i in range(slices):
            a = j * w + i
            b = a + 1
            c = a + w
            if j > 0:
                idx.append([a, c, b])
            if j < stacks - 1:
                idx.append([b, c, c + 1])
    return MeshSpec(np.array(pos, _f32), np.array(nrm, _f32), np.array(uv, _f32),
                    np.array(idx, np.int32), material)
