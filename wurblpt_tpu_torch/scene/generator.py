"""Procedural geometry (numpy, host side; port of ``wurblpt_tpu/scene/generator.py``):
the reference's ``generator.hpp:39-735`` set: quad, cube, disk, sphere,
cylinder and cone (open or closed), torus, the platonic solids,
`merge_meshes` and `transform_mesh`.

Each generator returns a builder :class:`~wurblpt_tpu_torch.scene.builder.Mesh`
with the same vertices, normals, texcoords and indices, bit for bit, as the
JAX package's generator of the same name. `MeshSpec.of(mesh, material, ...)`
makes a flattener spec of one.
"""

from __future__ import annotations

import numpy as np

from .builder import Mesh
from .geometryproc import compute_normals

_f32 = np.float32


def generate_quad(half_w: float = 1.0, half_h: float = 1.0, slices: int = 1) -> Mesh:
    """Unit quad in the xy plane, +z normal, uv in [0,1]^2."""
    n = slices + 1
    xs = np.linspace(-half_w, half_w, n, dtype=_f32)
    ys = np.linspace(-half_h, half_h, n, dtype=_f32)
    xx, yy = np.meshgrid(xs, ys, indexing="xy")
    pos = np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(-1, 3)
    u = (xx / (2 * half_w) + 0.5).reshape(-1)
    v = (yy / (2 * half_h) + 0.5).reshape(-1)
    uv = np.stack([u, v], -1).astype(_f32)
    nrm = np.tile(np.array([0, 0, 1], _f32), (len(pos), 1))
    idx = []
    for j in range(slices):
        for i in range(slices):
            a = j * n + i
            b = a + 1
            c = a + n
            d = c + 1
            idx += [[a, b, d], [a, d, c]]
    return Mesh(pos, nrm, uv, None, np.array(idx, np.int32))


def generate_cube(half: float = 1.0) -> Mesh:
    """Axis-aligned cube with per-face normals and uv."""
    faces = []
    # (axis, sign)
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
            corners = [
                center + (-u_ax - v_ax) * half,
                center + (u_ax - v_ax) * half,
                center + (u_ax + v_ax) * half,
                center + (-u_ax + v_ax) * half,
            ]
            faces.append((corners, nrm))
    pos, nrm_l, uv, idx = [], [], [], []
    for corners, nrm in faces:
        base = len(pos)
        pos += corners
        nrm_l += [nrm] * 4
        uv += [[0, 0], [1, 0], [1, 1], [0, 1]]
        idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return Mesh(
        np.array(pos, _f32), np.array(nrm_l, _f32), np.array(uv, _f32), None,
        np.array(idx, np.int32),
    )


def generate_disk(radius: float = 1.0, slices: int = 32) -> Mesh:
    ang = np.linspace(0, 2 * np.pi, slices + 1, dtype=_f32)[:-1]
    rim = np.stack([radius * np.cos(ang), radius * np.sin(ang), np.zeros_like(ang)], -1)
    pos = np.concatenate([[[0, 0, 0]], rim]).astype(_f32)
    uv = 0.5 + 0.5 * pos[:, :2] / radius
    nrm = np.tile(np.array([0, 0, 1], _f32), (len(pos), 1))
    idx = [[0, 1 + i, 1 + (i + 1) % slices] for i in range(slices)]
    return Mesh(pos, nrm, uv.astype(_f32), None, np.array(idx, np.int32))


def generate_sphere(radius: float = 1.0, slices: int = 32, stacks: int = 16) -> Mesh:
    pos, nrm, uv, idx = [], [], [], []
    for j in range(stacks + 1):
        v = j / stacks
        theta = v * np.pi
        for i in range(slices + 1):
            u = i / slices
            phi = u * 2 * np.pi
            d = np.array(
                [np.sin(theta) * np.sin(phi), np.cos(theta), np.sin(theta) * np.cos(phi)],
                _f32,
            )
            pos.append(radius * d)
            nrm.append(d)
            uv.append([u, 1.0 - v])
    w = slices + 1
    for j in range(stacks):
        for i in range(slices):
            a = j * w + i
            b = a + 1
            c = a + w
            d2 = c + 1
            if j > 0:
                idx.append([a, c, b])
            if j < stacks - 1:
                idx.append([b, c, d2])
    return Mesh(np.array(pos, _f32), np.array(nrm, _f32), np.array(uv, _f32), None,
                np.array(idx, np.int32))


def generate_cylinder(radius: float = 1.0, half_h: float = 1.0, slices: int = 32,
                      closed: bool = True) -> Mesh:
    pos, nrm, uv, idx = [], [], [], []
    for j, y in enumerate((-half_h, half_h)):
        for i in range(slices + 1):
            u = i / slices
            phi = u * 2 * np.pi
            d = np.array([np.cos(phi), 0.0, np.sin(phi)], _f32)
            pos.append(radius * d + np.array([0, y, 0], _f32))
            nrm.append(d)
            uv.append([u, j])
    w = slices + 1
    for i in range(slices):
        a, b, c, d2 = i, i + 1, i + w, i + w + 1
        idx += [[a, c, b], [b, c, d2]]
    mesh = Mesh(np.array(pos, _f32), np.array(nrm, _f32), np.array(uv, _f32), None,
                np.array(idx, np.int32))
    if closed:
        top = generate_disk(radius, slices)
        parts = [mesh]
        for y, flip in ((half_h, False), (-half_h, True)):
            rot = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], _f32)  # xy->xz
            p = top.positions @ rot.T
            n = top.normals @ rot.T
            if flip:
                p = p * np.array([1, -1, 1], _f32)
                n = -n
            parts.append(Mesh(p + np.array([0, y, 0], _f32), n, top.texcoords, None,
                              top.indices[:, ::-1] if flip else top.indices))
        mesh = merge_meshes(parts)
    return mesh


def generate_cone(radius: float = 1.0, height: float = 2.0, slices: int = 32,
                  closed: bool = True) -> Mesh:
    pos, nrm, uv, idx = [], [], [], []
    slope = radius / height
    for i in range(slices + 1):
        u = i / slices
        phi = u * 2 * np.pi
        d = np.array([np.cos(phi), 0.0, np.sin(phi)], _f32)
        n = d + np.array([0, slope, 0], _f32)
        n /= np.linalg.norm(n)
        pos.append(radius * d)            # base ring at y=0
        nrm.append(n)
        uv.append([u, 0.0])
        pos.append(np.array([0, height, 0], _f32))  # apex (duplicated)
        nrm.append(n)
        uv.append([u, 1.0])
    for i in range(slices):
        a = 2 * i
        idx.append([a, a + 2, a + 1])
    mesh = Mesh(np.array(pos, _f32), np.array(nrm, _f32), np.array(uv, _f32), None,
                np.array(idx, np.int32))
    if closed:
        disk = generate_disk(radius, slices)
        rot = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], _f32)
        p = disk.positions @ rot.T
        p *= np.array([1, -1, 1], _f32)
        n = -(disk.normals @ rot.T)
        mesh = merge_meshes([mesh, Mesh(p, n, disk.texcoords, None, disk.indices[:, ::-1])])
    return mesh


def generate_torus(major: float = 1.0, minor: float = 0.3, slices: int = 32,
                   rings: int = 16) -> Mesh:
    pos, nrm, uv, idx = [], [], [], []
    for j in range(rings + 1):
        v = j / rings
        beta = v * 2 * np.pi
        for i in range(slices + 1):
            u = i / slices
            alpha = u * 2 * np.pi
            c = np.array([major * np.cos(alpha), 0.0, major * np.sin(alpha)], _f32)
            d = np.array(
                [np.cos(alpha) * np.cos(beta), np.sin(beta), np.sin(alpha) * np.cos(beta)],
                _f32,
            )
            pos.append(c + minor * d)
            nrm.append(d)
            uv.append([u, v])
    w = slices + 1
    for j in range(rings):
        for i in range(slices):
            a = j * w + i
            b, c2, d2 = a + 1, a + w, a + w + 1
            idx += [[a, c2, b], [b, c2, d2]]
    return Mesh(np.array(pos, _f32), np.array(nrm, _f32), np.array(uv, _f32), None,
                np.array(idx, np.int32))


def _platonic(verts, faces) -> Mesh:
    pos = np.array(verts, _f32)
    pos /= np.linalg.norm(pos, axis=-1, keepdims=True)
    idx = np.array(faces, np.int32)
    # flat shading: split faces
    fpos = pos[idx].reshape(-1, 3)
    fidx = np.arange(len(fpos), dtype=np.int32).reshape(-1, 3)
    nrm = compute_normals(fpos, fidx)
    uv = np.zeros((len(fpos), 2), _f32)
    return Mesh(fpos, nrm, uv, None, fidx)


def generate_tetrahedron() -> Mesh:
    v = [(1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1)]
    f = [(0, 2, 1), (0, 1, 3), (0, 3, 2), (1, 2, 3)]
    return _platonic(v, f)


def generate_octahedron() -> Mesh:
    v = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    f = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
         (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    return _platonic(v, f)


def generate_icosahedron() -> Mesh:
    p = (1.0 + np.sqrt(5.0)) / 2.0
    v = [(-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0),
         (0, -1, p), (0, 1, p), (0, -1, -p), (0, 1, -p),
         (p, 0, -1), (p, 0, 1), (-p, 0, -1), (-p, 0, 1)]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    return _platonic(v, f)


def merge_meshes(meshes) -> Mesh:
    pos = np.concatenate([m.positions for m in meshes])
    nrm = np.concatenate([
        m.normals if m.normals is not None else compute_normals(m.positions, m.indices)
        for m in meshes
    ])
    uv = np.concatenate([
        m.texcoords if m.texcoords is not None else np.zeros((len(m.positions), 2), _f32)
        for m in meshes
    ])
    idx = []
    off = 0
    for m in meshes:
        idx.append(m.indices + off)
        off += len(m.positions)
    return Mesh(pos, nrm, uv, None, np.concatenate(idx))


def transform_mesh(mesh: Mesh, matrix3: np.ndarray = None, translate=(0, 0, 0),
                   scale=(1, 1, 1)) -> Mesh:
    """Convenience: bake an affine transform into a mesh copy."""
    s = np.asarray(scale, _f32)
    pos = mesh.positions * s
    nrm = None if mesh.normals is None else mesh.normals / s
    if matrix3 is not None:
        m = np.asarray(matrix3, _f32)
        pos = pos @ m.T
        if nrm is not None:
            nrm = nrm @ np.linalg.inv(m)
    pos = pos + np.asarray(translate, _f32)
    if nrm is not None:
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    return Mesh(pos.astype(_f32), None if nrm is None else nrm.astype(_f32),
                mesh.texcoords, mesh.tangents, mesh.indices)
