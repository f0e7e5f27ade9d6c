"""Host-side geometry processing (numpy; port of ``wurblpt_tpu/scene/geometryproc.py``):
smooth vertex normals and per-vertex tangents (geometryproc.hpp).

The same numpy expressions as the JAX package's, so a mesh gets the same
normals and tangents, bit for bit, in both packages.
"""

from __future__ import annotations

import numpy as np

_f32 = np.float32


def compute_normals(positions: np.ndarray, indices: np.ndarray,
                    crease_angle_deg: float = 0.0) -> np.ndarray:
    """Area-weighted smooth vertex normals (geometryproc.hpp:58).

    As in the JAX package, `crease_angle_deg` splits nothing: splitting at
    creases is left to the importer, and every vertex gets the normalized sum
    of its faces' area-weighted normals."""
    positions = np.asarray(positions, _f32)
    indices = np.asarray(indices, np.int64)
    v0, v1, v2 = (positions[indices[:, k]] for k in range(3))
    fn = np.cross(v1 - v0, v2 - v0)  # length = 2 * area: area weighting for free
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, indices[:, k], fn)
    ln = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = np.where(ln > 1e-20, normals / np.maximum(ln, 1e-20), np.array([0.0, 0.0, 1.0], _f32))
    return normals.astype(_f32)


def compute_tangents(positions, normals, texcoords, indices) -> np.ndarray:
    """Per-vertex tangents from uv gradients, Gram-Schmidt against the normal
    (geometryproc.hpp:181)."""
    positions = np.asarray(positions, _f32)
    texcoords = np.asarray(texcoords, _f32)
    indices = np.asarray(indices, np.int64)
    v0, v1, v2 = (positions[indices[:, k]] for k in range(3))
    w0, w1, w2 = (texcoords[indices[:, k]] for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    x1, x2 = w1 - w0, w2 - w0
    det = x1[:, 0] * x2[:, 1] - x2[:, 0] * x1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(np.abs(det) == 0, 1.0, det), 0.0)
    tan = (e1 * x2[:, 1:2] - e2 * x1[:, 1:2]) * r[:, None]
    tangents = np.zeros_like(positions)
    for k in range(3):
        np.add.at(tangents, indices[:, k], tan)
    normals = np.asarray(normals, _f32)
    tangents -= normals * np.sum(tangents * normals, axis=-1, keepdims=True)
    ln = np.linalg.norm(tangents, axis=-1, keepdims=True)
    # Fallback: any vector perpendicular to n.
    alt = np.cross(normals, np.where(np.abs(normals[:, 0:1]) < 0.9,
                                     np.array([1.0, 0, 0], _f32), np.array([0, 1.0, 0], _f32)))
    alt /= np.maximum(np.linalg.norm(alt, axis=-1, keepdims=True), 1e-20)
    tangents = np.where(ln > 1e-8, tangents / np.maximum(ln, 1e-20), alt)
    return tangents.astype(_f32)
