"""The port's watertight ray/triangle test against the JAX package's.

Same rays and triangles, made with numpy from a seed, through
`intersect.watertight_tri` of both packages. The arithmetic is the same op
for op in f32, so the verdicts must be equal and t/u/v agree to rtol 1e-6
(XLA may order a fused expression differently than PyTorch by an ulp). Rays
aimed exactly at shared edges and vertices take the two-product branch and
must never leak between two neighbouring triangles, nor through a closed
mesh behind the port's BVH."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu.render.intersect import watertight_tri as jwatertight_tri
from wurblpt_tpu_torch.accel.traverse import bvh_closest_hit
from wurblpt_tpu_torch.render.intersect import watertight_tri
from wurblpt_tpu_torch.render.intersect_brute import BIG
from wurblpt_tpu_torch.scene.flatten import MeshSpec, flatten_meshes, material_table
from wurblpt_tpu_torch.scene.generator import generate_cube
from wurblpt_tpu_torch.scene.ir import MaterialType

torch.set_num_threads(2)


def _both(o, d, v0, v1, v2, t_min, t_max):
    """(port results, JAX results) as numpy, on [N, K] ray/triangle pairs."""
    args = (o[:, None], d[:, None], v0, v1, v2, t_min[:, None], t_max[:, None])
    ours = watertight_tri(*(torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in args))
    ref = jwatertight_tri(*(jnp.asarray(a, jnp.float32) for a in args))
    return [x.numpy() for x in ours], [np.asarray(x) for x in ref]


def _assert_agree(ours, ref):
    t, u, v, valid = ours
    jt, ju, jv, jvalid = ref
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(t[valid], jt[valid], rtol=1e-6)
    np.testing.assert_allclose(u[valid], ju[valid], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(v[valid], jv[valid], rtol=1e-6, atol=1e-7)
    assert (t[~valid] == np.float32(BIG)).all()


@pytest.mark.parametrize("dirs", ["random", "axis-aligned"])
def test_watertight_matches_jax_on_random_pairs(dirs):
    rs = np.random.default_rng(7)
    n, k = 2048, 8
    o = rs.uniform(-2.0, 2.0, size=(n, 3))
    if dirs == "random":
        d = rs.normal(size=(n, 3))
    else:   # +-x, +-y, +-z: zero components everywhere, both shear signs
        d = np.eye(3)[rs.integers(0, 3, n)] * rs.choice([-1.0, 1.0], size=(n, 1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # Triangles around points ahead of each ray, so a good share is hit.
    c = o[:, None] + d[:, None] * rs.uniform(0.5, 3.0, size=(n, k, 1))
    v0, v1, v2 = (c + rs.normal(scale=0.5, size=(n, k, 3)) for _ in range(3))
    t_min = np.full((n,), 1e-4)
    t_max = np.where(rs.uniform(size=n) < 0.3, rs.uniform(0.5, 3.0, size=n), BIG)
    ours, ref = _both(o, d, v0, v1, v2, t_min, t_max)
    _assert_agree(ours, ref)
    assert 0.05 < ours[3].mean() < 0.95


def test_shared_edge_rays_take_the_compensated_branch_alike():
    """Rays exactly through the shared edge of two triangles: both packages
    agree, and every ray hits at least one side (no leak)."""
    rs = np.random.default_rng(1)
    n = 4096
    x = (rs.random(n) * 2.0 - 1.0).astype(np.float32)
    tgt = np.stack([x, np.zeros(n, np.float32), np.zeros(n, np.float32)], -1)
    tilt = rs.normal(scale=0.3, size=(n, 3)) * [1.0, 1.0, 0.0]
    d = np.array([0.0, 0.0, -1.0]) + tilt
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = tgt - 2.0 * d
    v0 = np.tile([[-1.0, 0.0, 0.0]], (n, 2, 1))
    v1 = np.tile([[1.0, 0.0, 0.0]], (n, 2, 1))
    v2 = np.tile([[[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]]], (n, 1, 1))
    ours, ref = _both(o, d, v0, v1, v2, np.full((n,), 1e-4), np.full((n,), 1e9))
    _assert_agree(ours, ref)
    assert ours[3].any(-1).all(), f"{(~ours[3].any(-1)).sum()}/{n} edge rays missed both"


def _edge_targets(pos, idx, n, rs):
    """n points exactly on edges (a quarter on vertices, a quarter on midpoints)."""
    edges = np.concatenate([idx[:, [0, 1]], idx[:, [1, 2]], idx[:, [2, 0]]], 0)
    e = edges[rs.integers(0, len(edges), n)]
    s = rs.random(n).astype(np.float32)
    s[: n // 8] = 0.0
    s[n // 8: n // 4] = 1.0
    s[n // 4: n // 2] = 0.5
    a, b = pos[e[:, 0]], pos[e[:, 1]]
    return a + s[:, None] * (b - a)


def _icosahedron():
    """Closed, welded icosahedron (12 shared vertices, 20 faces)."""
    p = (1.0 + 5.0 ** 0.5) / 2.0
    pos = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0], [0, -1, p], [0, 1, p],
                    [0, -1, -p], [0, 1, -p], [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]],
                   np.float32)
    idx = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                    [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                    [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                    [8, 6, 7], [9, 8, 1]], np.int32)
    return MeshSpec(pos, None, np.zeros((12, 2), np.float32), idx, 0)


@pytest.mark.parametrize("mesh", ["cube", "icosahedron"])
def test_no_leaks_through_a_closed_mesh_behind_the_bvh(mesh):
    spec = generate_cube(1.0) if mesh == "cube" else _icosahedron()
    scene = flatten_meshes([spec], material_table([(MaterialType.LAMBERTIAN, 0.5, None)]),
                           "cpu", use_bvh=True)
    rs = np.random.default_rng(0)
    n = 1 << 15
    tgt = _edge_targets(np.asarray(spec.positions), np.asarray(spec.indices), n, rs)
    out = tgt / np.maximum(np.linalg.norm(tgt, axis=1, keepdims=True), 1e-9)
    f32 = dict(dtype=torch.float32)
    o = torch.as_tensor(tgt + 2.0 * out, **f32)
    d = torch.as_tensor(-out, **f32)
    _, prim, _, _ = bvh_closest_hit(scene.bvh, o, d, torch.full((n,), 1e-4),
                                    torch.full((n,), BIG))
    assert int((prim < 0).sum()) == 0, f"{int((prim < 0).sum())}/{n} edge rays leaked"
