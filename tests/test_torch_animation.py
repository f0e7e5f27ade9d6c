"""Keyframe animation in the port (``wurblpt_tpu_torch/scene/animation.py``)
against the JAX package's ``scene/animation.py`` and ``core/transform.py``:
`quat_slerp`, `quat_to_mat3`, `eval_animation`, `make_anim_ctx` (per-ray
times, and one instant broadcast over the rays), `AnimCtx.ray_to_object`,
`anim_forward_frames`, and the frame rows the kernels read (`anim_frames`,
`frames_ray_to_object`) against the context they pack. Random keyframe
tables from numpy seeds: times before the first key and after the last
(clamped), on the keys, keys of one animation sharing a time, nearly
parallel rotations (the normalised lerp) and nearly antipodal ones (the
shortest-arc flip).

Tolerances: XLA on the CPU contracts the JAX package's products and sums
into fused multiply-adds, and its acos and sin are not PyTorch's (ROADMAP
C.4), so quaternions and matrices agree to 2e-6 absolute (unit-size
entries) and object rays to 1e-5 relative to their size; the key index and
the clamping are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu.core import transform as jtf
from wurblpt_tpu.scene import animation as janim
from wurblpt_tpu.scene.ir import AnimTable as JAnimTable
from wurblpt_tpu_torch.core import transform as tf
from wurblpt_tpu_torch.scene import animation as anim
from wurblpt_tpu_torch.scene.ir import AnimTable

torch.set_num_threads(2)

ATOL = 2e-6


def _unit(q):
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _tables(seed, a=6, k=4):
    """numpy keyframe tables as flatten.py pads them: row 0 the identity,
    rows 1.. with 1 to k keys (+inf past them, the last pose held)."""
    rs = np.random.default_rng(seed)
    times = np.full((a, k), np.inf, np.float32)
    trans = np.zeros((a, k, 3), np.float32)
    rot = np.zeros((a, k, 4), np.float32)
    rot[..., 3] = 1.0
    scale = np.ones((a, k, 3), np.float32)
    nkeys = np.ones((a,), np.int32)
    times[:, 0] = 0.0
    for i in range(1, a):
        n = 1 + (i - 1) % k
        nkeys[i] = n
        t = np.sort(rs.uniform(0.0, 1.0, n)).astype(np.float32)
        if i == 3 and n > 1:
            t[1] = t[0]                              # two keys at one time
        times[i, :n] = t
        trans[i, :n] = rs.uniform(-1.0, 1.0, (n, 3))
        q = _unit(rs.normal(size=(n, 4)))
        if i == 4 and n > 1:
            q[1] = _unit(-q[0] + 1e-3 * rs.normal(size=4))   # nearly antipodal
        if i == 5 and n > 1:
            q[1] = _unit(q[0] + 2e-5 * rs.normal(size=4))    # nearly parallel: the lerp
        rot[i, :n] = q
        scale[i, :n] = rs.uniform(0.5, 2.0, (n, 3))
        trans[i, n:], rot[i, n:], scale[i, n:] = trans[i, n - 1], rot[i, n - 1], scale[i, n - 1]
    return times, trans, rot, scale, nkeys


def _both(seed, **kw):
    arrays = _tables(seed, **kw)
    return (JAnimTable(*(jnp.asarray(x) for x in arrays)),
            AnimTable(*(torch.as_tensor(x) for x in arrays)), arrays)


def _times(arrays, n, seed):
    """Times before, inside and after the keys, and exactly on them."""
    rs = np.random.default_rng(seed)
    t = rs.uniform(-0.5, 1.5, n).astype(np.float32)
    keys = arrays[0][np.isfinite(arrays[0])]
    t[: n // 4] = rs.choice(keys, n // 4)
    return t


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("case", ["random", "antipodal", "parallel", "equal"])
def test_quat_slerp_and_mat3_match_jax(case):
    rs = np.random.default_rng(3)
    n = 512
    a = _unit(rs.normal(size=(n, 4)))
    b = {"random": _unit(rs.normal(size=(n, 4))),
         "antipodal": _unit(-a + 1e-4 * rs.normal(size=(n, 4))),
         "parallel": _unit(a + 1e-6 * rs.normal(size=(n, 4))),
         "equal": a.copy()}[case]
    t = rs.uniform(0.0, 1.0, n).astype(np.float32)
    ours = tf.quat_slerp(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(t))
    ref = jtf.quat_slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))
    _close(ours, ref)
    _close(tf.quat_to_mat3(ours), jtf.quat_to_mat3(ref))
    # the shortest arc: the result lies on the side of `a`
    assert (torch.sum(ours * torch.as_tensor(a), -1) > -1e-3).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_animation_matches_jax_with_clamping(seed):
    jt, pt, arrays = _both(seed)
    n = 1024
    t = _times(arrays, n, seed + 10)
    aid = np.random.default_rng(seed + 20).integers(0, pt.count, n).astype(np.int32)
    ours = anim.eval_animation(pt, torch.as_tensor(aid), torch.as_tensor(t))
    ref = janim.eval_animation(jt, jnp.asarray(aid), jnp.asarray(t))
    for a, b in zip(ours, ref):
        _close(a, b)
    # clamped outside the keys: the first key's pose before it, the last's after it
    times, trans = arrays[0], arrays[1]
    last = arrays[4][aid] - 1
    before = t < times[aid, 0]
    after = t >= times[aid, last]
    np.testing.assert_array_equal(ours.translation.numpy()[before], trans[aid[before], 0])
    np.testing.assert_array_equal(ours.translation.numpy()[after], trans[aid[after], last[after]])
    # row 0 is the identity
    static = aid == 0
    np.testing.assert_array_equal(ours.rotation.numpy()[static],
                                  np.tile([0, 0, 0, 1], (int(static.sum()), 1)))


def test_make_anim_ctx_and_object_rays_match_jax():
    jt, pt, arrays = _both(2)
    n = 512
    rs = np.random.default_rng(5)
    t = _times(arrays, n, 6)
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    ours = anim.make_anim_ctx(pt, torch.as_tensor(t), with_forward=True)
    ref = janim.make_anim_ctx(jt, jnp.asarray(t), with_forward=True)
    _close(ours.r_inv, ref.r_inv, 1e-5)
    _close(ours.t_inv, ref.t_inv)
    _close(ours.m_fwd, ref.m_fwd, 1e-5)
    assert anim.make_anim_ctx(pt, torch.as_tensor(t)).m_fwd is None
    oa, da = ours.ray_to_object(torch.as_tensor(o), torch.as_tensor(d))
    roa, rda = ref.ray_to_object(jnp.asarray(o), jnp.asarray(d))
    scale = 1.0 + np.abs(np.asarray(roa))
    assert np.all(np.abs(oa.numpy() - np.asarray(roa)) <= 1e-5 * scale)
    assert np.all(np.abs(da.numpy() - np.asarray(rda)) <= 1e-5 * (1.0 + np.abs(np.asarray(rda))))


def test_one_instant_broadcasts_as_the_per_ray_context():
    """A frame at one time builds its context for B = 1; the object rays are
    those of the per-ray context at that time, bit for bit."""
    _, pt, _ = _both(4)
    n = 300
    rs = np.random.default_rng(7)
    o = torch.as_tensor(rs.uniform(-3, 3, (n, 3)).astype(np.float32))
    d = torch.as_tensor(rs.normal(size=(n, 3)).astype(np.float32))
    one = anim.make_anim_ctx(pt, torch.tensor([0.37]), with_forward=True)
    per = anim.make_anim_ctx(pt, torch.full((n,), 0.37), with_forward=True)
    assert one.r_inv.shape[0] == 1 and per.r_inv.shape[0] == n
    for a, b in zip(one.ray_to_object(o, d), per.ray_to_object(o, d)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b", [1, 257])
def test_anim_frames_pack_the_context_and_the_forward_frames(b):
    """The rows the kernels read (r_inv | t_inv | m_fwd | m_nrm) at an
    instant are the context's and anim_forward_frames' at that time, at
    instants drawn from b (`_times`: on a key, before, inside and after the
    keys), and frames_ray_to_object moves a ray by the rows exactly as
    AnimCtx.ray_to_object does."""
    jt, pt, arrays = _both(8)
    times = _times(arrays, b, 9)
    aid = torch.arange(pt.count)
    for time in (float(x) for x in times[:: max(b // 4, 1)]):
        rows = anim.anim_frames(pt, time)
        assert rows.shape == (pt.count, anim.FRAME_WIDTH) and rows.is_contiguous()
        ctx = anim.make_anim_ctx(pt, torch.tensor([time]), with_forward=True)
        m, mn, _ = anim.anim_forward_frames(pt, aid, torch.full((pt.count,), time))
        for got, want in ((rows[:, 0:9], ctx.r_inv[0].reshape(-1, 9)),
                          (rows[:, 9:12], ctx.t_inv[0]), (rows[:, 12:21], m.reshape(-1, 9)),
                          (rows[:, 21:30], mn.reshape(-1, 9))):
            assert torch.equal(got, want)
    n = 257
    rs = np.random.default_rng(10)
    o = torch.as_tensor(rs.uniform(-3, 3, (n, 3)).astype(np.float32))
    d = torch.as_tensor(rs.normal(size=(n, 3)).astype(np.float32))
    lane_aid = torch.as_tensor(rs.integers(0, pt.count, n).astype(np.int32))
    oa, da, _ = anim.frames_ray_to_object(anim.anim_frames(pt, float(times[0])), lane_aid, o, d)
    ra, rd = anim.make_anim_ctx(pt, torch.full((n,), float(times[0])),
                                with_forward=True).ray_to_object(o, d)
    lanes = torch.arange(n)
    assert torch.equal(oa, ra[lanes, lane_aid.long()])
    assert torch.equal(da, rd[lanes, lane_aid.long()])


def test_forward_frames_match_jax():
    jt, pt, arrays = _both(11)
    n = 512
    t = _times(arrays, n, 12)
    aid = np.random.default_rng(13).integers(0, pt.count, n).astype(np.int32)
    m, mn, _ = anim.anim_forward_frames(pt, torch.as_tensor(aid), torch.as_tensor(t))
    rm, rmn, _ = janim.anim_forward_frames(jt, jnp.asarray(aid), jnp.asarray(t))
    _close(m, rm, 1e-5)
    _close(mn, rmn, 1e-5)
    # the normal matrix is the inverse transpose of the forward map
    eye = torch.linalg.inv(m).transpose(-1, -2)
    torch.testing.assert_close(mn, eye, rtol=1e-4, atol=1e-4)


def test_jax_tables_carry_across():
    """The JAX package's AnimTable and animation ids come across whole
    (scene_from_numpy); a static scene carries none."""
    from wurblpt_tpu.scene import builder as B
    from wurblpt_tpu.scene.generator import generate_quad
    from wurblpt_tpu_torch import scene_from_numpy

    sc = B.Scene()
    m = sc.take_material(B.Lambertian(albedo=(0.5, 0.5, 0.5)))
    a = sc.take_animation(B.AnimationKeyframes([0.0, 0.5, 1.0], [
        jtf.Transformation.make(translation=(0.0, 0.1 * i, 0.0)) for i in range(3)]))
    sc.take_mesh_instance(B.MeshInstance(generate_quad(), m))
    sc.take_mesh_instance(B.MeshInstance(generate_quad(), m, animation=a))
    sc.take_sphere(B.SphereObject((0, 1, 0), 0.5, m, animation=a))
    js = sc.build(use_bvh=False)
    ps = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    assert ps.n_anims == 2 and ps.tris.anim.tolist() == [0, 0, 1, 1]
    assert ps.spheres.anim.tolist() == [1]
    for f in AnimTable._fields:
        np.testing.assert_array_equal(getattr(ps.anims, f).numpy(), np.asarray(getattr(js.anims, f)))
    static = B.Scene()
    static.take_mesh_instance(B.MeshInstance(generate_quad(), static.take_material(
        B.Lambertian(albedo=(0.5, 0.5, 0.5)))))
    ps = scene_from_numpy(jax.tree_util.tree_map(np.asarray, static.build()), "cpu")
    assert ps.anims is None and ps.n_anims == 1
