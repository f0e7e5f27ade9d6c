"""K7's contract for lanes without an RGL material (a negative id), on the
CPU through the plain versions.

The bsdf lane adapters hand K7 every lane of a bounce, the other materials'
with their id -1 (``materials/rgl.py`` `_lane_frame`); K7 gives such a lane
zeros (sample: ok false), which the callers never select, and skips it on
the card. Held here: the plain eval and sample give exactly the in-range
outputs on lanes with an id and zeros on the others (an id past the stack
reads its last material, as the kernel clamps it); `bsdf_sample` and
`bsdf_eval` on the mixed-material lanes of a material_comparison render
give the same bits with the ids as they are and with the ids clamped into
the stack (every lane computed, as K7 ran before it skipped them), and so
does the frame; the RGL gradients of a mixed batch (K7T's tail and full
forms through `RglEval` / `RglSample`, the plain backward on the CPU)
equal those of the same lanes at id 0 with those lanes' cotangents
zeroed, and are finite."""

import numpy as np
import pytest
import torch

from wurblpt_tpu_torch.materials import rgl
from wurblpt_tpu_torch.render import integrator, wavefront
from wurblpt_tpu_torch.scene.ir import MaterialType
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)


def _tables():
    return rgl.stack_rgl_tables([rgl.load_rgl_material(scenes.synthetic_rgl_fields(s))
                                 for s in (0, 1)], "cpu")


def _lanes(n=2048, seed=11):
    rs = np.random.default_rng(seed)

    def dirs():
        x = rs.standard_normal((n, 3))
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        x[:, 2] = np.abs(x[:, 2]) * np.where(rs.uniform(size=n) < 0.15, -1.0, 1.0)
        return torch.as_tensor(x.astype(np.float32))

    mid = torch.as_tensor(rs.integers(-1, 3, n).astype(np.int32))   # -1, 0, 1, 2 (past the stack)
    return mid, dirs(), dirs(), torch.as_tensor(rs.uniform(size=(n, 2)).astype(np.float32))


def _same_bits(a, b):
    return kc.lanes_differ(a, b) == 0


def test_plain_versions_zero_the_lanes_without_a_material():
    t = _tables()
    mid, wi, wo, u2 = _lanes()
    live = mid >= 0
    inside = torch.clamp(mid, 0, t.count - 1)
    for fn, x in ((rgl.rgl_eval_plain, wo), (rgl.rgl_sample_plain, u2)):
        got, ref = fn(t, mid, wi, x), fn(t, inside, wi, x)
        for a, b in zip(got, ref):
            assert _same_bits(a[live], b[live])
            assert bool((a[~live] == 0).all()) and not bool(torch.signbit(a[~live].float()).any())
        assert bool(got[-1][live].any())
    # the wrappers on CPU tensors are the plain versions
    for a, b in zip(rgl.rgl_sample(t, mid, wi, u2), rgl.rgl_sample_plain(t, mid, wi, u2)):
        assert _same_bits(a, b)


def _material_comparison():
    """The app's scene and aspect at 112 x 36, 1 spp, 3 path components:
    the camera sees no RGL lane, its reflections a few."""
    scene = scenes.material_comparison("cpu")
    return scene, kc.example_frame("material_comparison", "cpu", scene, 112, 36, 1, 3)


def _clamped_lane_frame(lane_frame):
    """`_lane_frame` with the ids clamped into the stack first: every lane
    computed, as K7 ran before it skipped the lanes without a material."""
    def frame(tables, hr, wo_world, rgl_id):
        return lane_frame(tables, hr, wo_world, torch.clamp(rgl_id, 0, tables.count - 1))
    return frame


def test_bsdf_calls_keep_their_bits_with_negative_ids(monkeypatch):
    """Every bsdf_sample and bsdf_eval call of a material_comparison render
    (the generic bounce: light and sky NEE, RGL beside seven other models),
    called again with the rows' ids clamped into the stack: the same bits
    on every lane of every output."""
    scene, render = _material_comparison()
    calls = []
    for mod, name in ((integrator, "bsdf_sample"), (wavefront, "bsdf_eval")):
        fn = getattr(mod, name)

        def watch(*args, fn=fn, **kw):
            calls.append((fn, args, kw))
            return fn(*args, **kw)

        monkeypatch.setattr(mod, name, watch)
    render()
    monkeypatch.undo()
    mixed = set()
    for fn, args, kw in calls:
        k = next(i for i, a in enumerate(args) if hasattr(a, "rgl_id"))
        mrow = args[k]
        rgl_lanes = mrow.typ == MaterialType.RGL
        assert bool((mrow.rgl_id[rgl_lanes] >= 0).all())
        if bool(rgl_lanes.any()) and bool((mrow.rgl_id < 0).any()):
            mixed.add(fn.__name__)
        old = list(args)
        old[k] = mrow._replace(rgl_id=torch.clamp(mrow.rgl_id, 0, scene.rgl.count - 1))
        for a, b in zip(fn(*args, **kw), fn(*old, **kw)):
            assert _same_bits(a, b), fn.__name__
    assert mixed == {"bsdf_sample", "bsdf_eval"}, mixed


def test_frame_keeps_its_bits_with_negative_ids(monkeypatch):
    _, render = _material_comparison()
    img, stats = render()
    monkeypatch.setattr(rgl, "_lane_frame", _clamped_lane_frame(rgl._lane_frame))
    img0, stats0 = render()
    assert stats.tolist() == stats0.tolist()
    assert kc.frame_digest(img, stats) == kc.frame_digest(img0, stats0)


@pytest.mark.parametrize("full", [False, True], ids=["tail", "full"])
@pytest.mark.parametrize("sample", [False, True], ids=["eval", "sample"])
def test_gradients_of_a_mixed_batch(sample, full):
    """d(sum of cotangent x output)/d(tables) (tail: rgb, ndf, sigma; full:
    every float table and wi) on mixed ids, a cotangent on every lane,
    against the same lanes at id 0 with the others' cotangents zeroed;
    finite everywhere."""
    t = _tables()
    mid, wi, wo, u2 = _lanes(n=1024)
    mid = torch.clamp_max(mid, 1)
    rs = np.random.default_rng(3)
    g = {k: torch.as_tensor(rs.standard_normal(s).astype(np.float32))
         for k, s in (("f", (1024, 4)), ("pdf", (1024,)), ("wo", (1024, 3)))}
    off = mid < 0

    def grads(ids, cot):
        names = rgl.GRAD_TABLES if full else rgl.TAIL_TABLES
        leaves = {k: getattr(t, k).clone().requires_grad_() for k in names}
        tt = t._replace(**leaves)
        w = wi.clone().requires_grad_(full)
        outs = (rgl.rgl_sample(tt, ids, w, u2) if sample else rgl.rgl_eval(tt, ids, w, wo))
        if sample:
            wo_s, f, p, _ = outs
            loss = (f * cot["f"]).sum()
            if full:
                loss = loss + (p * cot["pdf"]).sum() + (wo_s * cot["wo"]).sum()
        else:
            f, p = outs
            loss = (f * cot["f"]).sum() + ((p * cot["pdf"]).sum() if full else 0.0)
        inputs = list(leaves.values()) + ([w] if full else [])
        return dict(zip(list(leaves) + (["wi"] if full else []),
                        torch.autograd.grad(loss, inputs, allow_unused=True)))

    zeroed = {k: torch.where(off.reshape(-1, *([1] * (v.dim() - 1))), 0.0, v)
              for k, v in g.items()}
    got, ref = grads(mid, g), grads(torch.clamp_min(mid, 0), zeroed)
    for k, v in got.items():
        assert v is not None and bool(torch.isfinite(v).all()), k
        torch.testing.assert_close(v, ref[k], rtol=1e-6, atol=1e-7, msg=k)
        if k == "wi":
            assert bool((v[off] == 0).all())
    assert bool((got["rgb"] != 0).any())
