"""K3's K4 form (``render/intersect.py`` `assemble_hit_k4`,
``csrc/assemble_hit.cu`` wpt_assemble_hit_k4): the hit record of one K4
shade class (`K4_FIELDS`: diffuse, env, lit), on hit lanes only.

* Its device code, and the full form's, compiled with g++ through
  ``tests/cuda_host`` and run on the CPU on `kernel_check.k3_edge_sets`, for
  each field set, with and without animation rows: its outputs filled with
  NaN (and sentinels for the integer and bool fields) first, every field of
  the set within the host build's margins of `assemble_hit_plain` on hit
  lanes (those of tests/test_torch_sweep.py: integers equal, vectors atol
  1e-6, for PyTorch's CPU sqrt is not correctly rounded on ~0.6 % of
  inputs), every miss lane still as filled.
* The contract it rests on: the plain diffuse, env and lit shades, given a
  record whose miss lanes and whose fields outside the class's set are NaN
  (miss lanes' materials and backside flags random), give the state, the
  shadow rows that cast and the deposits of the full record, bit for bit.
* Its fields on hit lanes against the JAX package's `assemble_hit`, static
  (the Cornell box with a sphere, as tests/test_torch_intersect.py) and
  animated (the animated box with spheres, as tests/test_torch_sweep.py).
* The K4 step's route through it and the wrapper's refusals. The kernel
  against its plain version on the card: tests/test_torch_kernels.py
  (marked `cuda`; that file imports no jax).
"""

import ctypes
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax_frame_reference as jfr  # noqa: E402
from wurblpt_tpu.render import intersect as JI  # noqa: E402
from wurblpt_tpu.scene.animation import make_anim_ctx as jmake_anim_ctx  # noqa: E402
from wurblpt_tpu.utils import scenes as jscenes  # noqa: E402
from wurblpt_tpu_torch import native, scene_from_numpy  # noqa: E402
from wurblpt_tpu_torch.native import SRC_DIR  # noqa: E402
from wurblpt_tpu_torch.render import integrator, intersect, intersect_brute  # noqa: E402
from wurblpt_tpu_torch.render import intersect_sweep as sw  # noqa: E402
from wurblpt_tpu_torch.utils import kernel_check as kc  # noqa: E402
from wurblpt_tpu_torch.utils import scenes  # noqa: E402

torch.set_num_threads(2)

HOST = Path(__file__).parent / "cuda_host"
FIELDS = intersect.K4_FIELDS
VECTORS = ("position", "normal", "geom_normal", "tangent", "uv")
# csrc/assemble_hit.cu's field bits: a set the entry point refuses
BITS = {"position": 1, "normal": 2, "geom_normal": 4, "tangent": 8, "uv": 16, "mat": 32,
        "backside": 64}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """assemble_hit.cu's device code (both forms) built with g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("k3")
    src = (SRC_DIR / "assemble_hit.cu").read_text()
    (out / "assemble_hit_device.cuh").write_text(src[:src.index('extern "C"')])
    lib = out / "libk3.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", "-DK3A", f"-I{out}", f"-I{HOST}", f"-I{SRC_DIR}", "-o", str(lib),
                    str(HOST / "sweep.cpp")], check=True)
    k3 = ctypes.CDLL(str(lib))
    k3.host_assemble_hit_anim.argtypes = native._SIGNATURES["wpt_assemble_hit_anim"][:-1]
    k3.host_assemble_hit_k4.argtypes = native._SIGNATURES["wpt_assemble_hit_k4"][:-1]
    k3.host_assemble_hit_k4.restype = ctypes.c_int
    return k3


@functools.lru_cache(maxsize=1)
def _edge_sets():
    return kc.k3_edge_sets("cpu")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _filled(fields, n):
    """The K4 form's buffers for `fields`, filled as kernel_check fills them."""
    out = intersect.hit_buffers(fields, n, "cpu")
    for f in fields:
        x = getattr(out, f)
        if f == "mat":
            x.fill_(kc.K4_FILL_MAT)
        elif f == "backside":
            x.view(torch.uint8).fill_(kc.K4_FILL_BACKSIDE)
        else:
            x.fill_(float("nan"))
    return out


def _table_ptrs(ht, args, n):
    return (*(x.data_ptr() for x in args), n, ht.tri_f.data_ptr(), ht.tri_i.data_ptr(),
            ht.n_tris, ht.sph_f.data_ptr(), ht.sph_mat.data_ptr(), ht.n_spheres,
            ht.tri_anim.data_ptr(), ht.sph_anim.data_ptr())


def _held(got, ref, hit, f, label):
    """Field f of the host build against the plain version's on hit lanes."""
    if f in VECTORS:
        torch.testing.assert_close(got[hit], ref[hit], rtol=1e-6, atol=1e-6,
                                   msg=f"{label}: {f}")
    else:
        assert torch.equal(got[hit], ref[hit]), f"{label}: {f}"


@pytest.mark.parametrize("animated", [False, True])
@pytest.mark.parametrize("cls", sorted(FIELDS))
def test_k4_form_on_the_host_matches_the_plain_version(host, cls, animated):
    fields = FIELDS[cls]
    for label, (ht, args, frames) in _edge_sets().items():
        fr = frames if animated else None
        n = args[0].shape[0]
        out = _filled(fields, n)
        code = host.host_assemble_hit_k4(
            *_table_ptrs(ht, args, n), _ptr(fr), sum(BITS[f] for f in fields),
            *(_ptr(getattr(out, f)) for f in ("position", "normal", "geom_normal", "tangent",
                                              "mat", "backside")))
        assert code == 0
        ref = intersect.assemble_hit_plain(ht, *args, fr)
        hit = args[3] >= 0
        for f in fields:
            got = getattr(out, f)
            _held(got, getattr(ref, f), hit, f, label)
            if f == "mat":
                assert bool((got[~hit] == kc.K4_FILL_MAT).all()), f"{label}: {f}"
            elif f == "backside":
                assert bool((got.view(torch.uint8)[~hit] == kc.K4_FILL_BACKSIDE).all()), label
            else:
                assert bool(torch.isnan(got[~hit]).all()), f"{label}: {f} on a miss lane"


@pytest.mark.parametrize("animated", [False, True])
def test_full_form_on_the_host_matches_the_plain_version_on_the_edge_sets(host, animated):
    """The full form (every field of every lane) shares the K4 form's lane
    function: on hit lanes within the margins, on miss lanes the plain
    version's placeholders (mat 0, backside false)."""
    for label, (ht, args, frames) in _edge_sets().items():
        fr = frames if animated else None
        n = args[0].shape[0]
        out = [torch.full((n, 3), float("nan")) for _ in range(4)] + [
            torch.full((n, 2), float("nan")), torch.full((n,), 7, dtype=torch.int32),
            torch.ones(n, dtype=torch.bool)]
        host.host_assemble_hit_anim(*_table_ptrs(ht, args, n), _ptr(fr), 0,
                                    *(x.data_ptr() for x in out))
        ref = intersect.assemble_hit_plain(ht, *args, fr)
        hit = args[3] >= 0
        for f, got in zip(VECTORS, out[:5]):
            _held(got, getattr(ref, f), hit, f, label)
        assert torch.equal(out[5], ref.mat) and torch.equal(out[6], ref.backside), label


def test_the_host_entry_refuses_other_field_sets(host):
    ht, args, _ = _edge_sets()["every lane hit"]
    n = args[0].shape[0]
    out = _filled(FIELDS["lit"], n)
    for bits in (127, 1, BITS["position"] | BITS["normal"]):   # uv among them; subsets
        code = host.host_assemble_hit_k4(
            *_table_ptrs(ht, args, n), None, bits,
            *(_ptr(getattr(out, f)) for f in ("position", "normal", "geom_normal", "tangent",
                                              "mat", "backside")))
        assert code == 1
    assert bool(torch.isnan(out.position).all())


def test_k3_edge_sets_reach_the_edges_they_name():
    sets = _edge_sets()
    hits = {k: int((a[3] >= 0).sum()) for k, (_, a, _) in sets.items()}
    assert hits["no hit lane"] == 0 and hits["one hit lane"] == 1
    assert hits["every lane hit"] == sets["every lane hit"][1][0].shape[0]
    ht, args, frames = sets["triangles and spheres interleaved"]
    sph = (args[3] >= ht.n_tris).numpy()
    assert (sph[1::2]).all() and not (sph[0::2]).any()
    ht, args, frames = sets["degenerate tangents, sphere poles"]
    prim = args[3]
    for fr in (None, frames):
        ref = intersect.assemble_hit_plain(ht, *args, fr)
        pole = prim == ht.n_tris
        assert int(pole.sum()) > 100
        assert torch.equal(ref.normal[pole].abs(), torch.tensor([0.0, 1.0, 0.0]).expand(
            int(pole.sum()), 3))
        assert torch.equal(ref.tangent[pole], torch.tensor([1.0, 0.0, 0.0]).expand(
            int(pole.sum()), 3))
    # the ONB fallback: a row without the tangent flag, a row of zero tangents
    assert int((ht.tri_i[3, 1] & 2)) == 0 and int((ht.tri_i[5, 1] & 2)) == 2
    assert bool((ht.tri_f[5, 15:24] == 0).all())
    assert int((prim == 3).sum()) > 50 and int((prim == 5).sum()) > 50
    ht, args, _ = sets["backside hits"]
    assert bool(intersect.assemble_hit_plain(ht, *args).backside.all())
    ht, args, _ = sets["animations side by side"]
    p = args[3].long()
    aid = torch.where(p < ht.n_tris, ht.tri_anim[p.clamp(max=ht.n_tris - 1)],
                      ht.sph_anim[(p - ht.n_tris).clamp(min=0)])
    assert bool((aid[1:] != aid[:-1]).all()) and ht.n_anims > 2
    n = sets["1111 lanes"][1][0].shape[0]
    assert n == 1111 and n % 32 and 0 < hits["1111 lanes"] < n


def _nan_record(hr, fields, prim, n_mat, seed=0):
    """`hr` with NaN on every miss lane of the set's float fields and in
    every float field outside the set; miss lanes' materials and backside
    flags random."""
    miss = prim < 0
    g = torch.Generator().manual_seed(seed)
    rep = {}
    for f in ("position", "normal", "geom_normal", "tangent", "uv", "mat", "backside"):
        x = getattr(hr, f).clone()
        if f not in fields:
            x.fill_(float("nan"))
        elif x.dtype.is_floating_point:
            x[miss] = float("nan")
        elif x.dtype == torch.bool:
            x[miss] = torch.randint(0, 2, (int(miss.sum()),), generator=g).bool()
        else:
            x[miss] = torch.randint(0, n_mat, (int(miss.sum()),), generator=g).to(x.dtype)
        rep[f] = x
    return hr._replace(hit=None, **rep)


def _bits_equal(a, b):
    if a.dtype.is_floating_point:
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


SHADE_CASES = {
    "cornell": lambda: kc.k4_inputs("cpu", "cornell", width=16, ssqrt=2, m=2),
    "cornell_animated": lambda: kc.k4_inputs("cpu", "cornell_animated", width=8, ssqrt=2, m=2),
    "envmap": lambda: kc.k4_inputs("cpu", "envmap", width=16, ssqrt=2, m=2),
    "mesh": lambda: kc.k4_inputs("cpu", "mesh", width=16, height=12, ssqrt=2, m=2,
                                 scene=scenes.terrain_city(seed=3, terrain_res=8, n_buildings=2,
                                                           sphere_slices=4, device="cpu")),
    "city": lambda: kc.k4_inputs("cpu", "city", width=48, height=24, ssqrt=1, m=1,
                                 scene=scenes.city_night(seed=7, terrain_res=24, n_buildings=12,
                                                         n_windows=12, sphere_slices=6,
                                                         device="cpu")),
}


@pytest.mark.parametrize("frame", sorted(SHADE_CASES))
def test_plain_shades_read_no_field_outside_their_set_and_no_miss_lane(frame):
    inp = SHADE_CASES[frame]()
    route = kc.k4_route(inp)
    assert inp.assemble[3] == route.hit_fields
    args = list(inp.shade)
    prim, hr = args[7], args[8]
    assert 0 < int((prim < 0).sum()) < prim.shape[0]
    ref = route.shade_plain(*kc.fresh_args(args))
    nanned = list(kc.fresh_args(args))
    nanned[8] = _nan_record(hr, route.hit_fields, prim, args[0].mat.shape[0])
    got = route.shade_plain(*nanned)
    st, ref_st = got[0], ref[0]
    for f in st._fields:
        assert _bits_equal(getattr(st, f), getattr(ref_st, f)), f
    if ref[3] is None:
        assert got[1:] == (None,) * 4 or all(x is None for x in got[2:])
        return
    cast = ref[3] > 0
    assert bool(cast.any()) and torch.equal(got[3], ref[3])
    for i in (1, 2):   # the shadow rows that cast; K2, KS2 and K6 read no other
        assert _bits_equal(got[i][cast], ref[i][cast]), i
    assert _bits_equal(got[4], ref[4])


def _jax_case(which):
    """(port scene, winners (o, d, t, prim, u, v), frames, the JAX package's
    assemble_hit on the same winners, atol): the Cornell box with a sphere
    (static: the port's brute-force cast of random rays inside the box), or the
    animated box with spheres at t = 0.37 (the port's plain sweep of camera
    rays); the JAX calls jitted."""
    if which == "static":
        js = jscenes.cornell_box(short_object="sphere").build()
        scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
        rays = kc.random_lanes(2048, "cpu", seed=4, lo=(-0.9, -0.9, -0.9), hi=(0.9, 0.9, 0.9))
        winners = intersect_brute.closest_hit_plain(intersect_brute.build_brute_scene(scene),
                                                    *rays)
        frames, atol = None, 1e-5
        jhr = jax.jit(lambda *a: JI.assemble_hit(js, *a))(
            *(jnp.asarray(x.numpy()) for x in (*rays[:2], *winners)))
    else:
        js = jfr.jax_cornell_animated(spheres=True)
        scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
        frames, atol = kc.frames_at(scene, 0.37), 1e-4
        rays = kc.camera_lanes(32, 32, 2, "cpu")
        winners = sw.closest_sweep_plain(sw.build_sweep_scene(scene), *rays, frames)
        times = jnp.full((rays[0].shape[0],), jnp.float32(0.37))
        jhr = jax.jit(lambda *a: JI.assemble_hit(
            js, *a[:6], anim_ctx=jmake_anim_ctx(js.anims, a[6])))(
            *(jnp.asarray(x.numpy()) for x in (*rays[:2], *winners)), times)
    return scene, [*rays[:2], *winners], frames, jhr, atol


@pytest.mark.parametrize("which", ["static", "animated"])
def test_k4_form_matches_jax_assemble_hit_on_hit_lanes(which):
    """On the Cornell box with a sphere and on the animated box with
    spheres: the fields of each set on hit lanes within the tolerances of
    tests/test_torch_intersect.py (static, atol 1e-5) and
    tests/test_torch_sweep.py (animated, atol 1e-4: XLA's FMAs), integers
    equal."""
    scene, args, frames, jhr, atol = _jax_case(which)
    ht = intersect.build_hit_tables(scene)
    h = np.asarray(jhr.hit)
    prim = args[3].numpy()
    assert h.sum() > 0.3 * len(h) and (prim[h] >= scene.n_tris).sum() > 10
    np.testing.assert_array_equal(prim >= 0, h)
    for cls, fields in FIELDS.items():
        rec = intersect.assemble_hit_k4(ht, *args, frames,
                                        intersect.hit_buffers(fields, len(h), "cpu"))
        assert rec.hit is None and rec.uv is None
        for f in fields:
            got, want = getattr(rec, f).numpy()[h], np.asarray(getattr(jhr, f))[h]
            if f in VECTORS:
                np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f"{cls} {f}")
            else:
                np.testing.assert_array_equal(got, want, f"{cls} {f}")


def test_k4_step_assembles_the_class_fields_into_buffers_it_keeps():
    """A K4 frame calls the K4 form at every step with its class's field set
    and the same buffers (allocated once per frame), and hands the shade a
    record without a hit mask."""
    calls, saved = [], integrator.assemble_hit_k4

    def record(ht, o, d, t, prim, u, v, frames, out):
        calls.append(tuple(getattr(out, f) for f in intersect.HitRecord._fields))
        rec = saved(ht, o, d, t, prim, u, v, frames, out)
        assert rec.hit is None and rec.uv is None
        return rec

    integrator.assemble_hit_k4 = record
    try:
        img, stats = kc._frame(scenes.cornell_box_ref("cpu"), scenes.cornell_ref_camera("cpu"),
                               8, 8, 2, 3, "cpu")()
    finally:
        integrator.assemble_hit_k4 = saved
    assert len(calls) >= 3 and bool(torch.isfinite(img).all())
    first = calls[0]
    fields = [f for f, x in zip(intersect.HitRecord._fields, first) if x is not None]
    assert tuple(fields) == tuple(f for f in intersect.HitRecord._fields
                                  if f in FIELDS["diffuse"])
    for c in calls[1:]:
        assert all(a is b for a, b in zip(c, first))


def test_k4_form_refuses_what_it_does_not_take():
    ht, args, frames = _edge_sets()["every lane hit"]
    n = args[0].shape[0]
    counts = dict(native.LAUNCHES)
    with pytest.raises(ValueError, match="field set"):
        intersect.hit_buffers(("position", "normal"), n, "cpu")
    lit = intersect.hit_buffers(FIELDS["lit"], n, "cpu")
    with pytest.raises(ValueError, match="field set"):
        intersect.assemble_hit_k4(ht, *args, None, lit._replace(uv=torch.empty(n, 2)))
    with pytest.raises(ValueError, match="out.normal"):
        intersect.assemble_hit_k4(ht, *args, None, lit._replace(normal=torch.empty(n, 4)))
    with pytest.raises(ValueError, match="out.mat"):
        intersect.assemble_hit_k4(ht, *args, None, lit._replace(mat=torch.empty(n)))
    with pytest.raises(ValueError, match="frames"):
        intersect.assemble_hit_k4(ht, *args, frames.double(), lit)
    meta = tuple(x.to("meta") for x in args)
    ht_meta = intersect.HitTables(*(x.to("meta") if isinstance(x, torch.Tensor) else x
                                    for x in ht))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        intersect.assemble_hit_k4(ht_meta, *meta, None,
                                  intersect.hit_buffers(FIELDS["env"], n, "meta"))
    # on CPU tensors the plain version, every lane copied in; nothing launched
    rec = intersect.assemble_hit_k4(ht, *args, frames, lit)
    ref = intersect.assemble_hit_plain(ht, *args, frames)
    for f in FIELDS["lit"]:
        assert torch.equal(getattr(rec, f), getattr(ref, f)) and getattr(rec, f) is getattr(lit, f)
    assert native.LAUNCHES == counts
