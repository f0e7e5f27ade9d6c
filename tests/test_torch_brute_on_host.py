"""K1's and K2's block-local queue (``csrc/closest_hit.cu``,
``csrc/any_hit.cu``, ``csrc/live_queue.cuh``) and P0's index math
(``csrc/row_gather.cu``) compiled with g++ and run on the CPU, held against
their plain versions.

The kernels cannot run here, but their control flow can: ``tests/cuda_host``
stands in for the CUDA intrinsics (one std::thread per CUDA thread, the warp
votes through a barrier per warp, ``__syncthreads`` through one per block),
so K1's tiles, its dead lanes written at once, the ``__ballot_sync`` /
``__popc`` queue of live lanes, the table staged whole in shared memory (or
in chunks past 128 KB) and the blocks looping over tiles run as written,
with the tiles and grid the C entry point picks (2 resident blocks here:
2500 lanes make 5 tiles of 512, 1013 two) and up to 8 threads casting one
live ray, each a share of the table, then agreeing on the first minimum
through warp shuffles. P0's vector
loop, its multiply-high divider and its tail run over 2 blocks of its
grid-stride loop, and again built with 4096 words per launch, so that a
gather takes several launches. K2 runs the same queue; its split threads
walk in rounds and stop together at a ray's first blocker (a ballot per
round), and a pair's u_num and v_num are computed only where its plane hit
lies in (t_min, t_max).

K1: lanes dead at random (t_max 0, equal to t_min or NaN) at shares of 0,
50, 90 and 100 % (1, 2 and 8 threads per live ray), lane counts that are
multiples neither of 32 nor of the tile, fewer lanes than a warp, coplanar faces that tie, a 900-triangle table
(58 KB, above the 48 KB a block gets without asking) and a 2100-triangle one
(134 KB: the chunked walk), and a sphere-only scene. Prim ids are equal, and
t, u, v equal bit for bit where a triangle wins or the lane misses; where a
sphere wins, t is within rtol 1e-6 (PyTorch's CPU sqrt is not correctly
rounded on ~0.6 % of inputs here, the host's sqrtf is; tests/test_torch_sweep.py).
K2: the same dead shares, one live lane in a block, blockers that are the
table's last triangle or last sphere, the tests' edges (rays aimed at
triangle edges and corners, grazing rays with |det| about 1e-12, t_max at
the hit's distance or a float either side: `kernel_check.edge_lanes`), and
the 58 KB and 134 KB tables; equal on every lane where the scene has no
sphere, and where it has, outside check_any_hit's margin (a first hit
within 1e-5 of t_max: the host's sqrtf and PyTorch's CPU sqrt part there).
P0: 1, 3, 23 and 128 columns, indices outside the table, NaN bit patterns:
equal word for word."""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from wurblpt_tpu_torch import native
from wurblpt_tpu_torch.native import SRC_DIR
from wurblpt_tpu_torch.render import intersect_brute as ib
from wurblpt_tpu_torch.render.gather import row_gather_plain
from wurblpt_tpu_torch.scene.ir import Spheres
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

HOST = Path(__file__).parent / "cuda_host"
DYNAMIC = "extern __shared__ float4 s_prim[];"
MAX_WORDS = "constexpr int MAX_WORDS = 0x7ffffff0;"


def _device_source(out, name, *subs):
    src = (SRC_DIR / f"{name}.cu").read_text()
    for old, new in subs:
        assert old in src
        src = src.replace(old, new)
    (out / f"{name}_device.cuh").write_text(src[:src.index('extern "C"')])


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """{"k1": K1, "k2": K2, "p0": P0, "p0 short": P0 at 4096 words per
    launch}, built with g++ (tests/cuda_host/brute.cpp)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    libs = {}
    for key, flags, subs in (
            ("k1", [], [("closest_hit", (DYNAMIC, "static float4 s_prim[131072 / 16];"))]),
            ("k2", ["-DK2"], [("any_hit", (DYNAMIC, "static float4 s_prim[131072 / 16];"))]),
            ("p0", ["-DP0"], [("row_gather",)]),
            ("p0 short", ["-DP0"],
             [("row_gather", (MAX_WORDS, "constexpr int MAX_WORDS = 4096;"))])):
        out = tmp_path_factory.mktemp(key.replace(" ", "_"))
        for name, *sub in subs:
            _device_source(out, name, *sub)
        lib = out / "libbrute.so"
        subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                        "-pthread", *flags, f"-I{out}", f"-I{HOST}", f"-I{SRC_DIR}", "-o",
                        str(lib), str(HOST / "brute.cpp")], check=True)
        libs[key] = ctypes.CDLL(str(lib))
    sig = native._SIGNATURES
    libs["k1"].host_closest_hit.argtypes = sig["wpt_closest_hit"][:-1]
    libs["k2"].host_any_hit.argtypes = sig["wpt_any_hit"][:-1]
    for key in ("p0", "p0 short"):
        libs[key].host_row_gather.argtypes = sig["wpt_row_gather"][:-1]
    return libs


def _cornell(sphere=True):
    scene = scenes.cornell_box_ref("cpu")
    if sphere:
        scene = scene._replace(spheres=Spheres(torch.tensor([[0.3, 0.35, 0.4]]),
                                               torch.tensor([0.3]),
                                               torch.tensor([0], dtype=torch.int32)))
    return scene


def _ties(n=64):
    """Rays straight down onto the floor under the short box, whose bottom
    face lies in the floor's plane (prims 4, 5 and 14, 15)."""
    rs = np.random.default_rng(5)
    o = torch.as_tensor(np.c_[rs.uniform(0.2, 0.4, n), np.full(n, 0.5), rs.uniform(0.25, 0.45, n)],
                        dtype=torch.float32)
    d = torch.tensor([[0.0, -1.0, 0.0]]).expand(n, 3).contiguous()
    return o, d, torch.full((n,), 1e-4), torch.full((n,), ib.BIG)


def _case(case):
    """(scene, rays, whether the table is staged whole)."""
    if case.startswith("dead"):
        share = int(case.split()[1]) / 100
        return _cornell(), kc.scatter_dead(kc.random_lanes(2500, "cpu"), share, 7), True
    if case == "fewer lanes than a warp":
        return _cornell(), kc.scatter_dead(kc.camera_lanes(5, 4, 1, "cpu"), 0.5, 8), True
    if case == "ties":
        return _cornell(False), _ties(), True
    if case == "spheres only":
        rays = kc.random_lanes(1013, "cpu", lo=(-6.0, 0.0, -6.0), hi=(6.0, 2.5, 6.0))
        return scenes.rtiow(device="cpu"), kc.scatter_dead(rays, 0.5, 9), True
    n_tris, w, h = {"58 KB table": (900, 33, 31), "134 KB table, chunked": (2100, 20, 15)}[case]
    rays = kc.camera_lanes(w, h, 1, "cpu", camera=scenes.field_camera("cpu"))
    return (scenes.tri_sphere_field(n_tris=n_tris, n_spheres=40, device="cpu"),
            kc.scatter_dead(rays, 0.5, 10), n_tris == 900)


@pytest.mark.parametrize("case", ["dead 0", "dead 50", "dead 90", "dead 100",
                                  "fewer lanes than a warp", "ties", "spheres only",
                                  "58 KB table", "134 KB table, chunked"])
def test_k1_queue_on_the_host_matches_the_plain_version(host, case):
    scene, rays, whole = _case(case)
    bs = ib.build_brute_scene(scene)
    n = rays[0].shape[0]
    t, u, v = (torch.full((n,), -7.0) for _ in range(3))
    prim = torch.full((n,), -7, dtype=torch.int32)
    staged = host["k1"].host_closest_hit(
        *(x.data_ptr() for x in rays), n, bs.tri.data_ptr(), bs.n_tris, bs.sph.data_ptr(),
        bs.n_spheres, *bs.center, t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr())
    assert bool(staged) == whole
    pt, pp, pu, pv = ib.closest_hit_plain(bs, *rays)
    assert torch.equal(prim, pp)
    tri = pp < bs.n_tris                   # a triangle or a miss: bit for bit
    for a, b in ((t, pt), (u, pu), (v, pv)):
        assert torch.equal(a[tri], b[tri])
    torch.testing.assert_close(t[~tri], pt[~tri], rtol=1e-6, atol=0)
    assert torch.equal(u[~tri], pu[~tri]) and torch.equal(v[~tri], pv[~tri])
    o, d, t_min, t_max = rays
    dead = ~(t_max > t_min)
    assert (prim[dead] == -1).all() and (t[dead] == np.float32(ib.BIG)).all()
    assert (u[dead] == 0).all() and (v[dead] == 0).all()
    if case == "ties":
        c = ib.candidate_t(bs, *rays)
        assert (c == c.min(1, keepdim=True).values).sum(1).min() >= 2   # every lane ties
        assert ((pp == 4) | (pp == 5)).all()
    elif not case.endswith("100"):
        live = ~dead
        assert (pp[live] >= 0).sum() > 0.1 * int(live.sum())


@functools.lru_cache(maxsize=1)
def _k2_edge_sets():
    return kc.k2_edge_sets("cpu", 700)


def _k2_case(case):
    """(BruteScene, shadow rays, whether the table is staged whole)."""
    if case in ("one live lane", "blocker last, triangle", "blocker last, sphere", "edges"):
        return (*_k2_edge_sets()[case], True)
    if case.startswith("dead"):
        share = int(case.split()[1]) / 100
        rays = kc.scatter_dead(kc.random_lanes(2500, "cpu"), share, 7)
        return ib.build_brute_scene(_cornell()), rays, True
    if case == "fewer lanes than a warp":
        rays = kc.scatter_dead(kc.random_lanes(20, "cpu", seed=4), 0.5, 8)
        return ib.build_brute_scene(_cornell()), rays, True
    if case == "spheres only":
        rays = kc.random_lanes(1013, "cpu", lo=(-6.0, 0.0, -6.0), hi=(6.0, 2.5, 6.0))
        bs = ib.build_brute_scene(scenes.rtiow(device="cpu"))
        return bs, kc.scatter_dead(rays, 0.5, 9), True
    if case == "5 primitives, a thread per lane":   # the envmap frame's table
        scene = scenes.envmap_spheres(cube=True, device="cpu")
        bs = ib.build_brute_scene(scene)
        rays = kc.env_shadow_lanes(scene, kc.random_lanes(1013, "cpu", seed=5), bs)
        return bs, kc.scatter_dead(rays, 0.3, 9), 2
    n_tris, w, h = {"58 KB table": (900, 33, 31), "134 KB table, chunked": (2100, 20, 15)}[case]
    bs = ib.build_brute_scene(scenes.tri_sphere_field(n_tris=n_tris, n_spheres=40, device="cpu"))
    rays = kc.camera_lanes(w, h, 1, "cpu", camera=scenes.field_camera("cpu"))
    shadow = kc.sky_shadow_lanes(lambda *r: ib.closest_hit_plain(bs, *r), rays)
    return bs, kc.scatter_dead(shadow, 0.5, 10), n_tris == 900


@pytest.mark.parametrize("case", ["dead 0", "dead 50", "dead 90", "dead 100", "one live lane",
                                  "fewer lanes than a warp", "blocker last, triangle",
                                  "blocker last, sphere", "spheres only", "edges",
                                  "5 primitives, a thread per lane", "58 KB table",
                                  "134 KB table, chunked"])
def test_k2_queue_on_the_host_matches_the_plain_version(host, case):
    bs, rays, whole = _k2_case(case)
    n = rays[0].shape[0]
    occ = torch.ones((n,), dtype=torch.bool)
    staged = host["k2"].host_any_hit(*(x.data_ptr() for x in rays), n, bs.tri.data_ptr(),
                                     bs.n_tris, bs.sph.data_ptr(), bs.n_spheres, *bs.center,
                                     occ.data_ptr())
    assert staged == whole
    pocc = ib.any_hit_plain(bs, *rays)
    o, d, t_min, t_max = rays
    near = ib.candidate_t(bs, o, d, t_min, torch.full_like(t_max, ib.BIG)).min(1).values
    margin = ((near - t_max).abs() <= 1e-5 * t_max) & (near < ib.BIG)
    differ = occ != pocc
    assert not bool((differ & ~margin).any()), int(differ.sum())
    if bs.n_spheres == 0:
        assert not bool(differ.any())
    dead = ~(t_max > t_min)
    assert not bool(occ[dead].any())
    if case == "one live lane":
        assert int((~dead).sum()) == 1
    elif case.startswith("blocker last"):
        valid = torch.cat([ib._tri_terms(bs, *rays)[0], ib._sphere_terms(bs, *rays)[0]], 1)
        last = valid[:, bs.n_tris - 1] if bs.n_spheres == 0 else valid[:, -1]
        assert bool(last.all()) and int((valid.sum(1) == 1).sum()) > n // 2
        assert bool(pocc.all())
    elif case == "edges":
        _, det, _, _, _ = ib._tri_terms(bs, *rays)
        grazing = (det.abs() > 0.5e-12) & (det.abs() < 4e-12)
        assert int((grazing & (det.abs() > 1e-12)).sum()) > 0
        assert int((grazing & (det.abs() <= 1e-12)).sum()) > 0
    if case not in ("dead 100", "one live lane") and not case.startswith("blocker last"):
        assert 0 < int(pocc.sum()) < int((~dead).sum())


@pytest.mark.parametrize("build", ["p0", "p0 short"])
@pytest.mark.parametrize("cols", [1, 3, 23, 128])
def test_p0_index_math_on_the_host_matches_the_plain_version(host, build, cols):
    table, idx = kc.gather_words(cols, "cpu", seed=cols)
    n = idx.shape[0]
    out = torch.full((n, cols), -7, dtype=torch.int32)
    assert host[build].host_row_gather(table.data_ptr(), table.shape[0], cols, idx.data_ptr(),
                                       n, out.data_ptr()) == 0
    assert torch.equal(out, row_gather_plain(table, idx).view(torch.int32))
    assert ((idx < 0) | (idx >= table.shape[0])).any()


def test_p0_on_the_host_takes_the_probe_shapes(host):
    for table, idx in kc.probe_gather_inputs("cpu"):
        n, cols = idx.shape[0], table.shape[1]
        out = torch.empty((n, cols), dtype=torch.float32)
        host["p0"].host_row_gather(table.data_ptr(), table.shape[0], cols, idx.data_ptr(), n,
                                   out.data_ptr())
        assert torch.equal(out.view(torch.int32), row_gather_plain(table, idx).view(torch.int32))
