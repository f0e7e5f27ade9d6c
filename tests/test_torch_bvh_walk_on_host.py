"""The walk of K5/K6 (``csrc/bvh_common.cuh``) compiled with g++ and run on
the CPU, held bit for bit against the plain walk of ``accel/traverse.py``.

The kernels cannot run here, but their control flow can: ``tests/cuda_host``
stands in for the CUDA intrinsics the walk uses (one std::thread per CUDA
thread, the warp votes and shuffles through a barrier per warp), so the
persistent fetch of lanes (each warp's own chunk of 32, then chunks from a
counter past one wave; a launch of one wave has its counter poisoned), the
queue of live lanes, the while-while walk and its stack run as written,
two resident blocks sharing one lane counter. Both branches run: the L2
walk with its stack in static shared memory and spill rows (also built
with 2 shared stack entries in place of 16, so that every walk deeper than
2 spills), and the staged walk, which copies the tree into the block's
dynamic shared memory (a static array here) and keeps its whole stack
there, with the object-ray cache of the animated walks. Rays over the
small terrain_city (2594 triangles): the mesh frame's camera, random rays
from above and below the ground, axis-aligned rays, rays with half the
lanes dead, a count that is not a multiple of 32, and every lane dead.

The sphere rows and the object-space slots run in the same build, each
instantiation picked by its variant as the kernels' entry points pick it:
the RTIOW field at n = 8 with a BVH (68 spheres: sphere rows, world rays)
and the animated Cornell box with its two spheres and a BVH swept at
t = 0.5 (triangle and sphere rows, static and animated, with the frame's
animation rows; also with those rows' object-space walk over the static
terrain, every row of animation 0), and `kernel_check.bvh_leaf_edge_sets`
at a small size. On the triangle walks the prim ids, t, u and v are equal
bit for bit; where a sphere row is tested, prim ids and the occlusion bit
are equal and t within rtol 1e-6 (PyTorch's CPU sqrt is not correctly
rounded on ~0.6 % of inputs here, the host's sqrtf is;
tests/test_torch_sweep.py)."""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from wurblpt_tpu_torch.accel import traverse
from wurblpt_tpu_torch.native import SRC_DIR
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

HOST = Path(__file__).parent / "cuda_host"
GRID = 2
BLOCK = 128
SMEM_DECL = "extern __shared__ float4 wpt_bvh_smem[];"
SMEM_HOST = 1 << 16     # float4s of the host build's stand-in for the dynamic shared memory


@pytest.fixture(scope="module")
def walks(tmp_path_factory):
    """{shared stack entries: the walk built with them, as a ctypes library}."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    src = (SRC_DIR / "bvh_common.cuh").read_text()
    shared = f"constexpr int SHORT = {traverse.SHARED_STACK};"
    assert shared in src          # the wrapper sizes the spill rows from SHARED_STACK
    libs = {}
    assert SMEM_DECL in src
    src = src.replace(SMEM_DECL, f"__shared__ float4 wpt_bvh_smem[{SMEM_HOST}];")
    for short in (traverse.SHARED_STACK, 2):
        out = tmp_path_factory.mktemp(f"short{short}")
        (out / "bvh_common.cuh").write_text(
            src.replace(shared, f"constexpr int SHORT = {short};"))
        lib = out / "libwalk.so"
        subprocess.run([cxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                        "-pthread", f"-I{out}", f"-I{HOST}", f"-I{SRC_DIR}", "-o", str(lib),
                        str(HOST / "walk.cpp")], check=True)
        libs[short] = ctypes.CDLL(str(lib))
    return libs


@functools.lru_cache(maxsize=None)
def _scene(name="terrain"):
    if name == "rtiow":
        return scenes.rtiow(n=8, device="cpu", use_bvh=True)
    if name == "animated":
        return scenes.cornell_box_animated("cpu", spheres=True, use_bvh=True)
    return scenes.terrain_city(seed=3, terrain_res=24, n_buildings=8, sphere_slices=6,
                               device="cpu")


def _rays(kind, name="terrain"):
    if name != "terrain":
        camera = scenes.rtiow_camera("cpu") if name == "rtiow" else None
        if kind == "camera":
            return kc.camera_lanes(32, 32, 1, "cpu", camera=camera)
        lo, hi = ((-6.0, 0.0, -6.0), (6.0, 2.5, 6.0)) if name == "rtiow" else ((-1.2,) * 3,
                                                                              (1.2, 2.2, 3.5))
        o, d, t_min, t_max = kc.random_lanes(1024, "cpu", seed=3, lo=lo, hi=hi)
        if kind == "half dead":
            t_max = torch.where(torch.arange(1024) % 3 == 0, 0.0, t_max)
        return o, d, t_min, t_max
    if kind == "camera":
        return kc.camera_lanes(32, 32, 1, "cpu", camera=scenes.terrain_camera("cpu"))
    o, d, t_min, t_max = kc.terrain_random_lanes(1024, "cpu", seed=3)
    if kind == "axis":
        rs = np.random.default_rng(4)
        d = torch.as_tensor(np.eye(3)[rs.integers(0, 3, 1024)] * rs.choice([-1.0, 1.0], (1024, 1)),
                            dtype=torch.float32)
    elif kind == "half dead":
        t_max = torch.where(torch.arange(1024) % 3 == 0, 0.0, t_max)
    elif kind == "every lane dead":
        t_max = torch.zeros_like(t_max)
    elif kind == "ragged":
        o, d, t_min, t_max = (x[:1000 + 13] for x in (o, d, t_min, t_max))
    return o.contiguous(), d.contiguous(), t_min.contiguous(), t_max.contiguous()


def _ptr(x):
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def _host_walks(lib, bvh, rays, short, frames=None, staged=False):
    """(t, prim, u, v, occluded) of the host-built walk, the instantiation
    of this tree and `frames`, on the L2 walk or (`staged`) the staged one."""
    n = rays[0].shape[0]
    if staged:
        assert traverse.layout_bytes(bvh, frames, True) <= SMEM_HOST * 16
    spill = torch.zeros(GRID * BLOCK * max(bvh.depth - short, 1) * 2, dtype=torch.int32)
    args = [traverse.variant(bvh, frames) | (4 if staged else 0), *(_ptr(x) for x in rays), n,
            _ptr(bvh.nodes), bvh.nodes.shape[0], _ptr(bvh.prim_v), bvh.prim_v.shape[0],
            bvh.n_tris, _ptr(frames), bvh.n_anims, bvh.depth, _ptr(spill), GRID]
    t, u, v = (torch.full((n,), -7.0) for _ in range(3))
    prim = torch.full((n,), -7, dtype=torch.int32)
    lib.host_closest_hit(*args, _ptr(t), _ptr(prim), _ptr(u), _ptr(v))
    occ = torch.ones((n,), dtype=torch.bool)
    lib.host_any_hit(*args, _ptr(occ))
    return t, prim, u, v, occ


@pytest.mark.parametrize("short", [traverse.SHARED_STACK, 2])
@pytest.mark.parametrize("kind", ["camera", "random", "axis", "half dead", "ragged",
                                  "every lane dead"])
def test_host_walk_matches_the_plain_walk(walks, kind, short):
    bvh = _scene().bvh
    rays = _rays(kind)
    t, prim, u, v, occ = _host_walks(walks[short], bvh, rays, short)
    ref = traverse.bvh_closest_hit_plain(bvh, *rays)
    for got, want in zip((t, prim, u, v), ref):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(occ, traverse.bvh_any_hit_plain(bvh, *rays))
    live = rays[3] > rays[2]
    assert ((prim >= 0) <= live).all()
    if kind != "every lane dead":
        assert 0 < int((prim >= 0).sum()) and 0 < int(occ.sum()) < int(live.sum())


@pytest.mark.parametrize("short", [traverse.SHARED_STACK, 2])
@pytest.mark.parametrize("scene, frames", [("rtiow", False), ("animated", True),
                                           ("terrain", True)])
@pytest.mark.parametrize("kind", ["camera", "random", "half dead"])
def test_host_walk_of_sphere_rows_and_object_rays_matches_the_plain_walk(walks, scene, frames,
                                                                         kind, short):
    sc = _scene(scene)
    bvh = sc.bvh
    fr = None
    if frames:   # the terrain is static: animation 0's row of the animated box's frame
        fr = kc.frames_at(_scene("animated"))
    rays = _rays(kind, scene)
    t, prim, u, v, occ = _host_walks(walks[short], bvh, rays, short, fr)
    pt, pprim, pu, pv = traverse.bvh_closest_hit_plain(bvh, *rays, fr)
    assert torch.equal(prim, pprim)
    assert torch.equal(occ, traverse.bvh_any_hit_plain(bvh, *rays, fr))
    if scene == "terrain":   # no sphere row: bit for bit
        for got, want in ((t, pt), (u, pu), (v, pv)):
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for got, want in ((t, pt), (u, pu), (v, pv)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    live = rays[3] > rays[2]
    assert ((prim >= 0) <= live).all() and 0 < int((prim >= 0).sum())
    if scene != "terrain":
        assert int((prim >= bvh.n_tris).sum()) > 0          # sphere rows won
    if scene == "animated" and kind == "camera":      # the box fills the view
        assert int((prim >= 0).sum()) > 0.9 * int(live.sum())


def _assert_walks_equal(got, bvh, rays, frames):
    """The host walk's (t, prim, u, v, occ) against the plain walk: prim ids
    and occlusion equal, t, u and v bit for bit on lanes that won no sphere,
    a sphere's t within rtol 1e-6."""
    t, prim, u, v, occ = got
    pt, pprim, pu, pv = traverse.bvh_closest_hit_plain(bvh, *rays, frames)
    assert torch.equal(prim, pprim)
    assert torch.equal(occ, traverse.bvh_any_hit_plain(bvh, *rays, frames))
    tri = pprim < bvh.n_tris
    for got_x, want in ((t, pt), (u, pu), (v, pv)):
        assert torch.equal(got_x[tri].view(torch.int32), want[tri].view(torch.int32))
    torch.testing.assert_close(t, pt, rtol=1e-6, atol=1e-7)
    assert torch.equal(u[~tri], pu[~tri]) and torch.equal(v[~tri], pv[~tri])


@pytest.mark.parametrize("kind", ["camera", "random", "axis", "half dead", "ragged",
                                  "every lane dead"])
def test_staged_host_walk_holds_the_static_walks_bits(walks, kind):
    """The staged branch of the static triangle walk on the small terrain:
    the L2 walk's bits (its rows at 48 bytes, its stack at the tree's depth)."""
    bvh = _scene().bvh
    rays = _rays(kind)
    got = _host_walks(walks[traverse.SHARED_STACK], bvh, rays, traverse.SHARED_STACK,
                      staged=True)
    ref = traverse.bvh_closest_hit_plain(bvh, *rays)
    for x, want in zip(got[:4], ref):
        assert torch.equal(x.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got[4], traverse.bvh_any_hit_plain(bvh, *rays))


@pytest.mark.parametrize("scene, frames", [("rtiow", False), ("animated", True),
                                           ("terrain", True)])
@pytest.mark.parametrize("kind", ["camera", "random", "half dead"])
def test_staged_host_walk_of_sphere_rows_and_object_rays(walks, scene, frames, kind):
    """The staged walk with sphere rows (32-byte rows of a tree without
    triangles) and object-space rays (the frames staged, the object-ray
    cache) against the plain walk."""
    sc = _scene(scene)
    fr = kc.frames_at(_scene("animated")) if frames else None
    rays = _rays(kind, scene)
    got = _host_walks(walks[traverse.SHARED_STACK], sc.bvh, rays, traverse.SHARED_STACK, fr,
                      staged=True)
    _assert_walks_equal(got, sc.bvh, rays, fr)
    assert int((got[1] >= 0).sum()) > 0


@functools.lru_cache(maxsize=None)
def _edge_sets():
    an = _scene("animated")
    return kc.bvh_leaf_edge_sets(
        _scene("rtiow").bvh, an.bvh, kc.frames_at(an), "cpu", waves=(GRID * BLOCK,),
        budget=12288, frames_bytes=lambda b: traverse.layout_bytes(b, None, True), n=384)


EDGE_SETS = ["rtiow grazing the ground sphere", "rtiow from inside spheres", "rtiow tangent rays",
             "animated box aimed at every row", "animated box, animations sharing cache slots",
             "animated box vertices, signed zeros",
             "identity rows at -0, signed zeros",
             "a triangle and a sphere tied", "rtiow, t_max a float beyond the hit",
             "rtiow, t_max at the hit", "animated box, t_max a float beyond the hit",
             "animated box, t_max at the hit", "animated box, one live lane",
             "rtiow, every lane dead", "animated box, 219 lanes (a wave of 256)",
             "animated box, 256 lanes (a wave of 256)", "animated box, 1269 lanes (a wave of 256)",
             "a tree just past the staging budget"]


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("name", EDGE_SETS)
def test_host_walk_holds_the_leaf_edge_sets(walks, name, staged):
    """Every set of kernel_check.bvh_leaf_edge_sets on both branches."""
    sets = _edge_sets()
    assert sorted(sets) == sorted(EDGE_SETS)
    bvh, rays, fr = sets[name]
    got = _host_walks(walks[traverse.SHARED_STACK], bvh, rays, traverse.SHARED_STACK, fr,
                      staged=staged)
    _assert_walks_equal(got, bvh, rays, fr)
    live = rays[3] > rays[2]
    assert ((got[1] >= 0) <= live).all()
    if "dead" not in name and "at the hit" not in name:
        assert int((got[1] >= 0).sum()) > 0
    if name == "a triangle and a sphere tied":   # ties at whole t, won by the walk's order
        tied = (got[1] >= 0) & (got[0] == torch.round(got[0]))
        assert int((got[1][tied] >= bvh.n_tris).sum()) > 0
        assert int((got[1][tied] < bvh.n_tris).sum()) > 0


def test_layout_bytes_mirror_the_kernels(walks):
    """traverse.layout_bytes equals the kernels' Layout on every branch and
    leaf kind, and the walk's plan names the branch by the budget."""
    lib = walks[traverse.SHARED_STACK]
    an = _scene("animated")
    fr = kc.frames_at(an)
    for bvh, frames in ((_scene("rtiow").bvh, None), (an.bvh, fr), (an.bvh, None),
                        (_scene().bvh, None), (_scene().bvh, fr)):
        for staged in (False, True):
            want = lib.host_layout_bytes(int(staged), int(frames is not None),
                                         bvh.nodes.shape[0], bvh.prim_v.shape[0], bvh.n_tris,
                                         bvh.n_anims, bvh.depth)
            assert traverse.layout_bytes(bvh, frames, staged) == want
        need = traverse.layout_bytes(bvh, frames, True)
        var = traverse.variant(bvh, frames)
        assert traverse.walk_plan(bvh, frames, need) == (var | 4, "shared", need)
        assert traverse.walk_plan(bvh, frames, need - 1) == (
            var, "L2", traverse.layout_bytes(bvh, frames, False))
