"""The walk of K5/K6 (``csrc/bvh_common.cuh``) compiled with g++ and run on
the CPU, held bit for bit against the plain walk of ``accel/traverse.py``.

The kernels cannot run here, but their control flow can: ``tests/cuda_host``
stands in for the CUDA intrinsics the walk uses (one std::thread per CUDA
thread, the warp votes and shuffles through a barrier per warp), so the
persistent fetch of lanes in chunks of 32, the queue of live lanes, the
while-while walk and the stack in shared memory with its spill rows run as
written, two blocks sharing one lane counter. The walk is also built with 2
shared stack entries in place of 16, so that every walk deeper than 2
spills. Rays over the small terrain_city (2594 triangles): the mesh frame's
camera, random rays from above and below the ground, axis-aligned rays,
rays with half the lanes dead, a count that is not a multiple of 32, and
every lane dead.

The sphere rows and the object-space slots run in the same build, each
instantiation picked by its variant as the kernels' entry points pick it:
the RTIOW field at n = 8 with a BVH (68 spheres: sphere rows, world rays)
and the animated Cornell box with its two spheres and a BVH swept at
t = 0.5 (triangle and sphere rows, static and animated, with the frame's
animation rows; also with those rows' object-space walk over the static
terrain, every row of animation 0). On the triangle walks the prim ids,
t, u and v are equal bit for bit; where a sphere row is tested, prim ids
and the occlusion bit are equal and t within rtol 1e-6 (PyTorch's CPU sqrt
is not correctly rounded on ~0.6 % of inputs here, the host's sqrtf is;
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


def _host_walks(lib, bvh, rays, short, frames=None):
    """(t, prim, u, v, occluded) of the host-built walk, the instantiation
    of this tree and `frames`."""
    n = rays[0].shape[0]
    spill = torch.zeros(GRID * BLOCK * max(bvh.depth - short, 1) * 2, dtype=torch.int32)
    args = [traverse.variant(bvh, frames), *(_ptr(x) for x in rays), n, _ptr(bvh.nodes),
            _ptr(bvh.prim_v), bvh.n_tris, _ptr(frames), _ptr(spill), GRID]
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
