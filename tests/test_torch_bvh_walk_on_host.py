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
every lane dead."""

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
                        "-pthread", f"-I{out}", f"-I{HOST}", "-o", str(lib),
                        str(HOST / "walk.cpp")], check=True)
        libs[short] = ctypes.CDLL(str(lib))
    return libs


@functools.lru_cache(maxsize=None)
def _scene():
    return scenes.terrain_city(seed=3, terrain_res=24, n_buildings=8, sphere_slices=6,
                               device="cpu")


def _rays(kind):
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
    return ctypes.c_void_p(x.data_ptr())


@pytest.mark.parametrize("short", [traverse.SHARED_STACK, 2])
@pytest.mark.parametrize("kind", ["camera", "random", "axis", "half dead", "ragged",
                                  "every lane dead"])
def test_host_walk_matches_the_plain_walk(walks, kind, short):
    lib, bvh = walks[short], _scene().bvh
    rays = _rays(kind)
    n = rays[0].shape[0]
    spill = torch.zeros(GRID * BLOCK * max(bvh.depth - short, 1) * 2, dtype=torch.int32)
    args = [*(_ptr(x) for x in rays), n, _ptr(bvh.nodes), _ptr(bvh.tri_v), _ptr(spill), GRID]
    t, u, v = (torch.full((n,), -7.0) for _ in range(3))
    prim = torch.full((n,), -7, dtype=torch.int32)
    lib.host_closest_hit(*args, _ptr(t), _ptr(prim), _ptr(u), _ptr(v))
    ref = traverse.bvh_closest_hit_plain(bvh, *rays)
    for got, want in zip((t, prim, u, v), ref):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    occ = torch.ones((n,), dtype=torch.bool)
    lib.host_any_hit(*args, _ptr(occ))
    assert torch.equal(occ, traverse.bvh_any_hit_plain(bvh, *rays))
    live = rays[3] > rays[2]
    assert ((prim >= 0) <= live).all()
    if kind != "every lane dead":
        assert 0 < int((prim >= 0).sum()) and 0 < int(occ.sum()) < int(live.sum())
