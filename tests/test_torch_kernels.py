"""The hand-written kernels (K1 closest hit, K2 any hit, K3 hit assembly,
K5 BVH closest hit, K6 BVH any hit, K8 envmap) against their plain PyTorch
versions, with the tolerances of utils/kernel_check.py.

Tests marked `cuda` need an NVIDIA GPU with nvcc and skip without one. This
file imports no jax, so on such a machine it runs without the repository's
conftest:  python -m pytest --noconftest tests/test_torch_kernels.py
The CPU tests check the wrappers' dispatch and input checks.
"""

import functools

import numpy as np
import pytest
import torch

from wurblpt_tpu_torch import native
from wurblpt_tpu_torch.render import intersect, intersect_brute
from wurblpt_tpu_torch.scene.ir import Spheres
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return "cuda"


def _scene(device, sphere):
    """The Cornell box, optionally with a sphere on the floor (sphere branches)."""
    scene = scenes.cornell_box_ref(device)
    if sphere:
        f = dict(dtype=torch.float32, device=device)
        scene = scene._replace(spheres=Spheres(torch.tensor([[0.3, 0.35, 0.4]], **f),
                                               torch.tensor([0.3], **f),
                                               torch.tensor([0], dtype=torch.int32,
                                                            device=device)))
    return scene


def _lanes(device, scene, bs, kind):
    cam = kc.camera_lanes(kc.BENCH_WIDTH, kc.BENCH_WIDTH, kc.BENCH_LANES_M, device)
    if kind == "camera":
        return cam
    if kind == "random":
        return kc.random_lanes(kc.BENCH_LANES, device)
    return kc.shadow_lanes(scene, bs, cam)


@pytest.mark.cuda
@pytest.mark.parametrize("sphere", [False, True])
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_closest_hit_kernel_matches_plain(gpu, kind, sphere):
    scene = _scene(gpu, sphere)
    bs = intersect_brute.build_brute_scene(scene)
    before = native.LAUNCHES["closest_hit"]
    res = kc.check_closest_hit(bs, _lanes(gpu, scene, bs, kind))
    torch.cuda.synchronize()
    assert native.LAUNCHES["closest_hit"] == before + 1
    assert res["hits"] > 0.2 * res["lanes"]


@pytest.mark.cuda
@pytest.mark.parametrize("sphere", [False, True])
@pytest.mark.parametrize("kind", ["shadow", "random"])
def test_any_hit_kernel_matches_plain(gpu, kind, sphere):
    scene = _scene(gpu, sphere)
    bs = intersect_brute.build_brute_scene(scene)
    before = native.LAUNCHES["any_hit"]
    res = kc.check_any_hit(bs, _lanes(gpu, scene, bs, kind))
    torch.cuda.synchronize()
    assert native.LAUNCHES["any_hit"] == before + 1
    assert 0 < res["occluded"] < res["lanes"]


@pytest.mark.cuda
@pytest.mark.parametrize("sphere", [False, True])
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_assemble_hit_kernel_matches_plain(gpu, kind, sphere):
    scene = _scene(gpu, sphere)
    bs = intersect_brute.build_brute_scene(scene)
    ht = intersect.build_hit_tables(scene)
    before = native.LAUNCHES["assemble_hit"]
    kc.check_assemble_hit(bs, ht, _lanes(gpu, scene, bs, kind))
    torch.cuda.synchronize()
    assert native.LAUNCHES["assemble_hit"] == before + 1


def test_wrappers_take_the_plain_version_on_cpu():
    scene = _scene("cpu", True)
    bs = intersect_brute.build_brute_scene(scene)
    ht = intersect.build_hit_tables(scene)
    rays = kc.random_lanes(2048, "cpu")
    counts = dict(native.LAUNCHES)
    hit = intersect_brute.closest_hit(bs, *rays)
    for a, b in zip(hit, intersect_brute.closest_hit_plain(bs, *rays)):
        assert torch.equal(a, b)
    assert torch.equal(intersect_brute.any_hit(bs, *rays),
                       intersect_brute.any_hit_plain(bs, *rays))
    hr = intersect.assemble_hit(ht, rays[0], rays[1], *hit)
    for a, b in zip(hr, intersect.assemble_hit_plain(ht, rays[0], rays[1], *hit)):
        assert torch.equal(a, b)
    assert native.LAUNCHES == counts          # no kernel ran


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity"])
def test_wrappers_reject_malformed_rays(bad):
    bs = intersect_brute.build_brute_scene(_scene("cpu", False))
    o, d, t_min, t_max = kc.random_lanes(64, "cpu")
    if bad == "dtype":
        o = o.double()
    elif bad == "shape":
        t_max = t_max[:32]
    else:
        d = torch.cat([d, d], 1)[:, ::2]
    with pytest.raises(ValueError):
        intersect_brute.closest_hit(bs, o, d, t_min, t_max)
    with pytest.raises(ValueError):
        intersect_brute.any_hit(bs, o, d, t_min, t_max)


def test_dead_lanes_and_ties_on_cpu():
    """t_max <= t_min lanes miss; coplanar faces tie to the lowest prim id."""
    scene = _scene("cpu", False)
    bs = intersect_brute.build_brute_scene(scene)
    # Straight down onto the floor below the short box's bottom face: the
    # floor (prims 4, 5) and the box bottom (prims 14, 15) are coplanar at y = 0.
    o = torch.tensor([[0.3, 0.5, 0.35], [0.3, 0.5, 0.35]])
    d = torch.tensor([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]])
    t_min = torch.full((2,), 1e-4)
    t_max = torch.tensor([intersect_brute.BIG, 0.0])
    t, prim, _, _ = intersect_brute.closest_hit(bs, o, d, t_min, t_max)
    assert prim[1] == -1 and t[1] == np.float32(intersect_brute.BIG)
    c = intersect_brute.candidate_t(bs, o, d, t_min, t_max)[0]
    tied = torch.nonzero(c == c.min()).flatten()
    assert len(tied) >= 1 and prim[0] == tied.min()
    assert not bool(intersect_brute.any_hit(bs, o, d, t_min, t_max)[1])


@pytest.mark.parametrize("off", [None, "mean", "stats", "nan", "shape"])
def test_bench_frame_check_holds_the_reference(off):
    img = torch.full((kc.BENCH_WIDTH, kc.BENCH_WIDTH, 3), kc.REF_MEAN)
    stats = torch.tensor(kc.REF_STATS)
    if off == "mean":
        img = img * 1.002
    elif off == "stats":
        stats = stats * 1.01
    elif off == "nan":
        img[0, 0, 0] = float("nan")
    elif off == "shape":
        img = img[:64]
    if off is None:
        assert kc.check_bench_frame(img, stats) == pytest.approx(kc.REF_MEAN)
    else:
        with pytest.raises(AssertionError):
            kc.check_bench_frame(img, stats)


@pytest.mark.cuda
def test_render_on_gpu_matches_the_jax_reference_numbers(gpu):
    img, stats = kc.bench_frame(gpu)()
    kc.check_bench_frame(img, stats)


@functools.lru_cache(maxsize=None)
def _terrain(device):
    """The mesh path's scene, terrain_city(seed=3) at full size, on `device`."""
    return scenes.terrain_city(seed=3, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_bvh_closest_hit_kernel_matches_plain(gpu, kind):
    scene = _terrain(gpu)
    rays = (kc.mesh_camera_lanes(gpu) if kind == "camera"
            else kc.terrain_random_lanes(kc.MESH_LANES, gpu))
    before = native.LAUNCHES["bvh_closest_hit"]
    res = kc.check_bvh_closest_hit(scene.bvh, rays)
    torch.cuda.synchronize()
    assert native.LAUNCHES["bvh_closest_hit"] == before + 1
    assert res["hits"] > 0.2 * res["lanes"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["env shadow", "random"])
def test_bvh_any_hit_kernel_matches_plain(gpu, kind):
    scene = _terrain(gpu)
    rays = (kc.env_shadow_lanes(scene, kc.mesh_camera_lanes(gpu)) if kind == "env shadow"
            else kc.terrain_random_lanes(kc.MESH_LANES, gpu))
    before = native.LAUNCHES["bvh_any_hit"]
    res = kc.check_bvh_any_hit(scene.bvh, rays)
    torch.cuda.synchronize()
    assert native.LAUNCHES["bvh_any_hit"] == before + 1
    assert 0 < res["occluded"] < res["lanes"]


@pytest.mark.cuda
def test_envmap_kernels_match_plain(gpu):
    env = _terrain(gpu).envmap
    dirs = kc.mesh_camera_lanes(gpu)[1]
    u3 = torch.as_tensor(np.random.default_rng(3).uniform(size=(kc.MESH_LANES, 3)),
                         dtype=torch.float32, device=gpu)
    before = [native.LAUNCHES[k] for k in ("env_radiance", "env_sample", "env_pdf")]
    kc.check_envmap(env, dirs, u3)
    torch.cuda.synchronize()
    assert [native.LAUNCHES[k] for k in ("env_radiance", "env_sample", "env_pdf")] == [
        b + 1 for b in before]


@pytest.mark.parametrize("off", [None, "mean", "stats", "nan", "shape"])
def test_mesh_frame_check_holds_the_reference(off):
    img = torch.full((kc.MESH_HEIGHT, kc.MESH_WIDTH, 3), kc.MESH_REF_MEAN, dtype=torch.float64)
    stats = torch.tensor(kc.MESH_REF_STATS)
    if off == "mean":
        img = img * 1.002
    elif off == "stats":
        stats = stats * 1.01
    elif off == "nan":
        img[0, 0, 0] = float("nan")
    elif off == "shape":
        img = img.transpose(0, 1)
    if off is None:
        assert kc.check_mesh_frame(img, stats) == pytest.approx(kc.MESH_REF_MEAN)
    else:
        with pytest.raises(AssertionError):
            kc.check_mesh_frame(img, stats)


@pytest.mark.cuda
def test_mesh_render_on_gpu_matches_the_jax_reference_numbers(gpu):
    native.reset_launch_counts()
    img, stats = kc.mesh_frame(gpu, _terrain(gpu))()
    kc.check_mesh_frame(img, stats)
    for name in ("assemble_hit", "bvh_closest_hit", "bvh_any_hit", "env_radiance", "env_sample",
                 "env_pdf"):
        assert native.LAUNCHES[name] > 0, name
    assert native.LAUNCHES["closest_hit"] == native.LAUNCHES["any_hit"] == 0
