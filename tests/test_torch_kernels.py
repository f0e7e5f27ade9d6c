"""The hand-written kernels (K1 closest hit, K2 any hit, K3 hit assembly and
its animated branch K3a, the sweeps KS1/KS2, K5 BVH closest hit, K6 BVH
any hit, K7 RGL eval/sample, K8 envmap with its equirect, cube and constant
branches, P0 row gather) against their plain PyTorch versions, with the
tolerances of utils/kernel_check.py.

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
from wurblpt_tpu_torch.materials.rgl import (
    load_rgl_material,
    rgl_eval,
    rgl_eval_plain,
    rgl_sample,
    rgl_sample_plain,
    stack_rgl_tables,
)
from wurblpt_tpu_torch.render import bsdf, intersect, intersect_brute, intersect_sweep
from wurblpt_tpu_torch.render.gather import row_gather
from wurblpt_tpu_torch.scene.ir import Spheres
from wurblpt_tpu_torch.utils import cast_steps
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


@functools.lru_cache(maxsize=None)
def _city_later_casts(device):
    """(closest-hit rays, any-hit rays) of the city frame's third step: at 1
    spp its lanes are never refilled, so the live ones are sparse and
    incoherent."""
    casts = cast_steps.record_casts(kc.city_frame(device, _city(device)))
    closest = [rays for name, _, rays in casts if name == "bvh_closest_hit"]
    shadow = [rays for name, _, rays in casts if name == "bvh_any_hit"]
    return closest[2], shadow[2]


def _bvh_rays(kind, device, shadow: bool):
    """(scene, rays) of one K5/K6 case: the mesh frame's camera rays (or their
    env-NEE shadow rays), random rays over the terrain, a later city step,
    every lane dead, or a ragged count (not a multiple of 32)."""
    if kind == "city later step":
        return _city(device), _city_later_casts(device)[int(shadow)]
    scene = _terrain(device)
    if kind == "camera":
        return scene, kc.mesh_camera_lanes(device)
    if kind == "env shadow":
        return scene, kc.env_shadow_lanes(scene, kc.mesh_camera_lanes(device))
    rays = kc.terrain_random_lanes(kc.MESH_LANES, device)
    if kind == "every lane dead":
        return scene, rays[:3] + (torch.zeros_like(rays[3]),)
    if kind == "ragged":
        return scene, tuple(x[:1000 + 13] for x in rays)
    return scene, rays


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["camera", "random", "city later step", "every lane dead",
                                  "ragged"])
def test_bvh_closest_hit_kernel_matches_plain(gpu, kind):
    scene, rays = _bvh_rays(kind, gpu, shadow=False)
    before = native.LAUNCHES["bvh_closest_hit"]
    res = kc.check_bvh_closest_hit(scene.bvh, rays)
    torch.cuda.synchronize()
    assert native.LAUNCHES["bvh_closest_hit"] == before + 1
    if kind == "every lane dead":
        assert res["hits"] == 0
    elif kind == "city later step":
        assert 0 < res["live"] < 0.5 * res["lanes"] and res["hits"] > 0
    else:
        assert res["hits"] > 0.2 * res["lanes"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["env shadow", "random", "city later step", "every lane dead",
                                  "ragged"])
def test_bvh_any_hit_kernel_matches_plain(gpu, kind):
    scene, rays = _bvh_rays(kind, gpu, shadow=True)
    before = native.LAUNCHES["bvh_any_hit"]
    res = kc.check_bvh_any_hit(scene.bvh, rays)
    torch.cuda.synchronize()
    assert native.LAUNCHES["bvh_any_hit"] == before + 1
    if kind == "every lane dead":
        assert res["occluded"] == 0
    else:
        assert 0 < res["occluded"] < res["live"]


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
    # K4's env class: the shade reads the sky inline, no stand-alone K8 or P0
    for name in ("regen_pinhole", "bvh_closest_hit", "assemble_hit", "shade_env", "bvh_any_hit",
                 "nee_resolve"):
        assert native.LAUNCHES[name] > 0, name
    for name in ("closest_hit", "any_hit", "env_radiance", "env_sample", "env_pdf", "row_gather",
                 "shade_diffuse"):
        assert native.LAUNCHES[name] == 0, name


def _rgl_tables(device, two: bool):
    """The city's RGL table, or two random materials of different sizes (P = 2, T = 3 padded)."""
    if not two:
        return stack_rgl_tables([load_rgl_material(scenes.city_rgl_fields(7))], device)
    rs = np.random.default_rng(5)

    def pos(*shape):
        return rs.uniform(0.2, 1.0, size=shape).astype(np.float32)

    mats = [dict(phi_i=np.linspace(-np.pi, np.pi, p).astype(np.float32),
                 theta_i=np.linspace(0, np.pi / 2, t).astype(np.float32), ndf=pos(hn, hn),
                 sigma=pos(hn, hn) * 0.4, vndf=pos(p, t, hv, hv), luminance=pos(p, t, hl, hl),
                 rgb=pos(p, t, 3, hl, hl))
            for p, t, hv, hl, hn in ((2, 3, 16, 8, 16), (1, 2, 12, 6, 10))]
    return stack_rgl_tables([load_rgl_material(m) for m in mats], device)


def _rgl_random_lanes(n, n_mat, device, seed=6):
    rs = np.random.default_rng(seed)

    def sphere():
        x = rs.normal(size=(n, 3))
        return torch.as_tensor(x / np.linalg.norm(x, axis=-1, keepdims=True), dtype=torch.float32,
                               device=device)

    return (torch.as_tensor(rs.integers(0, n_mat, n), dtype=torch.int32, device=device), sphere(),
            sphere(), torch.as_tensor(rs.uniform(size=(n, 2)), dtype=torch.float32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("two", [False, True])
def test_rgl_kernels_match_plain(gpu, two):
    tables = _rgl_tables(gpu, two)
    before = [native.LAUNCHES[k] for k in ("rgl_eval", "rgl_sample")]
    res = kc.check_rgl(tables, _rgl_random_lanes(1 << 18, tables.count, gpu))
    torch.cuda.synchronize()
    assert [native.LAUNCHES[k] for k in ("rgl_eval", "rgl_sample")] == [b + 1 for b in before]
    assert res["eval_nonzero"] > 0.2 * res["lanes"] and res["sample_ok"] > 0.2 * res["lanes"]


@functools.lru_cache(maxsize=None)
def _city(device):
    """The city path's scene, city_night(seed=7) at full size, on `device`."""
    return scenes.city_night(seed=7, device=device)


@pytest.mark.cuda
def test_rgl_kernels_match_plain_on_city_lanes(gpu):
    city = _city(gpu)
    res = kc.check_rgl(city.rgl, kc.city_rgl_lanes(city, gpu))
    assert res["lanes"] == kc.CITY_LANES and res["sample_ok"] > 0.2 * res["lanes"]


@pytest.mark.cuda
def test_row_gather_kernel_matches_plain(gpu):
    cases = list(kc.probe_gather_inputs(gpu))
    packed = bsdf.pack_material_table(_city(gpu).materials)     # floats and int bit patterns
    rs = np.random.default_rng(8)
    idx = torch.as_tensor(rs.integers(-3, packed.shape[0] + 3, 100000), dtype=torch.int32,
                          device=gpu)     # out-of-range ids clamp, as XLA's gather does
    cases += [(packed, idx), (packed.view(torch.int32), idx)]
    for table, i in cases:
        before = native.LAUNCHES["row_gather"]
        kc.check_row_gather(table, i)
        torch.cuda.synchronize()
        assert native.LAUNCHES["row_gather"] == before + 1


def test_rgl_and_row_gather_wrappers_take_the_plain_version_on_cpu():
    tables = _rgl_tables("cpu", True)
    lanes = _rgl_random_lanes(512, tables.count, "cpu")
    counts = dict(native.LAUNCHES)
    for a, b in zip(rgl_eval(tables, *lanes[:3]), rgl_eval_plain(tables, *lanes[:3])):
        assert torch.equal(a, b)
    lanes_s = (lanes[0], lanes[1], lanes[3])
    for a, b in zip(rgl_sample(tables, *lanes_s), rgl_sample_plain(tables, *lanes_s)):
        assert torch.equal(a, b)
    (table, idx), _ = kc.probe_gather_inputs("cpu")
    assert torch.equal(row_gather(table, idx), table[idx.long()])
    assert native.LAUNCHES == counts          # no kernel ran
    with pytest.raises(ValueError):
        row_gather(table.double(), idx)
    with pytest.raises(ValueError):
        row_gather(table, idx.long())


@pytest.mark.parametrize("kernel", ["assemble_hit", "bvh_closest_hit", "bvh_any_hit"])
def test_bounds_read_each_table_once(kernel):
    """The byte term of a bound counts the lanes' inputs and outputs and each
    table once, however many lanes read it; the walk's visits count as work.
    A BVH lane reads its ray (24 B) only where it is live, and a triangle
    counts its 40 B of vertices and id, not its row's pad."""
    if kernel == "assemble_hit":
        ht = intersect.build_hit_tables(_scene("cpu", True))
        table = sum(x.numel() * x.element_size() for x in ht[:4])
        work = functools.partial(kc.assemble_hit_work, ht)
        per_lane, per_live = 40 + 61, 0
    else:
        bvh = scenes.terrain_city(seed=3, terrain_res=8, n_buildings=2, sphere_slices=4,
                                   device="cpu").bvh
        table = bvh.nodes.numel() * 4 + 40 * bvh.tri_id.shape[0]
        assert table < sum(x.numel() * x.element_size() for x in (bvh.nodes, bvh.tri_v))
        any_hit = kernel == "bvh_any_hit"
        o, d, t_min, t_max = kc.terrain_random_lanes(512, "cpu")
        t_max = torch.where(torch.arange(512) % 3 == 0, t_min, t_max)   # every third lane dead

        def work(n):
            return kc.bvh_work(bvh, (o[:n], d[:n], t_min[:n], t_max[:n]), any_hit=any_hit)

        per_lane, per_live = 8 + (1 if any_hit else 16), 24
    for n in (256, 512):
        n_bytes, flops = work(n)
        if kernel == "assemble_hit":
            live = n
        else:
            live = int((t_max[:n] > t_min[:n]).sum())
            assert 0 < live <= 2 * n // 3 + 1
        assert n_bytes == n * per_lane + live * per_live + table and flops > 0
    assert work(512)[1] > work(256)[1]


@pytest.mark.parametrize("sky", ["constant", "cube"])
def test_env_radiance_bound_counts_what_the_branch_reads(sky):
    """The constant map reads no direction and no image: 16 B out per lane and
    its 16 B radiance once, no arithmetic. The cube map reads the direction
    (12 B) and writes 16 B per lane, and reads its faces and tables once."""
    if sky == "constant":
        env = scenes.rtiow(device="cpu").envmap
        per_lane, table = 16, 16
    else:
        env = scenes.envmap_spheres(cube=True, device="cpu").envmap
        per_lane = 12 + 16
        table = sum(x.numel() * x.element_size() for x in env[1:] if isinstance(x, torch.Tensor))
        assert table >= 6 * 32 * 32 * 4 * 4
    for n in (1000, 98304):
        n_bytes, flops = kc.env_radiance_work(env, n)
        assert n_bytes == n * per_lane + table
        assert flops == (0.0 if sky == "constant" else 60.0 * n)


@pytest.mark.parametrize("off", [None, "mean", "stats", "nan", "shape"])
def test_city_frame_check_holds_the_reference(off):
    img = torch.full((kc.CITY_HEIGHT, kc.CITY_WIDTH, 3), kc.CITY_REF_MEAN, dtype=torch.float64)
    stats = torch.tensor(kc.CITY_REF_STATS)
    if off == "mean":
        img = img * 1.002
    elif off == "stats":
        stats = stats * 1.01
    elif off == "nan":
        img[0, 0, 0] = float("nan")
    elif off == "shape":
        img = img[: kc.CITY_HEIGHT // 2]
    if off is None:
        assert kc.check_city_frame(img, stats) == pytest.approx(kc.CITY_REF_MEAN)
    else:
        with pytest.raises(AssertionError):
            kc.check_city_frame(img, stats)


@pytest.mark.cuda
def test_city_render_on_gpu_matches_the_jax_reference_numbers(gpu):
    """The city frame through K4's lit class: the surround regeneration, K5,
    K3, the lit shade (RGL, the sky and the material rows inline), K6 and
    the resolve; no stand-alone K7, K8 or P0 launch."""
    native.reset_launch_counts()
    img, stats = kc.city_frame(gpu, _city(gpu))()
    kc.check_city_frame(img, stats)
    for name in ("regen_surround", "assemble_hit", "bvh_closest_hit", "shade_lit", "bvh_any_hit",
                 "nee_resolve"):
        assert native.LAUNCHES[name] > 0, name
    for name in ("env_radiance", "env_sample", "env_pdf", "rgl_eval", "rgl_sample",
                 "row_gather"):
        assert native.LAUNCHES[name] == 0, name


@functools.lru_cache(maxsize=None)
def _sphere_scenes(device):
    """The sphere paths' scenes: envmap_spheres(cube=True) and rtiow()."""
    return scenes.envmap_spheres(cube=True, device=device), scenes.rtiow(device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_sphere_only_scene_kernels_match_plain(gpu, kind):
    """K1, K2 and K3 on rtiow: 40 spheres and no triangle (a null triangle
    table), the radius-1000 ground among them."""
    scene = _sphere_scenes(gpu)[1]
    assert scene.n_tris == 0
    bs = intersect_brute.build_brute_scene(scene)
    ht = intersect.build_hit_tables(scene)
    rays = (kc.rtiow_camera_lanes(gpu) if kind == "camera"
            else kc.random_lanes(kc.RTIOW_LANES, gpu, lo=(-6.0, -0.5, -4.0), hi=(6.0, 2.5, 4.0)))
    before = dict(native.LAUNCHES)
    res = kc.check_closest_hit(bs, rays)
    assert res["hits"] > 0.2 * res["lanes"]
    occ = kc.check_any_hit(bs, rays)
    assert 0 < occ["occluded"]
    kc.check_assemble_hit(bs, ht, rays)
    torch.cuda.synchronize()
    for name in ("closest_hit", "any_hit", "assemble_hit"):
        assert native.LAUNCHES[name] == before[name] + 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("dirs", ["camera", "random", "edges"])
def test_envmap_cube_kernels_match_plain(gpu, dirs):
    env = _sphere_scenes(gpu)[0].envmap
    assert env.kind == 2 and env.importance
    d = {"camera": lambda: kc.envmap_camera_lanes(gpu)[1],
         "random": lambda: kc.random_directions(kc.ENVMAP_LANES, gpu),
         "edges": lambda: kc.cube_edge_directions(gpu)}[dirs]()
    u3 = torch.as_tensor(np.random.default_rng(3).uniform(size=(d.shape[0], 3)),
                         dtype=torch.float32, device=gpu)
    before = [native.LAUNCHES[k] for k in ("env_radiance", "env_sample", "env_pdf")]
    kc.check_envmap(env, d, u3)                       # radiance bit-equal on the cube map
    torch.cuda.synchronize()
    assert [native.LAUNCHES[k] for k in ("env_radiance", "env_sample", "env_pdf")] == [
        b + 1 for b in before]


@pytest.mark.cuda
def test_envmap_constant_kernel_matches_plain(gpu):
    env = _sphere_scenes(gpu)[1].envmap
    assert env.kind == 3 and not env.importance
    before = native.LAUNCHES["env_radiance"]
    res = kc.check_envmap(env, kc.rtiow_camera_lanes(gpu)[1])
    torch.cuda.synchronize()
    assert res["max_abs_err"] == 0.0 and native.LAUNCHES["env_radiance"] == before + 1


@pytest.mark.parametrize("frame", ["envmap", "rtiow"])
@pytest.mark.parametrize("off", [None, "mean", "stats", "nan", "shape"])
def test_sphere_frame_checks_hold_the_reference(frame, off):
    if frame == "envmap":
        shape, ref, ref_stats = ((kc.ENVMAP_WIDTH, kc.ENVMAP_WIDTH, 3), kc.ENVMAP_REF_MEAN,
                                 kc.ENVMAP_REF_STATS)
        check = kc.check_envmap_frame
    else:
        shape, ref, ref_stats = ((kc.RTIOW_HEIGHT, kc.RTIOW_WIDTH, 3), kc.RTIOW_REF_MEAN,
                                 kc.RTIOW_REF_STATS)
        check = kc.check_rtiow_frame
    img = torch.full(shape, ref, dtype=torch.float64)
    stats = torch.tensor(ref_stats)
    if off == "mean":
        img = img * 1.002
    elif off == "stats":
        stats = stats * 1.01
    elif off == "nan":
        img[0, 0, 0] = float("nan")
    elif off == "shape":
        img = img[:, : shape[1] // 2]
    if off is None:
        assert check(img, stats) == pytest.approx(ref)
    else:
        with pytest.raises(AssertionError):
            check(img, stats)


@pytest.mark.parametrize("off", [None, "mean", "channel", "stats", "nan", "shape"])
def test_tof_frame_check_holds_the_reference(off):
    img = torch.stack([torch.full((kc.TOF_WIDTH, kc.TOF_WIDTH), c, dtype=torch.float64)
                       for c in kc.TOF_REF_CHANNELS], -1)
    stats = torch.tensor(kc.TOF_REF_STATS)
    if off == "mean":
        img = img * 1.002
    elif off == "channel":       # a and b swapped: the mean holds, the channels do not
        img = img[..., [1, 0, 2]]
    elif off == "stats":
        stats = stats * 1.01
    elif off == "nan":
        img[0, 0, 0] = float("nan")
    elif off == "shape":
        img = img[:, :48]
    if off is None:
        assert kc.check_tof_frame(img, stats) == pytest.approx(kc.TOF_REF_MEAN)
    else:
        with pytest.raises(AssertionError):
            kc.check_tof_frame(img, stats)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["envmap", "rtiow"])
def test_sphere_renders_on_gpu_match_the_jax_reference_numbers(gpu, frame):
    env_scene, rt_scene = _sphere_scenes(gpu)
    native.reset_launch_counts()
    need = ("regen_pinhole", "closest_hit", "assemble_hit", "shade_env", "nee_resolve")
    if frame == "envmap":
        img, stats = kc.envmap_frame(gpu, env_scene)()
        kc.check_envmap_frame(img, stats)
        need += ("any_hit",)
    else:
        img, stats = kc.rtiow_frame(gpu, rt_scene)()
        kc.check_rtiow_frame(img, stats)
        assert native.LAUNCHES["any_hit"] == 0            # no light, no sky importance
    for name in need:                                    # K4's env class
        assert native.LAUNCHES[name] > 0, name
    for name in ("row_gather", "env_radiance", "env_sample", "env_pdf"):
        assert native.LAUNCHES[name] == 0, name          # the shade reads rows and sky inline


@functools.lru_cache(maxsize=None)
def _swept(device, which):
    """(scene, its SweepScene, HitTables, frames or None, camera rays) of the
    animated Cornell box (with spheres: the sphere branches) at t = 0.5, or of
    ROADMAP C.1's field of 2000 triangles and 40 spheres (static sweeps)."""
    if which == "field":
        scene = scenes.tri_sphere_field(device=device)
        rays = kc.field_camera_lanes(device)
    else:
        scene = scenes.cornell_box_animated(device, spheres=which == "animated spheres")
        rays = kc.camera_lanes(kc.BENCH_WIDTH, kc.BENCH_WIDTH, kc.BENCH_LANES_M, device)
    ss = intersect_sweep.build_sweep_scene(scene)
    frames = kc.frames_at(scene) if scene.n_anims > 1 else None
    return scene, ss, intersect.build_hit_tables(scene), frames, rays


def _sweep_rays(device, which, kind):
    scene, ss, _, frames, cam = _swept(device, which)
    if kind == "camera":
        return cam
    if kind == "random":
        return kc.random_lanes(cam[0].shape[0], device)
    if frames is None:
        return kc.sky_shadow_lanes(
            lambda *r: intersect_sweep.closest_sweep_plain(ss, *r), cam)
    return kc.anim_shadow_lanes(scene, ss, frames, cam)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["animated", "animated spheres", "field"])
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_sweep_closest_kernel_matches_plain(gpu, which, kind):
    _, ss, _, frames, _ = _swept(gpu, which)
    before = native.LAUNCHES["sweep_closest"]
    res = kc.check_sweep_closest(ss, _sweep_rays(gpu, which, kind), frames)
    torch.cuda.synchronize()
    assert native.LAUNCHES["sweep_closest"] == before + 1 and res["hits"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["animated", "animated spheres", "field"])
@pytest.mark.parametrize("kind", ["shadow", "random"])
def test_sweep_any_kernel_matches_plain(gpu, which, kind):
    _, ss, _, frames, _ = _swept(gpu, which)
    before = native.LAUNCHES["sweep_any"]
    res = kc.check_sweep_any(ss, _sweep_rays(gpu, which, kind), frames)
    torch.cuda.synchronize()
    assert native.LAUNCHES["sweep_any"] == before + 1 and 0 < res["occluded"] < res["lanes"]


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["animated", "animated spheres", "field"])
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_assemble_hit_kernel_matches_plain_on_the_sweeps(gpu, which, kind):
    """K3a on the animated scenes, K3 on the static field's sweep winners."""
    _, ss, ht, frames, _ = _swept(gpu, which)
    counter = "assemble_hit" if frames is None else "assemble_hit_anim"
    before = native.LAUNCHES[counter]
    kc.check_assemble_hit_sweep(ss, ht, _sweep_rays(gpu, which, kind), frames)
    torch.cuda.synchronize()
    assert native.LAUNCHES[counter] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_spheres", [3000, 4096])
def test_k1_k2_hold_the_k1_forms_largest_sphere_scenes(gpu, n_spheres):
    """4096 spheres fill the K1 form's 8192 columns: K1 and K2 stage them in
    chunks, as they stage the Cornell box's 36 triangles."""
    scene = scenes.sphere_field(n_spheres, device=gpu)
    assert intersect_brute.brute_eligible(scene)
    bs = intersect_brute.build_brute_scene(scene)
    cam = kc.field_camera_lanes(gpu)
    res = kc.check_closest_hit(bs, cam)
    assert res["hits"] > 0.3 * res["lanes"]
    shadow = kc.sky_shadow_lanes(lambda *r: intersect_brute.closest_hit_plain(bs, *r), cam)
    res = kc.check_any_hit(bs, shadow)
    assert 0 < res["occluded"] < res["lanes"]
    kc.check_assemble_hit(bs, intersect.build_hit_tables(scene), cam)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cornell_animated_render_on_gpu_matches_the_jax_reference_numbers(gpu):
    before = dict(native.LAUNCHES)
    img, stats = kc.cornell_animated_frame(gpu)()
    kc.check_cornell_animated_frame(img, stats)
    for name in ("regen_pinhole", "sweep_closest", "assemble_hit_anim", "shade_diffuse",
                 "sweep_any", "nee_resolve"):
        assert native.LAUNCHES[name] > before[name]
    for name in ("closest_hit", "any_hit", "assemble_hit", "row_gather"):
        assert native.LAUNCHES[name] == before[name]


def test_sweep_and_k3a_wrappers_take_the_plain_version_on_cpu():
    scene, ss, ht, frames, _ = _swept("cpu", "animated spheres")
    rays = kc.random_lanes(2048, "cpu")
    counts = dict(native.LAUNCHES)
    hit = intersect_sweep.closest_sweep(ss, *rays, frames)
    for a, b in zip(hit, intersect_sweep.closest_sweep_plain(ss, *rays, frames)):
        assert torch.equal(a, b)
    assert torch.equal(intersect_sweep.any_sweep(ss, *rays, frames),
                       intersect_sweep.any_sweep_plain(ss, *rays, frames))
    hr = intersect.assemble_hit(ht, rays[0], rays[1], *hit, frames)
    for a, b in zip(hr, intersect.assemble_hit_plain(ht, rays[0], rays[1], *hit, frames)):
        assert torch.equal(a, b)
    assert native.LAUNCHES == counts          # no kernel ran
    with pytest.raises(ValueError, match="frames"):
        intersect.assemble_hit(ht, rays[0], rays[1], *hit, frames.double())


@pytest.mark.parametrize("off", [None, "mean", "stats", "nan", "shape"])
def test_cornell_animated_frame_check_holds_the_reference(off):
    img = torch.full((kc.BENCH_WIDTH, kc.BENCH_WIDTH, 3), kc.ANIM_REF_MEAN, dtype=torch.float64)
    stats = torch.tensor(kc.ANIM_REF_STATS)
    if off == "mean":
        img = img * 1.002
    elif off == "stats":
        stats = stats * 1.01
    elif off == "nan":
        img[0, 0, 0] = float("nan")
    elif off == "shape":
        img = img[:64]
    if off is None:
        assert kc.check_cornell_animated_frame(img, stats) == pytest.approx(kc.ANIM_REF_MEAN)
    else:
        with pytest.raises(AssertionError):
            kc.check_cornell_animated_frame(img, stats)


@pytest.mark.parametrize("any_hit", [False, True])
def test_sweep_bounds_count_live_lanes_tables_and_tests(any_hit):
    """A sweep lane reads its ray (24 B) only where it is live; the tables
    (40 B a triangle, 20 B a sphere) and the frame rows count once; a live
    lane's tests count per primitive (KS1), up to its first blocker (KS2)."""
    _, ss, _, frames, _ = _swept("cpu", "animated spheres")
    o, d, t_min, t_max = kc.random_lanes(512, "cpu")
    live = int((t_max > t_min).sum())
    n_bytes, flops = kc.sweep_work(ss, (o, d, t_min, t_max), frames, any_hit=any_hit)
    tables = 40 * ss.n_tris + 20 * ss.n_spheres + frames.numel() * 4
    assert n_bytes == 512 * 8 + live * 24 + (512 if any_hit else 512 * 16) + tables
    full = live * (kc.SWEEP_TRI_FLOPS * ss.n_tris + kc.SWEEP_SPHERE_FLOPS * ss.n_spheres)
    obj = kc.OBJECT_RAY_FLOPS * kc._anim_runs(ss) * live
    if any_hit:
        assert obj < flops < full + obj
    else:
        assert flops == full + obj
