"""K3T's, K3aT's and K8T's device code (``csrc/backward_common.cuh``: the
per-lane backward of the hit assembly with the winner's intersection,
static and animated, and of the sky's radiance lookup) compiled with g++
through ``tests/cuda_host`` and run on the CPU, held against their plain versions (render/backward.py
`assemble_hit_bwd_plain`, `env_radiance_bwd_plain`) on the same inputs.

The host's libm computes atan2f, acosf and sqrtf, and the scatter-adds land
in lane order rather than the card's, so floats are held to a tolerance
relative to each output's largest magnitude (1e-4), not to bits."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from test_torch_backward_kernels import _cotangents, _sky_dirs
from wurblpt_tpu_torch import native
from wurblpt_tpu_torch.native import SRC_DIR
from wurblpt_tpu_torch.render import backward as bw
from wurblpt_tpu_torch.render.intersect import assemble_hit, build_hit_tables
from wurblpt_tpu_torch.render.intersect_brute import build_brute_scene, closest_hit
from wurblpt_tpu_torch.render.intersect_sweep import build_sweep_scene, check_frames, closest_sweep
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

HOST = Path(__file__).parent / "cuda_host"
REL = 1e-4


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The host build of backward_common.cuh (tests/cuda_host/backward.cpp)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("bwd") / "libbwd.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{HOST}", f"-I{SRC_DIR}", "-o", str(out),
                    str(HOST / "backward.cpp")], check=True)
    lib = ctypes.CDLL(str(out))
    sig = native._SIGNATURES
    lib.host_assemble_hit_bwd.argtypes = sig["wpt_assemble_hit_bwd"][:-1]
    lib.host_env_radiance_bwd.argtypes = sig["wpt_env_radiance_bwd"][:-1]
    return lib


def _close(got, ref, what):
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    assert torch.isfinite(got).all(), what
    assert err <= REL * scale + 1e-6, f"{what}: {err} against scale {scale}"


def _lanes(name):
    scene, camera = {"cornell": (scenes.cornell_box_ref, scenes.cornell_ref_camera),
                     "envmap": (scenes.envmap_spheres, scenes.envmap_camera),
                     "rtiow": (scenes.rtiow, scenes.rtiow_camera)}[name]
    scene = scene(device="cpu")
    o, d, tmin, tmax = kc.camera_lanes(24, 24, 1, "cpu", camera=camera("cpu"))
    t, prim, u, v = closest_hit(build_brute_scene(scene), o, d, tmin, tmax)
    return build_hit_tables(scene), o, d, t, prim, u, v


@pytest.mark.parametrize("name", ["cornell", "envmap", "rtiow"])
def test_k3t_device_code_matches_its_plain_version(lib, name):
    """Triangle winners (the Cornell box, its ONB tangents), triangles and
    spheres (envmap_spheres), spheres alone (rtiow), with miss lanes; every
    cotangent random, uv's too."""
    ht, o, d, t, prim, u, v = _lanes(name)
    assert bool((prim < 0).any()) or name == "cornell"
    backside = assemble_hit(ht, o, d, t, prim, u, v).backside
    gs = _cotangents(o.shape[0], 3)
    ref = bw.assemble_hit_bwd_plain(ht, o, d, t, prim, u, v, backside, *gs)
    out = [torch.zeros_like(x) for x in ref]
    ptr = lambda x: x.data_ptr()  # noqa: E731
    assert lib.host_assemble_hit_bwd(
        ptr(o), ptr(d), ptr(t), ptr(prim), ptr(u), ptr(v), ptr(backside), o.shape[0],
        ptr(ht.tri_g), ptr(ht.tri_f), ptr(ht.tri_i), ht.n_tris, ptr(ht.sph_f), ht.n_spheres,
        *map(ptr, gs), *map(ptr, out)) == 0
    for what, a, b in zip(("g_o", "g_d", "g_tri_g", "g_tri_f", "g_sph_f"), out, ref):
        _close(a, b, f"{name} {what}")


def _anim_lanes(spheres, per_ray):
    """The animated box (with its two spheres) seen by 24 x 24 camera lanes,
    cast with the frame's rows at one instant or with each lane's own rows
    at a random time (the sweeps' plain version)."""
    scene = scenes.cornell_box_animated("cpu", spheres=spheres)
    o, d, tmin, tmax = kc.camera_lanes(24, 24, 1, "cpu")
    fr = kc.frames_per_ray_at(scene, o.shape[0]) if per_ray else kc.frames_at(scene)
    ss = build_sweep_scene(scene)
    t, prim, u, v = closest_sweep(ss, o, d, tmin, tmax, fr)
    return build_hit_tables(scene), o, d, t, prim, u, v, fr


@pytest.mark.parametrize("spheres", [False, True], ids=["box", "box with spheres"])
@pytest.mark.parametrize("per_ray", [False, True], ids=["one instant", "per ray"])
def test_k3at_device_code_matches_its_plain_version(lib, spheres, per_ray):
    """K3aT's lane (assemble_hit_bwd_lane<true>) against its plain version:
    the winners' object-space backward and the frame rows' cotangents,
    added into [A, 30] at one instant or stored to each lane's own row."""
    ht, o, d, t, prim, u, v, fr = _anim_lanes(spheres, per_ray)
    assert bool((prim >= ht.n_tris).any()) == spheres
    backside = assemble_hit(ht, o, d, t, prim, u, v, fr).backside
    gs = _cotangents(o.shape[0], 4)
    ref = bw.assemble_hit_bwd_plain(ht, o, d, t, prim, u, v, backside, *gs, frames=fr)
    out = [torch.zeros_like(x) for x in ref]
    ptr = lambda x: x.data_ptr()  # noqa: E731
    lib.host_assemble_hit_anim_bwd.argtypes = native._SIGNATURES["wpt_assemble_hit_anim_bwd"][:-1]
    stride = check_frames(fr, ht.n_anims, o.device, o.shape[0])
    assert stride == (ht.n_anims * 30 if per_ray else 0)
    assert lib.host_assemble_hit_anim_bwd(
        ptr(o), ptr(d), ptr(t), ptr(prim), ptr(u), ptr(v), ptr(backside), o.shape[0],
        ptr(ht.tri_g), ptr(ht.tri_f), ptr(ht.tri_i), ht.n_tris, ptr(ht.sph_f), ht.n_spheres,
        *map(ptr, gs), *map(ptr, out[:5]), ptr(ht.tri_anim), ptr(ht.sph_anim), ptr(fr), stride,
        ptr(out[5])) == 0
    for what, a, b in zip(("g_o", "g_d", "g_tri_g", "g_tri_f", "g_sph_f", "g_frames"), out, ref):
        _close(a, b, f"{what}")
    assert float(ref[5].abs().sum()) > 0


@pytest.mark.parametrize("kind", ["equirect", "cube"])
def test_k8t_device_code_matches_its_plain_version(lib, kind):
    env = scenes.envmap_spheres(cube=kind == "cube", device="cpu").envmap
    d = _sky_dirs(4096, 5)
    g = torch.randn(d.shape[0], 4, generator=torch.Generator().manual_seed(6))
    ref = bw.env_radiance_bwd_plain(env, d, g)
    g_d, g_img, g_const = torch.zeros_like(d), torch.zeros_like(env.image), torch.zeros(4)
    h, w = env.image.shape[-3], env.image.shape[-2]
    assert lib.host_env_radiance_bwd(d.data_ptr(), d.shape[0], env.kind, env.image.data_ptr(),
                                     h, w, env.rotation.data_ptr(), g.data_ptr(), g_d.data_ptr(),
                                     g_img.data_ptr(), g_const.data_ptr()) == 0
    _close(g_d, ref[0], f"{kind} g_d")
    _close(g_img, ref[1], f"{kind} g_image")


def test_k8t_device_code_on_a_rotated_cube(lib):
    """A rotated cube map: the direction's cotangent goes back through the
    rotation's transpose."""
    env = scenes.envmap_spheres(cube=True, device="cpu").envmap
    q = torch.tensor([0.1, 0.3, -0.2, 0.9])
    env = env._replace(rotation=q / torch.linalg.norm(q))
    d = _sky_dirs(2048, 7)
    g = torch.randn(d.shape[0], 4, generator=torch.Generator().manual_seed(8))
    ref = bw.env_radiance_bwd_plain(env, d, g)
    g_d, g_img = torch.zeros_like(d), torch.zeros_like(env.image)
    h, w = env.image.shape[-3], env.image.shape[-2]
    assert lib.host_env_radiance_bwd(d.data_ptr(), d.shape[0], 2, env.image.data_ptr(), h, w,
                                     env.rotation.data_ptr(), g.data_ptr(), g_d.data_ptr(),
                                     g_img.data_ptr(), torch.zeros(4).data_ptr()) == 0
    _close(g_d, ref[0], "rotated cube g_d")
    _close(g_img, ref[1], "rotated cube g_image")


@pytest.mark.parametrize("sample", [False, True], ids=["eval", "sample"])
def test_k7t_device_code_matches_its_plain_version(lib, sample):
    """K7T's lane (backward_common.cuh rgl_bwd_lane, its forward recomputed
    through rgl_common.cuh) against autograd through K7's plain forward, on
    grad_check.rgl_lanes' two stacked synthetic materials (4096 lanes, some
    below the surface): rgb, ndf and sigma within REL of each table's
    largest entry. The lanes must reach every table."""
    from wurblpt_tpu_torch.materials.rgl import c_tables
    from wurblpt_tpu_torch.utils import grad_check as gc

    tables, mid, wi, wo, u2, g_f = gc.rgl_lanes("cpu", n=4096)
    x = u2 if sample else wo
    ref = bw.rgl_bwd_plain(tables, mid, wi, x, g_f, sample)
    out = [torch.zeros_like(r) for r in ref]
    lib.host_rgl_bwd.argtypes = native._SIGNATURES["wpt_rgl_bwd"][:-1]
    ct = c_tables(tables)
    assert lib.host_rgl_bwd(ctypes.addressof(ct), mid.data_ptr(), wi.data_ptr(), x.data_ptr(),
                            mid.shape[0], int(sample), g_f.data_ptr(),
                            *(o.data_ptr() for o in out)) == 0
    for what, a, b in zip(("rgb", "ndf", "sigma"), out, ref):
        assert bool((b != 0).any()), what
        _close(a, b, f"{'sample' if sample else 'eval'} {what}")
