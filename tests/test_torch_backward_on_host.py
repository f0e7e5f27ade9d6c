"""K3T's, K3aT's, K8T's and K7T's device code (``csrc/backward_common.cuh``:
the per-lane backward of the hit assembly with the winner's intersection,
static and animated, of the sky's radiance lookup with its rotation term
and of its importance sample, and of the measured RGL BRDF, its tail form
and its full form) compiled with g++ through ``tests/cuda_host`` and run
on the CPU, held against their plain versions (render/backward.py
`assemble_hit_bwd_plain`, `env_radiance_bwd_plain`, `env_sample_bwd_plain`,
materials/rgl.py `rgl_bwd_plain`) on the same inputs.

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
    lib.host_env_sample_bwd.argtypes = sig["wpt_env_sample_bwd"][:-1]
    lib.host_rgl_bwd.argtypes = sig["wpt_rgl_bwd"][:-1]
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


def _host_k8t(lib, env, d, g):
    """(g_d, g_image, g_rotation) of the host build of K8T's lanes."""
    g_d, g_img, g_rot = torch.zeros_like(d), torch.zeros_like(env.image), torch.zeros(4)
    h, w = env.image.shape[-3], env.image.shape[-2]
    assert lib.host_env_radiance_bwd(d.data_ptr(), d.shape[0], env.kind, env.image.data_ptr(),
                                     h, w, env.rotation.data_ptr(), g.data_ptr(), g_d.data_ptr(),
                                     g_img.data_ptr(), torch.zeros(4).data_ptr(),
                                     g_rot.data_ptr()) == 0
    return g_d, g_img, g_rot


def _sums_close(got, ref, mag, what):
    """A sum over the lanes (the host adds them in lane order) within REL of
    its terms' magnitudes."""
    err = float((got - ref).abs().max())
    assert err <= REL * float(mag.max()) + 1e-6, f"{what}: {got} against {ref}"


@pytest.mark.parametrize("kind", ["equirect", "cube"])
def test_k8t_device_code_matches_its_plain_version(lib, kind):
    """The direction's and the texels' cotangents, and the rotation's (the
    lanes' terms of dm = R(conj q) d summed) at the identity."""
    env = scenes.envmap_spheres(cube=kind == "cube", device="cpu").envmap
    d = _sky_dirs(4096, 5)
    g = torch.randn(d.shape[0], 4, generator=torch.Generator().manual_seed(6))
    ref = bw.env_radiance_bwd_plain(env, d, g, magnitudes=True)
    g_d, g_img, g_rot = _host_k8t(lib, env, d, g)
    _close(g_d, ref[0], f"{kind} g_d")
    _close(g_img, ref[1], f"{kind} g_image")
    _sums_close(g_rot, ref[3], ref[6], f"{kind} g_rotation")


def test_k8t_device_code_on_a_rotated_cube(lib):
    """A rotated cube map: the direction's cotangent goes back through the
    rotation's transpose, the rotation's through the rotation formula."""
    env = scenes.envmap_spheres(cube=True, device="cpu").envmap
    q = torch.tensor([0.1, 0.3, -0.2, 0.9])
    env = env._replace(rotation=q / torch.linalg.norm(q))
    d = _sky_dirs(2048, 7)
    g = torch.randn(d.shape[0], 4, generator=torch.Generator().manual_seed(8))
    ref = bw.env_radiance_bwd_plain(env, d, g, magnitudes=True)
    g_d, g_img, g_rot = _host_k8t(lib, env, d, g)
    _close(g_d, ref[0], "rotated cube g_d")
    _close(g_img, ref[1], "rotated cube g_image")
    _sums_close(g_rot, ref[3], ref[6], "rotated cube g_rotation")


def test_k8t_sample_device_code_matches_its_plain_version(lib):
    """K8T's sample backward (env_sample_bwd_lane: the sample's map-space
    direction from envmap_common.cuh sample_map, the rotation formula's
    backward) on envmap_spheres' rotated equirect sky."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    env, u3, g_dir = gc.env_sample_lanes("cpu", n=8192)
    ref, mag = bw.env_sample_bwd_plain(env, u3, g_dir, magnitudes=True)
    g_rot = torch.zeros(4)
    assert lib.host_env_sample_bwd(u3.data_ptr(), u3.shape[0], env.pdf_table.data_ptr(),
                                   env.alias_prob.data_ptr(), env.alias_idx.data_ptr(),
                                   env.pdf_table.shape[0], env.rotation.data_ptr(),
                                   g_dir.data_ptr(), g_rot.data_ptr()) == 0
    _sums_close(g_rot, ref, mag, "sample g_rotation")


def _host_k7t(lib, tables, mid, wi, x, g_f, sample, full, g_pdf=None, g_wo=None):
    """The host build of K7T's lanes (wpt_rgl_bwd's arguments): a dict of
    cotangents, the tail form's or the full form's."""
    from wurblpt_tpu_torch.materials.rgl import GRAD_TABLES, TAIL_TABLES, _CGrads, c_tables

    out = {k: torch.zeros_like(getattr(tables, k)) for k in (GRAD_TABLES if full else TAIL_TABLES)}
    if full:
        out["wi"] = torch.zeros_like(wi)
        if not sample:
            out["wo"] = torch.zeros_like(x)
    co = _CGrads(*(out[k].data_ptr() if k in out else None for k, _ in _CGrads._fields_))
    ct = c_tables(tables)
    n = mid.shape[0]
    g_pdf = torch.zeros(n) if g_pdf is None else g_pdf
    g_wo = torch.zeros(n, 3) if g_wo is None else g_wo
    assert lib.host_rgl_bwd(ctypes.addressof(ct), ctypes.addressof(co), mid.data_ptr(),
                            wi.data_ptr(), x.data_ptr(), n, int(sample), int(full),
                            g_f.data_ptr(), g_pdf.data_ptr(), g_wo.data_ptr()) == 0
    return out


@pytest.mark.parametrize("sample", [False, True], ids=["eval", "sample"])
def test_k7t_device_code_matches_its_plain_version(lib, sample):
    """K7T's tail form (backward_common.cuh rgl_bwd_lane, its forward
    recomputed through rgl_common.cuh) against autograd through K7's plain
    forward, on grad_check.rgl_lanes' two stacked synthetic materials (4096
    lanes, some below the surface): rgb, ndf and sigma within REL of each
    table's largest entry. The lanes must reach every table."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    tables, mid, wi, wo, u2, g_f = gc.rgl_lanes("cpu", n=4096)
    x = u2 if sample else wo
    ref = bw.rgl_bwd_plain(tables, mid, wi, x, g_f, sample)
    out = _host_k7t(lib, tables, mid, wi, x, g_f, sample, False)
    for k in ("rgb", "ndf", "sigma"):
        assert bool((ref[k] != 0).any()), k
        _close(out[k], ref[k], f"{'sample' if sample else 'eval'} {k}")


@pytest.mark.parametrize("sample", [False, True], ids=["eval", "sample"])
def test_k7t_full_device_code_matches_its_plain_version_in_float64(lib, sample):
    """K7T's full form (rgl_bwd_lane<SAMPLE, true>: reverse mode through the
    whole of K7's eval or sample) on 4096 of grad_check.rgl_lanes' lanes with
    random cotangents of f*cos, the pdf and sample's wo, against its plain
    version in float64 (grad_check.rgl_full_reference): each table entry
    within grad_check.RGL_FULL_REL (1e-2) of its sum of |term| (float32 and
    float64 forwards part at the sample's searches and quadratic inversions;
    4.6e-3 seen), the lanes' wi (and eval's wo) cotangents within REL of the
    largest. Every table the plain version reaches is reached (phi_i: P = 1;
    eval reads neither luminance CDF)."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    tables, mid, wi, wo, u2, g_f = gc.rgl_lanes("cpu", n=4096)
    g_pdf, g_wo = gc.rgl_full_cotangents(4096, "cpu")
    x = u2 if sample else wo
    ref, mag = gc.rgl_full_reference(tables, mid, wi, x, g_f, sample, g_pdf,
                                     g_wo if sample else None)
    out = _host_k7t(lib, tables, mid, wi, x, g_f, sample, True, g_pdf, g_wo)
    unread = ("phi_i",) if sample else ("phi_i", "lum_marg", "lum_cond")
    for k, b in ref.items():
        a = out[k].double()
        assert bool(torch.isfinite(a).all()), k
        assert (float(b.abs().max()) > 0) == (k not in unread), k
        err = (a - b).abs()
        if k in ("wi", "wo"):
            scale = float(b.abs().max())
            assert float(err.max()) <= REL * scale, f"{k}: {float(err.max())} against {scale}"
        else:
            over = err > gc.RGL_FULL_REL * mag[k] + 1e-30
            assert not bool(over.any()), f"{k}: {int(over.sum())} entries beyond their sums"
