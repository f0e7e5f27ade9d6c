"""K3T's, K3aT's, K8T's, K7T's and P0T's device code
(``csrc/backward_common.cuh``: the backward of the hit assembly with the
winner's intersection, static and animated, of the sky's radiance lookup
with its rotation term and of its importance sample, of the measured RGL
BRDF, its tail form and its full form, and of the row gather) compiled with
g++ through ``tests/cuda_host`` and run on the CPU, held against their
plain versions (render/backward.py `assemble_hit_bwd_plain`,
`env_radiance_bwd_plain`, `env_sample_bwd_plain`, `row_scatter_plain`,
materials/rgl.py `rgl_bwd_plain`) on the same inputs. The kernels run
whole, as they launch (`tests/cuda_host/backward.cpp`): persistent blocks
of the kernels' threads, each lane's terms summed over its warp's lanes of
one row, texel cell or table cell (`group_sum`), then K3T's and K7T's per
block in shared memory where their tables fit the limit passed (the card's
by default, a large one forces it) and with global atomics where they do
not (a limit of 0), K8T's with atomics onto the map, P0T's into a copy of
the table per warp, the block's one copy or the table.

The host's libm computes atan2f, acosf and sqrtf, and the sums land in
another order than the plain version's, so floats are held to a tolerance
relative to each output's largest magnitude (1e-4), not to bits."""

import ctypes
import ctypes.util
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
# K3T's shared-memory limit in words passed to the host build: one that
# forces each path (below 0: the card's, HIT_SMEM_WORDS)
LIMITS = {"shared": 1 << 40, "global": 0}


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
    lib.host_assemble_hit_bwd.argtypes = sig["wpt_assemble_hit_bwd"][:-1] + [ctypes.c_longlong]
    lib.host_assemble_hit_anim_bwd.argtypes = (sig["wpt_assemble_hit_anim_bwd"][:-1]
                                               + [ctypes.c_longlong])
    lib.host_env_radiance_bwd.argtypes = sig["wpt_env_radiance_bwd"][:-1]
    lib.host_env_sample_bwd.argtypes = sig["wpt_env_sample_bwd"][:-1]
    lib.host_rgl_bwd.argtypes = sig["wpt_rgl_bwd"][:-1] + [ctypes.c_longlong]
    lib.host_row_scatter.argtypes = sig["wpt_row_scatter"][:-1] + [ctypes.c_longlong]
    return lib


def _close(got, ref, what):
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    assert torch.isfinite(got).all(), what
    assert err <= REL * scale + 1e-6, f"{what}: {err} against scale {scale}"


def _lanes(name):
    scene, camera = {"cornell": (scenes.cornell_box_ref, scenes.cornell_ref_camera),
                     "envmap": (scenes.envmap_spheres, scenes.envmap_camera),
                     "rtiow": (scenes.rtiow, scenes.rtiow_camera),
                     "floor": (scenes.sphere_lit_floor, scenes.sphere_lit_floor_camera)}[name]
    scene = scene(device="cpu")
    o, d, tmin, tmax = kc.camera_lanes(24, 24, 1, "cpu", camera=camera("cpu"))
    t, prim, u, v = closest_hit(build_brute_scene(scene), o, d, tmin, tmax)
    return build_hit_tables(scene), o, d, t, prim, u, v


def _check_k3t(lib, name, limit):
    """K3T's kernel on `name`'s lanes with random cotangents, the tables
    summed under the shared-memory `limit` in words (-1: the card's),
    against its plain version; returns the path taken (1 shared, 0 global)."""
    ht, o, d, t, prim, u, v = _lanes(name)
    backside = assemble_hit(ht, o, d, t, prim, u, v).backside
    gs = _cotangents(o.shape[0], 3)
    ref = bw.assemble_hit_bwd_plain(ht, o, d, t, prim, u, v, backside, *gs)
    out = [torch.zeros_like(x) for x in ref]
    ptr = lambda x: x.data_ptr()  # noqa: E731
    path = lib.host_assemble_hit_bwd(
        ptr(o), ptr(d), ptr(t), ptr(prim), ptr(u), ptr(v), ptr(backside), o.shape[0],
        ptr(ht.tri_g), ptr(ht.tri_f), ptr(ht.tri_i), ht.n_tris, ptr(ht.sph_f), ht.n_spheres,
        *map(ptr, gs), *map(ptr, out), limit)
    for what, a, b in zip(("g_o", "g_d", "g_tri_g", "g_tri_f", "g_sph_f"), out, ref):
        _close(a, b, f"{name} {what}")
    return path


@pytest.mark.parametrize("name", ["cornell", "envmap", "rtiow"])
def test_k3t_device_code_matches_its_plain_version(lib, name):
    """Triangle winners (the Cornell box, its ONB tangents), triangles and
    spheres (envmap_spheres), spheres alone (rtiow), with miss lanes; every
    cotangent random, uv's too; the tables summed in shared memory."""
    assert bool((_lanes(name)[4] < 0).any()) or name == "cornell"
    assert _check_k3t(lib, name, -1) == 1


@pytest.mark.parametrize("path", list(LIMITS))
@pytest.mark.parametrize("name", ["cornell", "floor", "envmap"])
def test_k3t_kernel_sums_on_both_paths(lib, name, path):
    """The whole kernel on each path: the block's tables in shared memory,
    or the warps' sums added to the tables with global atomics. The floor's
    lanes all win on its 2 triangles (groups of 32: every step of the
    shuffle tree), the Cornell box's on a few of its walls' triangles,
    envmap_spheres' on triangles and spheres mixed within warps."""
    if name == "floor":
        assert int((_lanes(name)[4] >= 0).sum()) == 24 * 24
    assert _check_k3t(lib, name, LIMITS[path]) == (path == "shared")


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
    """K3aT's kernel (assemble_hit_bwd_lanes<true, true>) against its plain
    version: the winners' object-space backward and the frame rows'
    cotangents, summed into [A, 30] at one instant (in shared memory beside
    the tables) or stored to each lane's own row."""
    _check_k3at(lib, spheres, per_ray, -1)


@pytest.mark.parametrize("per_ray", [False, True], ids=["one instant", "per ray"])
def test_k3at_kernel_sums_on_the_global_path(lib, per_ray):
    """K3aT on the animated box with spheres, its tables and rows of one
    instant summed by the warps and added with global atomics."""
    _check_k3at(lib, True, per_ray, LIMITS["global"])


def _check_k3at(lib, spheres, per_ray, limit):
    """K3aT's kernel on the animated box's lanes under the shared-memory
    `limit` in words (-1: the card's, under which its tables take the
    shared path) against its plain version."""
    ht, o, d, t, prim, u, v, fr = _anim_lanes(spheres, per_ray)
    assert bool((prim >= ht.n_tris).any()) == spheres
    backside = assemble_hit(ht, o, d, t, prim, u, v, fr).backside
    gs = _cotangents(o.shape[0], 4)
    ref = bw.assemble_hit_bwd_plain(ht, o, d, t, prim, u, v, backside, *gs, frames=fr)
    out = [torch.zeros_like(x) for x in ref]
    ptr = lambda x: x.data_ptr()  # noqa: E731
    stride = check_frames(fr, ht.n_anims, o.device, o.shape[0])
    assert stride == (ht.n_anims * 30 if per_ray else 0)
    assert lib.host_assemble_hit_anim_bwd(
        ptr(o), ptr(d), ptr(t), ptr(prim), ptr(u), ptr(v), ptr(backside), o.shape[0],
        ptr(ht.tri_g), ptr(ht.tri_f), ptr(ht.tri_i), ht.n_tris, ptr(ht.sph_f), ht.n_spheres,
        *map(ptr, gs), *map(ptr, out[:5]), ptr(ht.tri_anim), ptr(ht.sph_anim), ptr(fr), stride,
        ht.n_anims, ptr(out[5]), limit) == (limit != 0)
    for what, a, b in zip(("g_o", "g_d", "g_tri_g", "g_tri_f", "g_sph_f", "g_frames"), out, ref):
        _close(a, b, f"{what}")
    assert float(ref[5].abs().sum()) > 0


def _host_k8t(lib, env, d, g, rotation=True, active=None):
    """(g_d, g_image, g_rotation, g_const) of the host build of K8T's
    kernel, its rotation term where `rotation`, under the lane mask
    `active` where given."""
    g_d = torch.full_like(d, float("nan"))
    g_img, g_rot, g_const = torch.zeros_like(env.image), torch.zeros(4), torch.zeros(4)
    h, w = env.image.shape[-3], env.image.shape[-2]
    assert lib.host_env_radiance_bwd(d.data_ptr(), d.shape[0], env.kind, env.image.data_ptr(),
                                     h, w, env.rotation.data_ptr(), g.data_ptr(),
                                     None if active is None else active.data_ptr(),
                                     g_d.data_ptr(), g_img.data_ptr(), g_const.data_ptr(),
                                     g_rot.data_ptr() if rotation else None) == 0
    return g_d, g_img, g_rot, g_const


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
    g_d, g_img, g_rot, _ = _host_k8t(lib, env, d, g)
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
    g_d, g_img, g_rot, _ = _host_k8t(lib, env, d, g)
    _close(g_d, ref[0], "rotated cube g_d")
    _close(g_img, ref[1], "rotated cube g_image")
    _sums_close(g_rot, ref[3], ref[6], "rotated cube g_rotation")


def _sky_block(env, seed, escaping=False):
    """K8T's lanes as a render gives them: 48 x 48 camera directions of the
    envmap frame (a warp's neighbouring pixels share lookup cells) and 1792
    random ones, every seventh lane's cotangent zero (a lane that adds
    nothing, in a warp with lanes that do); `escaping`: only the lanes that
    look up (y > 0.2) keep one, as if the rest had hit a floor, so that
    whole warps and runs of lanes within one add nothing."""
    cam = scenes.envmap_camera("cpu")
    d = torch.cat([kc.camera_lanes(48, 48, 1, "cpu", camera=cam)[1], _sky_dirs(1792 - 11, seed)])
    g = torch.randn(d.shape[0], 4, generator=torch.Generator().manual_seed(seed + 1))
    g[::7] = 0.0
    if escaping:
        g[d[:, 1] <= 0.2] = 0.0
    return d.contiguous(), g


@pytest.mark.parametrize("escaping", [False, True], ids=["every lane", "escaping lanes"])
@pytest.mark.parametrize("rotated", [False, True], ids=["identity", "rotated"])
@pytest.mark.parametrize("kind", ["equirect", "cube"])
def test_k8t_kernel_sums_warp_groups(lib, kind, rotated, escaping):
    """The whole kernel with and without its rotation term, each warp's
    lanes of one lookup cell summed before one float4 atomic a texel, on
    cotangents on every lane or only on the escaping ones: the texels
    within REL of the largest, the rotation's sums within REL of its terms'
    magnitudes, and with the term off g_rotation untouched."""
    from test_torch_backward_kernels import _sky

    env = _sky(kind, rotated)
    d, g = _sky_block(env, 9, escaping)
    ref = bw.env_radiance_bwd_plain(env, d, g, magnitudes=True)
    g_d, g_img, g_rot, g_const = _host_k8t(lib, env, d, g, rotation=rotated)
    _close(g_d, ref[0], f"{kind} g_d")
    _close(g_img, ref[1], f"{kind} g_image")
    assert not bool(g_const.any())
    if rotated:
        _sums_close(g_rot, ref[3], ref[6], f"{kind} g_rotation")
    else:
        assert not bool(g_rot.any())


@pytest.mark.parametrize("height", [4, 8], ids=["4x8", "8x16"])
def test_k8t_kernel_on_low_resolution_skies(lib, height):
    """8192 lanes on a 4 x 8 sky (256 lanes a texel) and an 8 x 16 one (64):
    most of a warp's lanes share a lookup cell, so its groups run every step
    of the shuffle tree; within REL of the plain version."""
    from wurblpt_tpu_torch.render.envmap import EnvironmentMapEquiRect, build_envmap_arrays

    env = build_envmap_arrays(EnvironmentMapEquiRect(scenes.procedural_sky(height)), "cpu")
    d = torch.cat([_sky_block(env, 13)[0]] * 2).contiguous()
    g = torch.randn(d.shape[0], 4, generator=torch.Generator().manual_seed(14))
    ref = bw.env_radiance_bwd_plain(env, d, g, magnitudes=True)
    g_d, g_img, g_rot, _ = _host_k8t(lib, env, d, g)
    _close(g_d, ref[0], f"{height} g_d")
    _close(g_img, ref[1], f"{height} g_image")
    _sums_close(g_rot, ref[3], ref[6], f"{height} g_rotation")


def _libm_differs(dm):
    """Per lane, whether the C library's atan2f(x, -z) or acosf(y), which
    the host build calls, differs from PyTorch's torch.atan2 / torch.acos on
    the CPU, which the plain version calls, for map directions dm [N, 3]."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.atan2f.restype = libm.acosf.restype = ctypes.c_float
    libm.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
    libm.acosf.argtypes = [ctypes.c_float]
    x, y, z = dm[:, 0], dm[:, 1], dm[:, 2]
    a = torch.tensor([libm.atan2f(p, -r) for p, r in zip(x.tolist(), z.tolist())])
    c = torch.tensor([libm.acosf(q) for q in torch.clamp(y, -1.0, 1.0).tolist()])
    return (a != torch.atan2(x, -z)) | (c != torch.acos(torch.clamp(y, -1.0, 1.0)))


@pytest.mark.parametrize("rotated", [False, True], ids=["identity", "rotated"])
def test_k8t_kernel_on_a_wide_sky(lib, rotated):
    """The 512 x 1024 sky of the card's check (`grad_check.sky_lanes(kind=
    "large")`) on 8192 of its lanes, against the plain version on the CPU.
    Where a lane's atan2f or acosf from the C library differs from
    PyTorch's by an ulp, its x = u w moves by ~w ulps of u, which a tap of
    small weight feels a thousandfold: the texels of such lanes' taps may
    part by more than SKY_SUM_REL of their magnitudes. Every other texel
    holds to SKY_SUM_REL, and those lanes are a few per cent."""
    from wurblpt_tpu_torch.core.transform import quat_rotate
    from wurblpt_tpu_torch.render import envmap as E
    from wurblpt_tpu_torch.utils import grad_check as gc

    env, d, g = gc.sky_lanes("cpu", cube=False, kind="large", rotated=rotated)
    sel = torch.cat([torch.arange(0, 131072, 32), 131072 + torch.arange(4096)])
    d, g = d[sel].contiguous(), g[sel].contiguous()
    ref = bw.env_radiance_bwd_plain(env, d, g, magnitudes=True)
    g_d, g_img, g_rot, _ = _host_k8t(lib, env, d, g, rotation=rotated)
    _close(g_d, ref[0], "wide sky g_d")
    if rotated:
        _sums_close(g_rot, ref[3], ref[6], "wide sky g_rotation")
    dm = quat_rotate(E.quat_conjugate(env.rotation), d)
    off = _libm_differs(dm)
    assert 0 < int(off.sum()) < 0.05 * d.shape[0]
    h, w = env.image.shape[0], env.image.shape[1]
    u, v = E._equirect_uv(dm)
    x0, y0 = torch.floor(u * w - 0.5).long() % w, torch.floor(v * h - 0.5).long().clamp(0, h - 1)
    x1, y1 = (x0 + 1) % w, (y0 + 1).clamp(max=h - 1)
    exempt = torch.zeros(h * w, dtype=torch.bool)
    for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)):
        exempt[(yy * w + xx)[off]] = True
    keep = ~exempt.view(h, w)
    gc._sum_close("wide sky g_image", g_img[keep], ref[1][keep], ref[4][keep], gc.SKY_SUM_REL)


@pytest.mark.parametrize("rotated", [False, True], ids=["identity", "rotated"])
def test_k8t_kernel_on_a_constant_sky(lib, rotated):
    """A constant sky: g_d zero on every lane, the radiance's cotangent the
    lanes' sum (per thread, then per block) within REL of its terms'
    magnitudes, the rotation's cotangent untouched."""
    from test_torch_backward_kernels import _sky

    env = _sky("constant", rotated)
    d, g = _sky_block(env, 11)
    ref = bw.env_radiance_bwd_plain(env, d, g, magnitudes=True)
    g_d, g_img, g_rot, g_const = _host_k8t(lib, env, d, g, rotation=rotated)
    assert not bool(g_d.any()) and not bool(g_img.any()) and not bool(g_rot.any())
    _sums_close(g_const, ref[2], ref[5], "constant g_const")


@pytest.mark.parametrize("kind", ["equirect", "cube", "constant"])
def test_k8t_kernel_under_a_lane_mask(lib, kind):
    """K8T with its rotation term under a lane mask (30 % of the lanes):
    the lanes outside it carry no cotangent, whatever theirs (random here),
    and get g_d = 0; the texels', the constant's and the rotation's sums
    those of the plain version on the cotangents zeroed outside the mask."""
    from test_torch_backward_kernels import _sky

    env = _sky(kind, True)
    d, g = _sky_block(env, 15)
    active = torch.rand(d.shape[0], generator=torch.Generator().manual_seed(16)) < 0.3
    ref = bw.env_radiance_bwd_plain(env, d, torch.where(active[:, None], g, 0.0),
                                    magnitudes=True)
    g_d, g_img, g_rot, g_const = _host_k8t(lib, env, d, g, rotation=kind != "constant",
                                           active=active)
    assert not bool(g_d[~active].any())
    _close(g_d[active], ref[0][active], f"{kind} masked g_d")
    if kind == "constant":
        _sums_close(g_const, ref[2], ref[5], "masked g_const")
    else:
        _close(g_img, ref[1], f"{kind} masked g_image")
        _sums_close(g_rot, ref[3], ref[6], f"{kind} masked g_rotation")


def _host_k8t_sample(lib, env, u3, g_dir, active=None):
    """g_rot of the host build of K8T's sample backward under the lane mask
    `active` where given (its partials NaN before the launch, its output
    too: the last block writes it), and the count of finished blocks left
    at 0."""
    g_rot, partial = torch.full((4,), float("nan")), torch.full((64, 4), float("nan"))
    done = torch.zeros(1, dtype=torch.int32)
    assert lib.host_env_sample_bwd(u3.data_ptr(), u3.shape[0], env.pdf_table.data_ptr(),
                                   env.alias_prob.data_ptr(), env.alias_idx.data_ptr(),
                                   env.pdf_table.shape[0], env.rotation.data_ptr(),
                                   g_dir.data_ptr(),
                                   None if active is None else active.data_ptr(),
                                   partial.data_ptr(), partial.shape[0], done.data_ptr(),
                                   g_rot.data_ptr()) == 0
    assert int(done) == 0
    return g_rot


def test_k8t_sample_device_code_matches_its_plain_version(lib):
    """K8T's sample backward (env_sample_bwd_lanes: persistent blocks, each
    lane's map-space direction from envmap_common.cuh sample_map and the
    rotation formula's backward, summed per thread and per block, the last
    block summing the blocks' partials) on envmap_spheres' rotated
    equirect sky, every lane carrying a cotangent."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    env, u3, g_dir = gc.env_sample_lanes("cpu", n=8192)
    ref, mag = bw.env_sample_bwd_plain(env, u3, g_dir, magnitudes=True)
    _sums_close(_host_k8t_sample(lib, env, u3, g_dir), ref, mag, "sample g_rotation")


@pytest.mark.parametrize("masked", [False, True], ids=["zero cotangents", "lane mask"])
@pytest.mark.parametrize("live", [0.09, 0.0], ids=["sparse", "no lane"])
def test_k8t_sample_kernel_skips_lanes_without_a_cotangent(lib, live, masked):
    """The same on a render's sparse cotangents (9 % of the lanes live,
    scattered, as the sky-yaw step's first bounce sends them; the other
    lanes' uniforms NaN, which a skipped lane never reads) and on lanes
    that all carry none (the rotation's cotangent stays 0); the other
    lanes either carry zero cotangents or lie outside the lane mask (their
    cotangents random, unread)."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    env, u3, g_dir = gc.env_sample_lanes("cpu", n=8192)
    keep = torch.rand(u3.shape[0], generator=torch.Generator().manual_seed(25)) < live
    g_live = torch.where(keep[:, None], g_dir, 0.0)
    ref, mag = bw.env_sample_bwd_plain(env, u3, g_live, magnitudes=True)
    got = _host_k8t_sample(lib, env, torch.where(keep[:, None], u3, float("nan")),
                           g_dir if masked else g_live, keep if masked else None)
    if live:
        assert int(keep.sum()) > 0
        _sums_close(got, ref, mag, "sparse sample g_rotation")
    else:
        assert not bool(got.any())


def _host_k7t(lib, tables, mid, wi, x, g_f, sample, full, g_pdf=None, g_wo=None, limit=-1,
              path=None):
    """The host build of K7T's kernel (wpt_rgl_bwd's arguments, the tables
    summed under the shared-memory `limit` in words, -1 the card's): a dict
    of cotangents, the tail form's or the full form's. `path`: the path it
    must take ("shared" or "global")."""
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
    shared = lib.host_rgl_bwd(ctypes.addressof(ct), ctypes.addressof(co), mid.data_ptr(),
                              wi.data_ptr(), x.data_ptr(), n, int(sample), int(full),
                              g_f.data_ptr(), g_pdf.data_ptr(), g_wo.data_ptr(), limit)
    assert path is None or shared == (path == "shared"), f"K7T took the other path than {path}"
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


# ---------------------------------------------------------------------------
# K7T's and P0T's whole kernels on both paths (warp groups, block copies)
# ---------------------------------------------------------------------------

def _k7t_inputs(kind, sample, n=2048):
    """K7T's lanes of `kind`: "random" (grad_check.rgl_lanes' directions,
    the least coherent), "one cell" (every lane one material, wi, wo and
    u2: every warp one group on every cell) or "large" (the random lanes
    on a stack of grad_check.RGL_STACK_GLOBAL materials: tables past the
    shared memory in both forms). (tables, mid, wi, x, g_f, g_pdf, g_wo)."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    tables, mid, wi, wo, u2, g_f = gc.rgl_lanes(
        "cpu", n=n, stacked=gc.RGL_STACK_GLOBAL if kind == "large" else 2)
    g_pdf, g_wo = gc.rgl_full_cotangents(n, "cpu")
    if kind == "one cell":
        mid = torch.zeros_like(mid)
        wi, wo, u2 = (a[:1].expand_as(a).contiguous() for a in (wi, wo, u2))
        assert float(wi[0, 2]) > 0 and float(wo[0, 2]) > 0
    return tables, mid, wi, u2 if sample else wo, g_f, g_pdf, g_wo if sample else None


def _check_k7t_kernel(lib, kind, sample, full, path):
    """K7T's kernel on _k7t_inputs' lanes under the limit that takes `path`
    (the card's where the tables fit or not) against its plain version: the
    tail form within REL of each table's largest entry, the full form within
    grad_check.RGL_FULL_REL of each entry's sum of |term| (float64)."""
    from wurblpt_tpu_torch.materials.rgl import TAIL_TABLES
    from wurblpt_tpu_torch.utils import grad_check as gc

    tables, mid, wi, x, g_f, g_pdf, g_wo = _k7t_inputs(kind, sample)
    limit = -1 if kind == "large" else LIMITS[path]
    out = _host_k7t(lib, tables, mid, wi, x, g_f, sample, full, g_pdf, g_wo, limit, path)
    if not full:
        ref = bw.rgl_bwd_plain(tables, mid, wi, x, g_f, sample)
        for k in TAIL_TABLES:
            assert bool((ref[k] != 0).any()), k
            _close(out[k], ref[k], f"{kind} {k}")
        return
    ref, mag = gc.rgl_full_reference(tables, mid, wi, x, g_f, sample, g_pdf, g_wo)
    for k, b in ref.items():
        a = out[k].double()
        assert bool(torch.isfinite(a).all()), k
        err = (a - b).abs()
        if k in ("wi", "wo"):
            assert float(err.max()) <= REL * float(b.abs().max()), k
        else:
            over = err > gc.RGL_FULL_REL * mag[k] + 1e-30
            assert not bool(over.any()), f"{kind} {k}: {int(over.sum())} entries beyond"


@pytest.mark.parametrize("path", list(LIMITS))
@pytest.mark.parametrize("kind", ["random", "one cell"])
@pytest.mark.parametrize("full", [False, True], ids=["tail", "full"])
@pytest.mark.parametrize("sample", [False, True], ids=["eval", "sample"])
def test_k7t_kernel_sums_on_both_paths(lib, sample, full, kind, path):
    """K7T's whole kernel (rgl_bwd_lanes<SAMPLE, FULL, SHARED>), each form
    on each path: the form's tables in the block's copy in shared memory or
    the warps' sums added with global atomics; on random lanes (few groups
    of more than one lane) and on lanes of one cell (every warp one group:
    every step of the shuffle tree)."""
    _check_k7t_kernel(lib, "random" if kind == "random" else "one cell", sample, full, path)


@pytest.mark.parametrize("full", [False, True], ids=["tail", "full"])
@pytest.mark.parametrize("sample", [False, True], ids=["eval", "sample"])
def test_k7t_kernel_on_tables_past_the_shared_limit(lib, sample, full):
    """The random lanes on a stack of grad_check.RGL_STACK_GLOBAL synthetic
    materials: under the card's limit the form's tables do not fit the
    block's shared memory, and the kernel takes its global path by its own
    rule."""
    _check_k7t_kernel(lib, "large", sample, full, "global")


def _p0t_inputs(kind, seed=3):
    """P0T's (g [N, C], idx [N], rows) of `kind`: "material rows" (grad_check.
    cornell_lanes' material rows of the Cornell block, 4096 of its lanes),
    "one row" (every lane the same row: every warp one group), "random" (a
    random row per lane of 16 x 23, zero rows and out-of-range indices
    among them: clamped) or "large" (1024 x 23 words, past the shared
    limit)."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    gen = torch.Generator().manual_seed(seed)
    if kind == "material rows":
        lanes = gc.cornell_lanes("cpu")
        return (lanes["g_rows"][:4096].contiguous(), lanes["mat"][:4096].contiguous(),
                lanes["mat_table"].shape[0])
    rows = {"one row": 5, "random": 16, "large": 1024}[kind]
    n = 4096
    g = torch.randn(n, 23, generator=gen)
    g[torch.rand(n, generator=gen) < 0.3] = 0.0
    g[:, 5] = 0.0
    if kind == "one row":
        idx = torch.full((n,), 3, dtype=torch.int32)
    else:
        idx = torch.randint(-2, rows + 2, (n,), generator=gen, dtype=torch.int32)
    return g, idx, rows


SCATTER_LIMITS = {"warp copies": -1, "block copy": 1 << 40, "global": 0}


@pytest.mark.parametrize("path", list(SCATTER_LIMITS))
@pytest.mark.parametrize("kind", ["material rows", "one row", "random", "large"])
def test_p0t_kernel_sums_on_every_path(lib, kind, path):
    """P0T's whole kernel (row_scatter_lanes<COPIES>) against its plain
    version, within REL of the table's largest entry: each warp's groups of
    one row summed into its own copy of the table in shared memory (the
    card's limit on a table that fits 8 copies), the block's one copy (a
    limit that one copy fits and 8 do not), or the table itself with
    global atomics (limit 0); a table past the card's limit takes the global
    path by the kernel's own rule."""
    g, idx, rows = _p0t_inputs(kind)
    cols = g.shape[1]
    limit = SCATTER_LIMITS[path]
    if path == "block copy":
        limit = rows * cols   # one copy fits, 8 do not
    ref = bw.row_scatter_plain(g, idx, rows)
    out = torch.zeros_like(ref)
    copies = lib.host_row_scatter(g.data_ptr(), idx.data_ptr(), g.shape[0], cols, rows,
                                  out.data_ptr(), limit)
    expect = {"warp copies": 8, "block copy": 1, "global": 0}[path]
    if kind == "large" and path == "warp copies":
        expect = 0   # past the card's limit
    assert copies == expect
    assert bool((ref != 0).any())
    _close(out, ref, f"{kind} {path}")
