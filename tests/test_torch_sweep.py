"""The brute-force sweeps KS1/KS2 (``render/intersect_sweep.py``) and the
animated hit assembly K3a (``render/intersect.py``), and the brute-force
route of ROADMAP C.1.

* The plain sweeps against the JAX package's `_closest_tris`,
  `_closest_spheres`, `_any_tris` and `_any_spheres` on random scenes built
  by its builder, static and with object-space rays (three random keyframe
  animations over triangles and spheres). XLA on the CPU contracts the
  crosses and dots of `ray_tri_tile` and the einsums of `ray_to_object`
  into fused multiply-adds (ROADMAP C.4), so: prim ids and the occlusion
  bit equal except on grazing lanes (a runner-up within 1e-4 relative of
  the winner's t, or the winner's barycentrics within 1e-4 of an edge; none
  occur on these seeds), t within rtol 1e-4, u and v within 1e-4.
* The plain K3 / K3a against `assemble_hit(anim_ctx=...)` on the winners of
  the same cast: integer fields equal, the world-space frame within 1e-4.
* The kernels' device code (``csrc/sweep_*.cu``, ``csrc/assemble_hit.cu``)
  compiled with g++ through ``tests/cuda_host`` and run on the CPU, held
  against the plain versions: prim ids, the occlusion bit and the hit's
  integer fields equal, floats within 2 ulp-sized margins (t, u, v rtol
  1e-6; the hit's vectors atol 1e-6). Not bits: PyTorch's CPU sqrt (its
  AVX-512 kernel here) is not correctly rounded on ~0.6 % of inputs, the
  host's sqrtf and the card's are, and the sphere uv's atan2f/asinf are the
  host's libm. On the card kernel and plain version agree bit for bit
  (tests/test_torch_kernels.py).
* C.1's two example scenes, built by the JAX package with use_bvh=False and
  by the port: 3000 spheres (the K1 form, 6144 columns) and 2000 triangles
  with 40 spheres (8448 columns: the sweeps). Each is cast and rendered
  through the route the JAX package takes.
"""

import ctypes
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
from wurblpt_tpu import CameraConfig as JCameraConfig  # noqa: E402
from wurblpt_tpu import RenderParams as JRenderParams  # noqa: E402
from wurblpt_tpu import SceneStatic as JSceneStatic  # noqa: E402
from wurblpt_tpu import SensorRGB as JSensorRGB  # noqa: E402
from wurblpt_tpu import make_camera as jmake_camera  # noqa: E402
from wurblpt_tpu.core.transform import Transformation as JT  # noqa: E402
from wurblpt_tpu.render import intersect as JI  # noqa: E402
from wurblpt_tpu.render.integrator import render_frame_wavefront as jrender  # noqa: E402
from wurblpt_tpu.render.intersect_mxu import build_mxu_scene, mxu_closest_hit  # noqa: E402
from wurblpt_tpu.scene import builder as B  # noqa: E402
from wurblpt_tpu.scene.animation import make_anim_ctx as jmake_anim_ctx  # noqa: E402
from wurblpt_tpu_torch import (  # noqa: E402
    CameraConfig,
    RenderParams,
    SceneStatic,
    SensorRGB,
    make_camera,
    native,
    render_frame_wavefront,
    scene_from_numpy,
)
from wurblpt_tpu_torch.native import SRC_DIR  # noqa: E402
from wurblpt_tpu_torch.render import intersect, intersect_brute  # noqa: E402
from wurblpt_tpu_torch.render import intersect_sweep as sw  # noqa: E402
from wurblpt_tpu_torch.render.integrator import prepare_scene  # noqa: E402
from wurblpt_tpu_torch.utils import kernel_check as kc  # noqa: E402
from wurblpt_tpu_torch.utils import scenes  # noqa: E402

torch.set_num_threads(2)

HOST = Path(__file__).parent / "cuda_host"
TIME = 0.37


def _port(js):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")


def _unit(q):
    return (q / np.linalg.norm(q)).astype(np.float32)


def _random_scene(seed, animated, n_tri=240, n_sph=40):
    """Four meshes of random small triangles and `n_sph` spheres; with
    `animated`, three random keyframe animations shared round robin (row 0,
    static, among them)."""
    rs = np.random.RandomState(seed)
    sc = B.Scene()
    m = sc.take_material(B.Lambertian(albedo=(0.5, 0.5, 0.5)))
    ids = [None]
    if animated:
        for _ in range(3):
            k = rs.randint(2, 4)
            ids.append(sc.take_animation(B.AnimationKeyframes(
                sorted(rs.uniform(0, 1, k).tolist()),
                [JT.make(rs.uniform(-0.5, 0.5, 3), _unit(rs.normal(size=4)),
                         rs.uniform(0.6, 1.5, 3)) for _ in range(k)])))
    per = n_tri // 4
    for i in range(4):
        pos = (rs.uniform(-2, 2, (per, 1, 3)) + rs.uniform(-0.4, 0.4, (per, 3, 3)))
        mesh = B.Mesh(pos.reshape(-1, 3).astype(np.float32), None, None,
                      indices=np.arange(3 * per, dtype=np.int32).reshape(-1, 3))
        sc.take_mesh_instance(B.MeshInstance(mesh, m, animation=ids[i % len(ids)]))
    for j in range(n_sph):
        sc.take_sphere(B.SphereObject(tuple(rs.uniform(-2, 2, 3)), float(rs.uniform(0.05, 0.4)),
                                      m, animation=ids[j % len(ids)]))
    return sc.build(use_bvh=False)


def _rays(n, seed):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.where(rs.uniform(size=n) < 0.3, rs.uniform(0.1, 4, n), kc.BIG)
    t_max = np.where(rs.uniform(size=n) < 0.1, 0.0, t_max).astype(np.float32)
    return o, d, np.full(n, kc.MIN_HIT, np.float32), t_max


def _jax_cast(js, rays, ctx):
    o, d, t_min, t_max = (jnp.asarray(x) for x in rays)
    n = o.shape[0]
    obj = None if ctx is None else ctx.ray_to_object(o, d)
    best = (jnp.full((n,), JI.BIG), jnp.full((n,), -1, jnp.int32), jnp.zeros(n), jnp.zeros(n))
    best = JI._closest_tris(o, d, js.tris, t_min, t_max, best, obj_rays=obj)
    best = JI._closest_spheres(o, d, js, t_min, t_max, best, obj_rays=obj)
    occ = (JI._any_tris(o, d, js.tris, t_min, t_max, obj_rays=obj)
           | JI._any_spheres(o, d, js, t_min, t_max, obj_rays=obj))
    return tuple(np.asarray(x) for x in best), np.asarray(occ)


def _grazing(ss, rays, frames, prim, u, v):
    """Lanes whose winner is not clear: a runner-up within 1e-4 relative of
    its t, or barycentrics within 1e-4 of the triangle's edges."""
    o, d, t_min, t_max = (torch.as_tensor(x) for x in rays)
    obj = sw._object_rays(ss, o, d, frames)
    oi, di = sw._rays_of(o, d, obj, ss.tri_anim)
    t, uu, vv, valid = sw.ray_tri_tile(oi, di, ss.tri[:, 0:3], ss.tri[:, 4:7], ss.tri[:, 8:11],
                                       t_min, torch.full_like(t_max, kc.BIG))
    edge = ((uu.abs() < 1e-4) | (vv.abs() < 1e-4) | ((1 - uu - vv).abs() < 1e-4)) & (
        t > t_min[:, None])
    oi, di = sw._rays_of(o, d, obj, ss.sph_anim)
    ts, vs = sw.ray_sphere_tile(oi, di, ss.sph[:, 0:3], ss.sph[:, 3], t_min,
                                torch.full_like(t_max, kc.BIG))
    cand = torch.cat([torch.where(valid, t, kc.BIG), ts], 1)
    c = torch.sort(cand, 1).values
    tie = (c[:, 1] - c[:, 0] <= 1e-4 * c[:, 0].abs()) & (c[:, 0] < kc.BIG)
    near_tmax = ((c[:, 0] - t_max).abs() <= 1e-4 * t_max.abs())
    return (tie | edge.any(1) | near_tmax).numpy()


@pytest.mark.parametrize("animated", [False, True])
def test_plain_sweeps_match_the_jax_sweeps(animated):
    js = _random_scene(3, animated)
    ps = _port(js)
    ss = sw.build_sweep_scene(ps)
    assert ss.n_anims == (4 if animated else 1)
    rays = _rays(3000, 5)
    ctx = (jmake_anim_ctx(js.anims, jnp.full((3000,), jnp.float32(TIME))) if animated
           else None)
    frames = kc.frames_at(ps, TIME) if animated else None
    (jt, jp, ju, jv), jocc = _jax_cast(js, rays, ctx)
    T = [torch.as_tensor(x) for x in rays]
    pt, pp, pu, pv = (x.numpy() for x in sw.closest_sweep_plain(ss, *T, frames))
    pocc = sw.any_sweep_plain(ss, *T, frames).numpy()
    graze = _grazing(ss, rays, frames, pp, pu, pv)
    assert ((pp != jp) & ~graze).sum() == 0
    assert ((pocc != jocc) & ~graze).sum() == 0
    hit = (pp == jp) & (pp >= 0)
    assert hit.sum() > 500 and (pp >= ss.n_tris).sum() > 20 and 0 < pocc.sum() < len(pocc)
    np.testing.assert_allclose(pt[hit], jt[hit], rtol=1e-4)
    for a, b in ((pu, ju), (pv, jv)):
        np.testing.assert_allclose(a[hit], b[hit], rtol=0, atol=1e-4)
    # The wrapper on CPU tensors is the plain version, and launches nothing.
    counts = dict(native.LAUNCHES)
    for a, b in zip(sw.closest_sweep(ss, *T, frames), sw.closest_sweep_plain(ss, *T, frames)):
        assert torch.equal(a, b)
    assert torch.equal(sw.any_sweep(ss, *T, frames), sw.any_sweep_plain(ss, *T, frames))
    assert native.LAUNCHES == counts


@pytest.mark.parametrize("which", ["cornell_animated with spheres", "random animated"])
def test_plain_assembly_matches_jax_assemble_hit(which):
    js = (jfr.jax_cornell_animated(spheres=True) if which.startswith("cornell")
          else _random_scene(4, True))
    ps = _port(js)
    ss, ht = sw.build_sweep_scene(ps), intersect.build_hit_tables(ps)
    frames = kc.frames_at(ps, TIME)
    if which.startswith("cornell"):
        o, d, t_min, t_max = kc.camera_lanes(32, 32, 2, "cpu")
    else:
        o, d, t_min, t_max = (torch.as_tensor(x) for x in _rays(2000, 6))
    t, prim, u, v = sw.closest_sweep_plain(ss, o, d, t_min, t_max, frames)
    ours = intersect.assemble_hit_plain(ht, o, d, t, prim, u, v, frames)
    n = o.shape[0]
    ctx = jmake_anim_ctx(js.anims, jnp.full((n,), jnp.float32(TIME)))
    ref = JI.assemble_hit(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                          jnp.asarray(t.numpy()), jnp.asarray(prim.numpy()),
                          jnp.asarray(u.numpy()), jnp.asarray(v.numpy()), anim_ctx=ctx)
    h = ours.hit.numpy()
    assert h.sum() > 0.1 * n and (prim.numpy()[h] >= ps.n_tris).sum() > 10
    for f in ("hit", "prim", "mat", "backside"):
        np.testing.assert_array_equal(getattr(ours, f).numpy()[h], np.asarray(getattr(ref, f))[h])
    for f in ("position", "normal", "geom_normal", "tangent", "uv"):
        np.testing.assert_allclose(getattr(ours, f).numpy()[h], np.asarray(getattr(ref, f))[h],
                                   rtol=0, atol=1e-4, err_msg=f)
    # the wrapper on CPU tensors is the plain version
    for a, b in zip(intersect.assemble_hit(ht, o, d, t, prim, u, v, frames), ours):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The kernels' device code built with g++ (tests/cuda_host/sweep.cpp):
    the sweeps in one library, K3/K3a in another."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("sweep")
    for name in ("sweep_closest", "sweep_any", "assemble_hit"):
        src = (SRC_DIR / f"{name}.cu").read_text()
        (out / f"{name}_device.cuh").write_text(src[:src.index('extern "C"')])
    libs = {}
    for key, flags in (("sweep", []), ("k3", ["-DK3A"])):
        lib = out / f"lib{key}.so"
        subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                        "-pthread", *flags, f"-I{out}", f"-I{HOST}", f"-I{SRC_DIR}", "-o",
                        str(lib), str(HOST / "sweep.cpp")], check=True)
        libs[key] = ctypes.CDLL(str(lib))
    sig = native._SIGNATURES
    libs["sweep"].host_sweep_closest.argtypes = sig["wpt_sweep_closest"][:-1]
    libs["sweep"].host_sweep_any.argtypes = sig["wpt_sweep_any"][:-1]
    libs["k3"].host_assemble_hit_anim.argtypes = sig["wpt_assemble_hit_anim"][:-1]
    return libs


def _ptr(x):
    return 0 if x is None else x.data_ptr()


@pytest.mark.parametrize("scene, frames", [("cornell_animated", True), ("animated spheres", True),
                                           ("animated spheres", False), ("tri_sphere_field", False)])
@pytest.mark.parametrize("kind", ["camera", "random"])
def test_device_code_on_the_host_matches_the_plain_versions(host, scene, frames, kind):
    sc = {"cornell_animated": lambda: scenes.cornell_box_animated("cpu"),
          "animated spheres": lambda: scenes.cornell_box_animated("cpu", spheres=True),
          "tri_sphere_field": lambda: scenes.tri_sphere_field(device="cpu")}[scene]()
    ss, ht = sw.build_sweep_scene(sc), intersect.build_hit_tables(sc)
    fr = kc.frames_at(sc) if frames else None
    camera = scenes.field_camera("cpu") if scene == "tri_sphere_field" else None
    if kind == "camera":
        rays = kc.camera_lanes(32, 24, 1, "cpu", camera=camera)
    else:
        rays = (kc.random_lanes(1000, "cpu") if camera is None else
                kc.random_lanes(1000, "cpu", lo=(-10.0, 0.0, -10.0), hi=(10.0, 2.0, 10.0)))
    n = rays[0].shape[0]
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    prim = torch.empty(n, dtype=torch.int32)
    occ = torch.empty(n, dtype=torch.bool)
    common = (*(x.data_ptr() for x in rays), n, ss.tri.data_ptr(), ss.tri_anim.data_ptr(),
              ss.n_tris, ss.sph.data_ptr(), ss.sph_anim.data_ptr(), ss.n_spheres, _ptr(fr))
    host["sweep"].host_sweep_closest(*common, t.data_ptr(), prim.data_ptr(), u.data_ptr(),
                                     v.data_ptr())
    host["sweep"].host_sweep_any(*common, occ.data_ptr())
    pt, pp, pu, pv = sw.closest_sweep_plain(ss, *rays, fr)
    assert torch.equal(prim, pp) and torch.equal(occ, sw.any_sweep_plain(ss, *rays, fr))
    for a, b in ((t, pt), (u, pu), (v, pv)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert (pp >= 0).sum() > 0.05 * n
    out = [torch.empty(n, 3) for _ in range(4)] + [torch.empty(n, 2),
                                                   torch.empty(n, dtype=torch.int32),
                                                   torch.empty(n, dtype=torch.bool)]
    o, d = rays[0], rays[1]
    host["k3"].host_assemble_hit_anim(
        o.data_ptr(), d.data_ptr(), pt.data_ptr(), pp.data_ptr(), pu.data_ptr(), pv.data_ptr(),
        n, ht.tri_f.data_ptr(), ht.tri_i.data_ptr(), ht.n_tris, ht.sph_f.data_ptr(),
        ht.sph_mat.data_ptr(), ht.n_spheres, ht.tri_anim.data_ptr(), ht.sph_anim.data_ptr(),
        _ptr(fr), *(x.data_ptr() for x in out))
    ref = intersect.assemble_hit_plain(ht, o, d, pt, pp, pu, pv, fr)
    h = ref.hit
    for f, got in zip(("position", "normal", "geom_normal", "tangent", "uv"), out[:5]):
        torch.testing.assert_close(got[h], getattr(ref, f)[h], rtol=1e-6, atol=1e-6, msg=f)
    assert torch.equal(out[5], ref.mat) and torch.equal(out[6], ref.backside)


def _jax_field(n_tris, n_spheres, seed):
    """The port's field scene (scenes.field_spec) through the JAX builder."""
    tris, centers, radii, tmat, smat = scenes.field_spec(n_tris, n_spheres, seed)
    sc = B.Scene()
    mats = [sc.take_material(B.Lambertian(albedo=a)) for a in scenes.FIELD_ALBEDO]
    for m in range(len(mats)):
        sel = tmat == m
        if sel.any():
            pos = tris[sel].reshape(-1, 3)
            sc.take_mesh_instance(B.MeshInstance(
                B.Mesh(pos, None, None, indices=np.arange(len(pos), dtype=np.int32).reshape(-1, 3)),
                mats[m]))
    for c, r, m in zip(centers, radii, smat):
        sc.take_sphere(B.SphereObject(tuple(c), float(r), mats[m]))
    sc.set_environment_map(B.EnvironmentMapConstant(radiance=scenes.FIELD_SKY))
    return sc.build(use_bvh=False)


C1 = {"3000 spheres": ((0, 3000, 11), lambda: scenes.sphere_field(3000, device="cpu"), True),
      "2000 triangles and 40 spheres": ((2000, 40, 12),
                                        lambda: scenes.tri_sphere_field(device="cpu"), False)}


@pytest.mark.parametrize("case", list(C1))
def test_c1_scenes_are_cast_and_rendered_as_jax_routes_them(case):
    """ROADMAP C.1: the port's route is the JAX package's, by its column
    count. 3000 spheres (6144 columns): the K1 form on both sides, where the
    port refused the scene before; 2000 triangles and 40 spheres (8448
    columns): the sweeps on both sides, where the port took K1 before. The
    port's own build equals the JAX build carried across."""
    spec, build, matrix_form = C1[case]
    js = _jax_field(*spec)
    ps = _port(js)
    ours = build()
    for f in ("tris", "spheres", "materials", "light_prims"):
        for a, b in zip(getattr(ours, f), getattr(ps, f)):
            assert torch.equal(a, b), f
    assert intersect_brute.feature_columns(ps.n_tris, ps.n_spheres) == (6144 if matrix_form
                                                                       else 8448)
    assert JI.mxu_eligible(js) == matrix_form == intersect_brute.brute_eligible(ps)
    static = SceneStatic.from_scene(ps)
    tables = prepare_scene(ps, static)
    assert isinstance(tables.accel, intersect_brute.BruteScene if matrix_form else sw.SweepScene)

    # camera rays through each side's own cast
    rays = kc.camera_lanes(24, 18, 1, "cpu", camera=scenes.field_camera("cpu"))
    t, prim, _, _ = intersect.scene_raw_hit(tables.accel, *rays)
    jo, jd, jtmin, jtmax = (jnp.asarray(x.numpy()) for x in rays)
    if matrix_form:   # as the render compiles it (tests/test_torch_intersect.py)
        ms = build_mxu_scene(js)
        jt, jp, _, _, _ = jax.jit(lambda feat, *a: mxu_closest_hit(ms._replace(feat=feat), *a))(
            ms.feat, jo, jd, jtmin, jtmax)
    else:
        jt, jp, _, _ = JI.scene_raw_hit(js, jo, jd, jtmin, jtmax)
    jp, jt = np.asarray(jp), np.asarray(jt)
    assert (prim.numpy() == jp).all() and (jp >= 0).sum() > 50
    h = jp >= 0
    np.testing.assert_allclose(t.numpy()[h], jt[h], rtol=1e-5)

    # a small frame: no refusal, the same counters and pixels as the JAX render
    w, hgt, depth = 16, 12, 3
    pose, vfov = scenes.field_camera("cpu")
    img, stats = render_frame_wavefront(
        ps, static, make_camera(pose, vfov, w, hgt, device="cpu"), CameraConfig(), SensorRGB(),
        w, hgt, 1, params=RenderParams(max_path_components=depth), return_stats=True,
        device="cpu", tables=tables)
    jpose = JT(*(jnp.asarray(x.numpy()) for x in pose))
    jimg, jstats = jrender(js, JSceneStatic.from_scene(js),
                           jmake_camera(transformation=jpose, vfov_deg=vfov, width=w, height=hgt),
                           JCameraConfig(), JSensorRGB(), w, hgt, 1,
                           params=JRenderParams(max_path_components=depth), return_stats=True)
    jstats, jimg = np.asarray(jstats), np.asarray(jimg)
    if matrix_form:
        # The K1 form's sphere quadratic cancels to its last bits on a path's
        # own sphere, where XLA's contexts part from each other (ROADMAP C.1,
        # closed: tests/test_torch_integrator.py): a self-intersection or two.
        assert (np.abs(stats.numpy() - jstats) <= 0.01 * jstats + 1).all()
        same = np.isclose(img.numpy(), jimg, rtol=1e-4, atol=1e-6).all(-1)
        assert same.mean() > 0.95
    else:
        assert stats.tolist() == jstats.tolist()
        np.testing.assert_allclose(img.numpy(), jimg, rtol=1e-4, atol=1e-6)


def test_the_route_follows_the_scene():
    """brute_eligible is mxu_eligible: a static scene without a BVH up to
    8192 columns; animation or more columns take the sweeps; frames reach
    only the sweeps."""
    anim = scenes.cornell_box_animated("cpu")
    assert not intersect_brute.brute_eligible(anim)
    assert isinstance(prepare_scene(anim, SceneStatic.from_scene(anim)).accel, sw.SweepScene)
    ref = scenes.cornell_box_ref("cpu")
    assert intersect_brute.brute_eligible(ref)
    assert intersect_brute.feature_columns(2048, 0) == 8192
    assert intersect_brute.feature_columns(2049, 0) == 8704
    assert intersect_brute.feature_columns(0, 4096) == 8192
    assert intersect_brute.feature_columns(2000, 40) == 8448
    rays = kc.random_lanes(64, "cpu")
    fr = kc.frames_at(anim)
    with pytest.raises(ValueError, match="sweeps"):
        intersect.scene_raw_hit(intersect_brute.build_brute_scene(ref), *rays, fr)
    ss = sw.build_sweep_scene(anim)
    with pytest.raises(ValueError, match="frames"):
        sw.closest_sweep(ss, *rays, fr[:, :2].contiguous())
    with pytest.raises(ValueError, match="frames"):
        sw.any_sweep(ss, *rays, fr.expand(64, -1, -1).contiguous())   # per ray: not taken
