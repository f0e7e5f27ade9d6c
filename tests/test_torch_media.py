"""Participating media in the port against the JAX package, on the CPU: KM's
plain version (`render/media.py` apply_media_plain), the isotropic phase
function, and medium scenes rendered on both entry points.

* `apply_media` against ``wurblpt_tpu.render.media.apply_media`` on the same
  segments (numpy seeds): a sphere boundary, a mesh boundary (an
  octahedron turned, scaled and moved), two overlapping media, segments
  that all start inside (the exit-only branch), and a thin medium that most
  segments leave before their free path ends. The scatter decisions equal on
  all but 0.2 % of the lanes (XLA's CPU contracts the boundary tests into
  FMAs, ROADMAP C.4, and its log1p is not PyTorch's: an ulp moves a
  decision only where a scatter point sits that close to an exit or a solid
  hit), t within rtol 1e-5 and prim, u, v and the phase material equal on
  the others.
* KM's device code built with g++ (``tests/cuda_host/media.cpp``: media.cu
  cut at its C entry point) against the plain version on the same lanes,
  to kernel_check.compare_media's tolerances (bit-equal but for log1pf
  against PyTorch's log1p: at most 1e-5 of the lanes flip, t within 4e-7
  relative).
* The phase function's sample and eval against `bsdf_sample` and
  `bsdf_eval` on the same hits and uniforms (atol 1e-5: XLA's and
  PyTorch's sin and cos differ by an ulp).
* The free-path transmittance (tests/test_shading_features.py:115): the
  scattered share of 8192 rays through a sphere of density 0.7 within 0.02
  of 1 - exp(-2 r rho), every scatter point inside the sphere.
* `render_frame` and `render_frame_wavefront` of 24 x 24 medium scenes
  (tests/test_shading_features.py:146's dark smoke under a constant sky; a
  floor under a sphere light and an importance-sampled sky with two
  overlapping media, so that the light's and the sky's shadow rays are
  closest casts through KM; a camera inside a fog sphere of radius 30, as
  examples/rttnw.py has it) against the JAX render_frame: the mean within
  rtol 1e-4 and the counters within 0.1 %.

Each JAX function is jitted once per case.
"""

import ctypes
import functools
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig
from wurblpt_tpu import RenderParams as JRenderParams
from wurblpt_tpu import SceneStatic as JSceneStatic
from wurblpt_tpu import SensorRGB as JSensorRGB
from wurblpt_tpu import make_camera as jmake_camera
from wurblpt_tpu.core.transform import Transformation as JT
from wurblpt_tpu.core.transform import quat_from_axis_angle as jquat
from wurblpt_tpu.render import bsdf as jbsdf
from wurblpt_tpu.render.integrator import render_frame as jrender_frame
from wurblpt_tpu.render.intersect import HitRecord as JHitRecord
from wurblpt_tpu.render.media import apply_media as japply_media
from wurblpt_tpu.scene import builder as JB
from wurblpt_tpu.scene import generator as JG
from wurblpt_tpu_torch import native, scene_from_numpy
from wurblpt_tpu_torch.native import SRC_DIR
from wurblpt_tpu_torch.render import bsdf
from wurblpt_tpu_torch.render.bsdf import SceneStatic
from wurblpt_tpu_torch.render.camera import CameraConfig, camera_from_numpy
from wurblpt_tpu_torch.render.integrator import RenderParams, render_frame, render_frame_wavefront
from wurblpt_tpu_torch.render.intersect import HitRecord
from wurblpt_tpu_torch.render.intersect_brute import BIG
from wurblpt_tpu_torch.render.media import apply_media, apply_media_plain
from wurblpt_tpu_torch.render.sensor import SensorRGB
from wurblpt_tpu_torch.scene import builder as B
from wurblpt_tpu_torch.scene import generator as G
from wurblpt_tpu_torch.scene.ir import MaterialType
from wurblpt_tpu_torch.utils import kernel_check as kc

torch.set_num_threads(2)

HOST = SRC_DIR.parent.parent / "tests" / "cuda_host"
N = 4096
FOG = ((0.4, 0.0, -0.8), 1.0)   # examples/participating_media.py's fog sphere


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _octahedron_pose():
    return JT.make(translation=(0.2, 0.1, -0.6), rotation=jquat((0, 1, 0), np.deg2rad(160.0)),
                   scale=(0.8,) * 3)


def _jax_media_scene(kind):
    """A floor, a sphere hot spot and the case's media, built by the JAX
    package's builder."""
    sc = JB.Scene()
    floor = JG.transform_mesh(JG.generate_quad(4.0, 4.0), translate=(0.0, 0.0, -3.0))
    sc.take_mesh_instance(JB.MeshInstance(floor, JB.Lambertian(albedo=(0.5, 0.5, 0.5))))
    sc.take_sphere(JB.SphereObject((0.0, 1.6, -2.0), 0.35,
                                   JB.LightDiffuse(radiance=(14.0, 12.0, 10.0))), hot_spot=True)
    sphere = JB.SphereObject(*FOG, 0)
    octa = JB.MeshInstance(JG.generate_octahedron(), 0, _octahedron_pose())
    media = {"sphere": [(sphere, 1.5)], "inside": [(sphere, 1.5)], "mesh": [(octa, 2.5)],
             "overlap": [(sphere, 0.7), (octa, 2.0)], "thin": [(sphere, 0.05)]}[kind]
    for boundary, rho in media:
        sc.take_medium(JB.MediumObject(boundary=boundary, density=rho,
                                       phase=JB.PhaseIso(albedo=(0.9, 0.8, 0.7))))
    return sc.build()


@functools.lru_cache(maxsize=None)
def _case(kind, seed=3):
    """(JAX scene, port scene, the segments as numpy arrays) of a case: from
    inside the fog sphere (every lane for "inside", a third otherwise) or a
    box around it, random solid hits (a quarter none), random counter words."""
    js = _jax_media_scene(kind)
    rs = np.random.default_rng(seed)
    c = np.asarray(FOG[0])
    inside = np.ones(N, bool) if kind == "inside" else rs.uniform(size=N) < 1 / 3
    v = rs.normal(size=(N, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    o = np.where(inside[:, None], c + v * rs.uniform(0.0, 0.95, size=(N, 1)),
                 c + rs.uniform(-3.0, 3.0, size=(N, 3)))
    d = rs.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    none = rs.uniform(size=N) < 0.25
    seg = dict(o=o.astype(np.float32), d=d.astype(np.float32),
               t_min=np.full(N, 1e-4, np.float32),
               t=np.where(none, BIG, rs.uniform(0.05, 6.0, size=N)).astype(np.float32),
               prim=np.where(none, -1, rs.integers(0, 4, size=N)).astype(np.int32),
               u=rs.uniform(size=N).astype(np.float32), v=rs.uniform(size=N).astype(np.float32),
               pixel=rs.integers(0, 1 << 20, size=N).astype(np.int32),
               sample=rs.integers(0, 64, size=N).astype(np.int32),
               bounce=rs.integers(0, 12, size=N).astype(np.int32))
    return js, scene_from_numpy(_np(js), "cpu"), seg


def _port_args(scene, seg, salt_ctx):
    t = {k: torch.from_numpy(v) for k, v in seg.items()}
    return (scene, t["o"], t["d"], t["t_min"], t["t"], t["prim"], t["u"], t["v"],
            t["pixel"].long(), t["sample"].long(), t["bounce"].long(), salt_ctx)


def _jax_media(js, seg, salt_ctx):
    fn = jax.jit(lambda s, *a: japply_media(s, *a, salt_ctx))
    return [np.asarray(x) for x in fn(js, *(jnp.asarray(seg[k]) for k in (
        "o", "d", "t_min", "t", "prim", "u", "v", "pixel", "sample", "bounce")))]


@pytest.mark.parametrize("kind, salt_ctx", [("sphere", 0), ("mesh", 1), ("overlap", 2),
                                            ("inside", 0), ("thin", 1)])
def test_apply_media_matches_jax(kind, salt_ctx):
    js, scene, seg = _case(kind)
    got = [x.numpy() for x in apply_media(*_port_args(scene, seg, salt_ctx))]
    ref = _jax_media(js, seg, salt_ctx)
    flips = got[4] != ref[4]
    assert flips.mean() <= 2e-3, flips.sum()
    same = ~flips
    np.testing.assert_allclose(got[0][same], ref[0][same], rtol=1e-5)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a[same], b[same])
    mask = got[4]
    n_media = scene.media.count
    assert mask.mean() > 0.005 and np.isin(got[5][mask], scene.media.phase_mat.numpy()).all()
    assert (got[1][mask] >= scene.n_tris + scene.n_spheres).all()
    assert (got[1][mask] < scene.n_tris + scene.n_spheres + n_media).all()
    assert (got[2][mask] == 0).all() and (got[3][mask] == 0).all()
    if kind == "inside":   # every segment starts inside: scatters lie between t_min and the exit
        assert mask.mean() > 0.3 and (got[0][mask] >= 1e-4).all()
    if kind == "thin":     # most segments cross the thin fog without a scatter
        assert mask.mean() < 0.05
    if kind == "overlap":  # both media scatter some lanes
        med = got[1][mask] - (scene.n_tris + scene.n_spheres)
        assert set(np.unique(med)) == {0, 1}


def test_apply_media_wrapper_checks_and_dispatch():
    _, scene, seg = _case("sphere")
    args = _port_args(scene, seg, 0)
    plain = apply_media_plain(*args)
    for a, b in zip(apply_media(*args), plain):
        assert torch.equal(a, b)
    # scalar counter words broadcast to every lane
    k0 = apply_media(*args[:10], 0, 0)
    kt = apply_media(*args[:10], torch.zeros(N, dtype=torch.int64), 0)
    assert all(torch.equal(a, b) for a, b in zip(k0, kt))
    with pytest.raises(ValueError, match="t_solid"):
        apply_media(*args[:4], args[4].double(), *args[5:])
    with pytest.raises(ValueError, match="o needs contiguous"):
        apply_media(args[0], args[1].t().contiguous().t(), *args[2:])


# ---------------------------------------------------------------------------
# KM's device code built with g++
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def km_host(tmp_path_factory):
    """The host build of media.cu's device code (tests/cuda_host/media.cpp)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("media")
    src = (SRC_DIR / "media.cu").read_text()
    (out / "media_device.cuh").write_text(src[:src.index('extern "C"')])
    so = out / "libmedia.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    f"-I{out}", f"-I{HOST}", "-o", str(so), str(HOST / "media.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.host_apply_media.argtypes = native._SIGNATURES["wpt_apply_media"][:-1]
    return lib


def _host_media(lib, args):
    scene, o = args[0], args[1]
    n, md = o.shape[0], scene.media
    t, prim = torch.full((n,), float("nan")), torch.full((n,), -7, dtype=torch.int32)
    u, v = torch.full((n,), float("nan")), torch.full((n,), float("nan"))
    mask, mat = torch.ones((n,), dtype=torch.bool), torch.full((n,), -7, dtype=torch.int32)
    assert lib.host_apply_media(
        *(x.data_ptr() for x in args[1:11]), 0x40 + (args[11] << 8), n,
        *(x.data_ptr() for x in (md.tri_p0, md.tri_e1, md.tri_e2, md.tri_off, md.sph_center,
                                 md.sph_radius, md.sph_off, md.density, md.phase_mat)),
        md.count, scene.n_tris + scene.n_spheres,
        *(x.data_ptr() for x in (t, prim, u, v, mask, mat))) == 0
    return t, prim, u, v, mask, mat


@pytest.mark.parametrize("kind", ["sphere", "mesh", "overlap", "inside"])
def test_kernel_device_code_matches_the_plain_version(km_host, kind):
    _, scene, seg = _case(kind)
    args = _port_args(scene, seg, 1)
    res = kc.compare_media(_host_media(km_host, args), apply_media_plain(*args))
    assert res["medium_lanes"] > 0.02 * N, res


def test_kernel_device_code_on_participating_media_segments(km_host):
    """The 1000 random segments the card's check uses, on the app's scene."""
    from wurblpt_tpu_torch.utils import scenes

    args = kc.media_random_lanes(scenes.participating_media(device="cpu"))
    res = kc.compare_media(_host_media(km_host, args), apply_media_plain(*args))
    assert res["lanes"] == 1000 and res["medium_lanes"] > 50, res


# ---------------------------------------------------------------------------
# The phase function, the free path, the differentiable refusal
# ---------------------------------------------------------------------------

def test_phase_function_sample_and_eval_match_jax():
    js, scene, seg = _case("overlap")
    rs = np.random.default_rng(9)
    n = 2048
    nrm = rs.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    phase = int(scene.media.phase_mat[0])
    mat = np.where(rs.uniform(size=n) < 0.7, phase, 0).astype(np.int32)
    cols = dict(t=np.ones(n, np.float32), hit=np.ones(n, bool), prim=np.zeros(n, np.int32),
                position=rs.normal(size=(n, 3)).astype(np.float32),
                normal=nrm.astype(np.float32), geom_normal=nrm.astype(np.float32),
                tangent=np.tile(np.float32([1.0, 0.0, 0.0]), (n, 1)),
                uv=np.zeros((n, 2), np.float32), backside=np.zeros(n, bool), mat=mat)
    jhr = JHitRecord(**{k: jnp.asarray(v) for k, v in cols.items()})
    hr = HitRecord(**{k: torch.from_numpy(v) for k, v in cols.items()})
    d = (-nrm).astype(np.float32)
    uni = rs.uniform(size=(n, 4)).astype(np.float32)
    ior = np.ones((n, 4), np.float32)
    jstatic = JSceneStatic.from_scene(js)
    assert MaterialType.PHASE_ISO in jstatic.mat_types
    js_s = jbsdf.bsdf_sample(js, jstatic, jhr, jnp.asarray(d), jnp.asarray(ior), jnp.asarray(uni),
                             jnp.asarray(uni[:, 2]), jnp.asarray(uni[:, 3]))
    mrow = bsdf.gather_material_rows(bsdf.pack_material_table(scene.materials), hr.mat)
    types = SceneStatic.from_scene(scene).mat_types
    ts = bsdf.bsdf_sample(hr, torch.from_numpy(d), torch.from_numpy(ior), torch.from_numpy(uni),
                          torch.from_numpy(uni[:, 2]), torch.from_numpy(uni[:, 3]), mrow, types)
    np.testing.assert_array_equal(ts.kind.numpy(), np.asarray(js_s.kind))
    for a, b in ((ts.direction, js_s.direction), (ts.atten, js_s.atten), (ts.pdf, js_s.pdf)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    ph = mat == phase
    assert (ts.kind.numpy()[ph] == bsdf.ScatterKind.RANDOM).all()
    np.testing.assert_allclose(np.linalg.norm(ts.direction.numpy()[ph], axis=-1), 1.0, atol=1e-6)
    wd = rs.normal(size=(n, 3))
    wd = (wd / np.linalg.norm(wd, axis=-1, keepdims=True)).astype(np.float32)
    jf, jp = jbsdf.bsdf_eval(js, jstatic, jhr, jnp.asarray(d), jnp.asarray(wd))
    f, p = bsdf.bsdf_eval(hr, torch.from_numpy(d), torch.from_numpy(wd), mrow, types)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.numpy()[ph], 1.0 / (4.0 * np.pi), rtol=1e-6)


def test_medium_free_path_transmittance():
    """tests/test_shading_features.py:115 on the port's builder and apply_media."""
    rho, r = 0.7, 1.0
    sc = B.Scene()
    sc.take_medium(B.MediumObject(boundary=B.SphereObject((0, 0, 0), r, B.PhaseIso()),
                                  density=rho, phase=B.PhaseIso(albedo=(1.0, 1.0, 1.0))))
    wall = G.transform_mesh(G.generate_quad(10.0, 10.0), translate=(0, 0, -5))
    sc.take_mesh_instance(B.MeshInstance(mesh=wall, material=B.Lambertian()))
    scene = sc.build(device="cpu")
    assert SceneStatic.from_scene(scene).has_media
    n = 8192
    o = torch.tensor([[0.0, 0.0, 3.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1)
    t, prim, _, _, mask, mat = apply_media(
        scene, o, d, torch.full((n,), 1e-4), torch.full((n,), 8.0),
        torch.zeros((n,), dtype=torch.int32), torch.zeros(n), torch.zeros(n),
        torch.arange(n), 0, 0, 0)
    assert abs(float(mask.float().mean()) - (1.0 - np.exp(-2.0 * r * rho))) < 0.02
    ts = t[mask]
    assert float(ts.min()) >= 2.0 - 1e-3 and float(ts.max()) <= 4.0 + 1e-3
    assert (mat[mask] == int(scene.media.phase_mat[0])).all() and (prim[mask] == 2).all()


def test_a_differentiable_render_of_media_raises():
    _, scene, _ = _case("sphere")
    cam = camera_from_numpy(_np(jmake_camera(transformation=JT.make(translation=(0, 0, 4)),
                                             vfov_deg=40.0, width=4, height=4)), "cpu")
    with pytest.raises(NotImplementedError, match="A.13"):
        render_frame(scene, SceneStatic.from_scene(scene), cam, CameraConfig(), SensorRGB(), 4,
                     4, 1, params=RenderParams(max_path_components=2, differentiable=True),
                     device="cpu")


# ---------------------------------------------------------------------------
# Medium scenes rendered
# ---------------------------------------------------------------------------

def _smoke():
    """tests/test_shading_features.py:146: dark smoke under a constant sky, no solid."""
    sc = JB.Scene()
    sc.take_medium(JB.MediumObject(boundary=JB.SphereObject((0, 0, 0), 1.0, JB.PhaseIso()),
                                   density=3.0, phase=JB.PhaseIso(albedo=(0.2, 0.2, 0.2))))
    sc.set_environment_map(JB.EnvironmentMapConstant(radiance=(1.0, 1.0, 1.0)))
    return sc.build(), JT.make(translation=(0.0, 0.0, 4.0)), 40.0


def _lit_fog():
    """Two overlapping media over a floor under a sphere light and an
    importance-sampled sky: both NEE kinds cast through KM."""
    sc = JB.Scene()
    floor = JG.transform_mesh(JG.generate_quad(3.0, 3.0), translate=(0.0, 0.0, -2.5))
    sc.take_mesh_instance(JB.MeshInstance(floor, JB.Lambertian(albedo=(0.6, 0.6, 0.6))))
    sc.take_sphere(JB.SphereObject((0.8, 1.4, -1.0), 0.3, JB.LightDiffuse(radiance=(12.0,) * 3)),
                   hot_spot=True)
    sc.take_medium(JB.MediumObject(boundary=JB.SphereObject(*FOG, 0), density=0.9,
                                   phase=JB.PhaseIso(albedo=(0.9, 0.9, 0.9))))
    sc.take_medium(JB.MediumObject(boundary=JB.MeshInstance(JG.generate_octahedron(), 0,
                                                            _octahedron_pose()),
                                   density=1.6, phase=JB.PhaseIso(albedo=(0.7, 0.8, 0.9))))
    sky = np.random.default_rng(4).uniform(0.1, 1.5, (8, 16, 3)).astype(np.float32)
    sc.set_environment_map(JB.EnvironmentMapEquiRect(image=sky, importance_resolution=8))
    return sc.build(), JT.make(translation=(0.0, 0.3, 3.0)), 45.0


def _inside_fog():
    """examples/rttnw.py's set-up: the camera inside a fog sphere of radius
    30, a lit sphere and a floor in the fog."""
    sc = JB.Scene()
    floor = JG.transform_mesh(JG.generate_quad(6.0, 6.0), translate=(0.0, 0.0, -4.0))
    sc.take_mesh_instance(JB.MeshInstance(floor, JB.Lambertian(albedo=(0.6, 0.5, 0.4))))
    sc.take_sphere(JB.SphereObject((0.0, 1.0, -2.0), 0.4, JB.LightDiffuse(radiance=(8.0,) * 3)),
                   hot_spot=True)
    sc.take_medium(JB.MediumObject(boundary=JB.SphereObject((0, 0, 0), 30.0, 0), density=0.05,
                                   phase=JB.PhaseIso(albedo=(1.0, 1.0, 1.0))))
    return sc.build(), JT.make(translation=(0.0, 0.0, 2.0)), 50.0


SCENES = {"smoke": (_smoke, 3, 8), "lit_fog": (_lit_fog, 2, 6), "inside_fog": (_inside_fog, 2, 6)}


@functools.lru_cache(maxsize=None)
def _jax_frame(name, w=24):
    build, ssqrt, depth = SCENES[name]
    js, pose, vfov = build()
    jcam = jmake_camera(transformation=pose, vfov_deg=vfov, width=w, height=w)
    jstatic = JSceneStatic.from_scene(js)
    fn = jax.jit(lambda s, c: jrender_frame(s, jstatic, c, JCameraConfig(), JSensorRGB(), w, w,
                                            ssqrt, params=JRenderParams(max_path_components=depth),
                                            samples_per_pass=ssqrt * ssqrt, return_stats=True))
    img, stats = (np.asarray(x) for x in fn(js, jcam))
    return js, jcam, img, stats


@pytest.mark.parametrize("entry", ["render_frame", "render_frame_wavefront"])
@pytest.mark.parametrize("name", list(SCENES))
def test_medium_scene_renders_as_jax_renders(name, entry):
    _, ssqrt, depth = SCENES[name]
    js, jcam, jimg, jstats = _jax_frame(name)
    scene = scene_from_numpy(_np(js), "cpu")
    static = SceneStatic.from_scene(scene)
    assert static.has_media and MaterialType.PHASE_ISO in static.mat_types
    cam = camera_from_numpy(_np(jcam), "cpu")
    params = RenderParams(max_path_components=depth)
    if entry == "render_frame":
        img, stats = render_frame(scene, static, cam, CameraConfig(), SensorRGB(), 24, 24, ssqrt,
                                  params=params, samples_per_pass=ssqrt * ssqrt,
                                  return_stats=True, device="cpu")
    else:
        img, stats = render_frame_wavefront(scene, static, cam, CameraConfig(), SensorRGB(), 24,
                                            24, ssqrt, params, return_stats=True, device="cpu")
    img, stats = img.numpy(), stats.numpy()
    mean, jmean = img.astype(np.float64).mean(), jimg.astype(np.float64).mean()
    assert np.isfinite(img).all() and jmean > 0
    assert abs(mean - jmean) <= 1e-4 * jmean, (mean, jmean)
    np.testing.assert_allclose(stats, jstats, rtol=1e-3)
    if name == "smoke":   # the smoke dims the sky behind it (test_shading_features.py:190)
        assert img[12, 12, :3].mean() < 0.6 * img[0, 0, :3].mean()
