"""Motion blur in the port against the JAX package: every ray at its own time
over a shutter [t0, t1], on the CPU (the kernels' plain versions).

* The per-ray frame rows (`anim_frames_per_ray`, [N, A, 30]) against
  `make_anim_ctx(with_forward=True)` and `anim_forward_frames` at random
  per-ray times (XLA's acos and sin are not PyTorch's, ROADMAP C.4:
  matrices to 2e-6 absolute, as tests/test_torch_animation.py), and bit
  for bit against the one-instant rows at a shared time.
* KS1, KS2 and K3a's plain versions with per-ray rows against the JAX
  sweeps and `assemble_hit` with a per-ray AnimCtx (tolerances of
  tests/test_torch_sweep.py: prim ids equal off grazing lanes, t rtol 1e-4,
  the record's vectors atol 1e-4); K5/K6's plain walk with per-ray rows
  against the JAX BVH walk with per-ray object rays and against the port's
  sweep (prim ids equal off ties, t rtol 1e-4).
* `render_frame` over a shutter against the JAX package's on
  tests/test_shading_features.py:257's moving light (32 x 32, 4 spp) and
  a moving sphere hot spot over a floor (32 x 32, 4 spp, 3 path
  components: NEE toward the sphere at each ray's time), on
  frame 0 of examples/rolling_marbles.py at 32 x 18 (4 spp, 3 path
  components) and examples/animations.py at 24 x 18, and on the animated
  box with spheres in a BVH swept over [0, 1] (24 x 24, 4 spp): the mean
  within rtol 2e-3 and the counters within 0.5 % (equal on all but the
  sphere scenes, where XLA's jitted sphere test parts from its eager one
  on a few casts: tests/test_torch_integrator.py); `render_frame_wavefront`
  over a shutter returns `render_frame`'s image and counters, and the JAX
  package's wavefront its render_frame's.
* The differentiable render of an animated scene (utils/grad_check.py's
  moving floor, 16 x 16, 4 spp, 3 path components, over [0, 1]): the
  gradients with respect to the floor's vertices and a keyframe
  translation (K3aT's plain version and autograd through the per-ray rows)
  against `jax.grad` of the JAX render within rtol 2e-3, and against the
  port's own central difference (eps 1e-2) within 3 %.

Each JAX render is compiled once per case."""

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
from test_torch_animation import _both, _times  # noqa: E402
from test_torch_sweep import _grazing, _jax_cast, _random_scene, _rays  # noqa: E402
from wurblpt_tpu import CameraConfig as JCameraConfig  # noqa: E402
from wurblpt_tpu import RenderParams as JRenderParams  # noqa: E402
from wurblpt_tpu import SceneStatic as JSceneStatic  # noqa: E402
from wurblpt_tpu import SensorRGB as JSensorRGB  # noqa: E402
from wurblpt_tpu import make_camera as jmake_camera  # noqa: E402
from wurblpt_tpu.accel.traverse import bvh_any_hit as jbvh_any_hit  # noqa: E402
from wurblpt_tpu.accel.traverse import bvh_closest_hit as jbvh_closest_hit  # noqa: E402
from wurblpt_tpu.core.transform import Transformation as JT  # noqa: E402
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat  # noqa: E402
from wurblpt_tpu.core.transform import quat_from_axis_angle as jquat  # noqa: E402
from wurblpt_tpu.render import intersect as JI  # noqa: E402
from wurblpt_tpu.render.integrator import render_frame as jrender_frame  # noqa: E402
from wurblpt_tpu.render.integrator import render_frame_wavefront as jrender_wf  # noqa: E402
from wurblpt_tpu.scene import animation as janim  # noqa: E402
from wurblpt_tpu.scene import builder as JB  # noqa: E402
from wurblpt_tpu.scene.generator import generate_quad as jquad  # noqa: E402
from wurblpt_tpu_torch import (CameraConfig, RenderParams, SceneStatic, SensorRGB,  # noqa: E402
                               render_frame, render_frame_wavefront, scene_from_numpy)
from wurblpt_tpu_torch.accel import traverse  # noqa: E402
from wurblpt_tpu_torch.render import intersect  # noqa: E402
from wurblpt_tpu_torch.render import intersect_sweep as sw  # noqa: E402
from wurblpt_tpu_torch.render.camera import camera_from_numpy  # noqa: E402
from wurblpt_tpu_torch.scene import animation as anim  # noqa: E402
from wurblpt_tpu_torch.utils import grad_check as gc  # noqa: E402
from wurblpt_tpu_torch.utils import kernel_check as kc  # noqa: E402

torch.set_num_threads(2)

ATOL = 2e-6


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _port(js, t0=0.0, t1=0.0):
    return scene_from_numpy(_np(js), "cpu", t0, t1)


def _times_in(n, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


# ---------------------------------------------------------------------------
# The per-ray rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_per_ray_rows_match_make_anim_ctx(seed):
    jt, pt, arrays = _both(seed)
    n = 777
    t = _times(arrays, n, seed + 30)
    rows = anim.anim_frames_per_ray(pt, torch.as_tensor(t))
    assert rows.shape == (n, pt.count, anim.FRAME_WIDTH) and rows.is_contiguous()
    ctx = janim.make_anim_ctx(jt, jnp.asarray(t), with_forward=True)
    aid = jnp.broadcast_to(jnp.arange(pt.count, dtype=jnp.int32)[None], (n, pt.count))
    _, m_nrm, _ = janim.anim_forward_frames(jt, aid, jnp.asarray(t)[:, None])
    r = rows.numpy()
    for k, ref in ((0, ctx.r_inv), (12, ctx.m_fwd), (21, m_nrm)):
        np.testing.assert_allclose(r[..., k:k + 9], np.asarray(ref).reshape(n, -1, 9), rtol=1e-5,
                                   atol=ATOL * 4)
    np.testing.assert_allclose(r[..., 9:12], np.asarray(ctx.t_inv), rtol=0, atol=ATOL)
    # at one shared time, each lane's rows are the instant's bit for bit
    same = anim.anim_frames_per_ray(pt, torch.full((5,), 0.3))
    assert torch.equal(same, anim.anim_frames(pt, 0.3).expand(5, -1, -1))
    # the object rays of a lane's own rows
    o = torch.randn(n, 3, generator=torch.Generator().manual_seed(seed))
    d = torch.randn(n, 3, generator=torch.Generator().manual_seed(seed + 1))
    a = torch.as_tensor(np.random.default_rng(seed).integers(0, pt.count, n))
    oa, da, _ = anim.frames_ray_to_object(rows, a, o, d)
    jo, jd = ctx.ray_to_object(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    sel = np.arange(n), a.numpy()
    scale = 1.0 + np.abs(np.asarray(jo)[sel]).max(-1, keepdims=True)
    np.testing.assert_allclose(oa.numpy(), np.asarray(jo)[sel], rtol=0, atol=1e-5 * scale.max())
    np.testing.assert_allclose(da.numpy(), np.asarray(jd)[sel], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The casts and the hit assembly with per-ray rows
# ---------------------------------------------------------------------------

def test_plain_sweeps_and_assembly_with_per_ray_rows_match_jax():
    js = _random_scene(3, True)
    ps = _port(js)
    ss, ht = sw.build_sweep_scene(ps), intersect.build_hit_tables(ps)
    rays = _rays(3000, 5)
    times = _times_in(3000, 6)
    ctx = janim.make_anim_ctx(js.anims, jnp.asarray(times))
    frames = anim.anim_frames_per_ray(ps.anims, torch.as_tensor(times))
    (jt, jp, ju, jv), jocc = _jax_cast(js, rays, ctx)
    T = [torch.as_tensor(x) for x in rays]
    pt, pp, pu, pv = sw.closest_sweep_plain(ss, *T, frames)
    pocc = sw.any_sweep_plain(ss, *T, frames).numpy()
    graze = _grazing(ss, rays, frames, pp, pu, pv)
    npp = pp.numpy()
    assert ((npp != jp) & ~graze).sum() == 0
    assert ((pocc != jocc) & ~graze).sum() == 0
    hit = (npp == jp) & (npp >= 0)
    assert hit.sum() > 500 and (npp >= ss.n_tris).sum() > 20 and 0 < pocc.sum() < len(pocc)
    np.testing.assert_allclose(pt.numpy()[hit], jt[hit], rtol=1e-4)
    # the rows of one instant would cast otherwise: the times matter
    assert (sw.closest_sweep_plain(ss, *T, kc.frames_at(ps, 0.5))[1] != pp).sum() > 30
    # K3a with each lane's rows
    ours = intersect.assemble_hit_plain(ht, T[0], T[1], pt, pp, pu, pv, frames)
    ref = JI.assemble_hit(js, *(jnp.asarray(x.numpy()) for x in (T[0], T[1], pt, pp, pu, pv)),
                          anim_ctx=ctx)
    h = ours.hit.numpy() & ~graze
    for f in ("hit", "prim", "mat", "backside"):
        np.testing.assert_array_equal(getattr(ours, f).numpy()[h], np.asarray(getattr(ref, f))[h])
    for f in ("position", "normal", "geom_normal", "tangent", "uv"):
        np.testing.assert_allclose(getattr(ours, f).numpy()[h], np.asarray(getattr(ref, f))[h],
                                   rtol=0, atol=1e-4, err_msg=f)
    # the wrappers on CPU tensors are the plain versions
    for a, b in zip(intersect.assemble_hit(ht, T[0], T[1], pt, pp, pu, pv, frames), ours):
        assert torch.equal(a, b)
    assert torch.equal(sw.any_sweep(ss, *T, frames), sw.any_sweep_plain(ss, *T, frames))


@pytest.fixture(scope="module")
def blur_bvh():
    """The animated box with its spheres in a BVH swept over [0, 1]: the JAX
    build and the port's (its own tree over the same boxes)."""
    js = jfr.jax_cornell_animated(spheres=True, use_bvh=True, t=0.0, t1=1.0)
    return js, _port(js, 0.0, 1.0)


@pytest.mark.parametrize("kind", ["camera", "random"])
def test_plain_bvh_walk_with_per_ray_rows_matches_jax(blur_bvh, kind):
    js, ps = blur_bvh
    assert ps.has_bvh and ps.bvh.n_anims == 4
    if kind == "camera":
        o, d, t_min, t_max = kc.camera_lanes(32, 32, 1, "cpu")
    else:
        o, d, t_min, t_max = kc.random_lanes(1500, "cpu", seed=4)
    n = o.shape[0]
    times = _times_in(n, 8)
    frames = anim.anim_frames_per_ray(ps.anims, torch.as_tensor(times))
    ctx = janim.make_anim_ctx(js.anims, jnp.asarray(times))
    jrays = [jnp.asarray(x.numpy()) for x in (o, d, t_min, t_max)]
    obj = ctx.ray_to_object(jrays[0], jrays[1])
    t, prim, _, _ = traverse.bvh_closest_hit_plain(ps.bvh, o, d, t_min, t_max, frames)
    jt, jprim, _, _ = (np.asarray(x) for x in jbvh_closest_hit(js, *jrays, obj_rays=obj))
    st, sprim, _, _ = sw.closest_sweep_plain(sw.build_sweep_scene(ps), o, d, t_min, t_max,
                                             frames)
    prim, t, st = prim.numpy(), t.numpy(), st.numpy()
    live = (t_max > t_min).numpy()     # a dead lane is a miss in the port's casts
    assert (prim[~live] == -1).all() and live.sum() > 0.8 * n
    # the winners agree but at ties (two triangles of a box's face at one t):
    # with the sweep on every live lane, with the JAX walk on the unbounded
    # ones (its leaf test does not bound a hit by a finite t_max)
    unbounded = live & (t_max.numpy() >= np.float32(kc.BIG))
    for other, ot, lanes in ((jprim, jt, unbounded), (sprim.numpy(), st, live)):
        differ = lanes & (prim != other)
        assert (np.abs(t - ot)[differ] <= 1e-5 * t[differ]).all() and differ.mean() < 0.005
    same = (prim == jprim) & (prim >= 0) & unbounded
    assert same.sum() > 0.2 * n
    np.testing.assert_allclose(t[same], jt[same], rtol=1e-4)
    occ = traverse.bvh_any_hit_plain(ps.bvh, o, d, t_min, t_max, frames).numpy()
    jocc = np.asarray(jbvh_any_hit(js, *jrays, obj_rays=obj))
    np.testing.assert_array_equal(occ[unbounded], jocc[unbounded])
    assert occ.sum() > 0.3 * n
    # the wrappers take the per-ray rows on the CPU
    assert torch.equal(traverse.bvh_closest_hit(ps.bvh, o, d, t_min, t_max, frames)[1],
                       torch.as_tensor(prim))
    with pytest.raises(ValueError, match="frames"):
        traverse.bvh_closest_hit(ps.bvh, o, d, t_min, t_max, frames[:-1].contiguous())


# ---------------------------------------------------------------------------
# Frames over a shutter
# ---------------------------------------------------------------------------

def _moving_light():
    """tests/test_shading_features.py:257's scene: an emissive quad keyframed
    from x = -0.6 to 0.6 over [0, 1], seen from z = 2.5."""
    sc = JB.Scene()
    aid = sc.take_animation(JB.AnimationKeyframes([0.0, 1.0], [
        JT.make(translation=(-0.6, 0.0, 0.0)), JT.make(translation=(0.6, 0.0, 0.0))]))
    sc.take_mesh_instance(JB.MeshInstance(mesh=jquad(0.15, 0.15),
                                          material=JB.LightDiffuse(radiance=(4, 4, 4)),
                                          animation=aid), hot_spot=True)
    js = sc.build(t0=0.0, t1=1.0)
    return js, (JT.make(translation=(0.0, 0.0, 2.5)), 50.0), (0.0, 1.0)


def _moving_sphere_light():
    """A sphere hot spot keyframed from x = -0.6 to 0.6 over [0, 1] above a
    floor quad, seen from z = 2.5: NEE toward the sphere where it is at each
    ray's time (its per-ray forward frame)."""
    sc = JB.Scene()
    aid = sc.take_animation(JB.AnimationKeyframes([0.0, 1.0], [
        JT.make(translation=(-0.6, 0.0, 0.0)), JT.make(translation=(0.6, 0.0, 0.0))]))
    sc.take_mesh_instance(JB.MeshInstance(mesh=jquad(1.5, 1.5),
                                          material=JB.Lambertian(albedo=(0.7, 0.6, 0.5)),
                                          transformation=JT.make(translation=(0.0, 0.0, -0.6))))
    sc.take_sphere(JB.SphereObject((0.0, 0.0, 0.0), 0.15, JB.LightDiffuse(radiance=(4, 4, 4)),
                                   animation=aid), hot_spot=True)
    js = sc.build(t0=0.0, t1=1.0)
    return js, (JT.make(translation=(0.0, 0.0, 2.5)), 50.0), (0.0, 1.0)


def _motion(name):
    js, (pose, vfov) = jfr.jax_motion_scene(name)
    if not isinstance(pose, JT):
        pose = jfrom_lookat(*pose)
    return js, (pose, vfov), kc.MOTION_FRAMES[name][5:]


# (scene, width, height, samples_sqrt, path components)
CASES = {"moving light": (_moving_light, 32, 32, 2, 2),
         "moving sphere light": (_moving_sphere_light, 32, 32, 2, 3),
         "rolling_marbles": (lambda: _motion("rolling_marbles"), 32, 18, 2, 3),
         "animations": (lambda: _motion("animations"), 24, 18, 2, 3),
         "cornell_animated_blur": (lambda: _motion("cornell_animated_blur"), 24, 24, 2, 3)}


@pytest.mark.parametrize("name", list(CASES))
def test_render_frame_over_a_shutter_matches_jax(name):
    build, w, h, ssqrt, depth = CASES[name]
    js, (pose, vfov), (t0, t1) = build()
    jcam = jmake_camera(transformation=pose, vfov_deg=vfov, width=w, height=h)
    jstatic = JSceneStatic.from_scene(js)
    fn = jax.jit(lambda s, c: jrender_frame(s, jstatic, c, JCameraConfig(), JSensorRGB(), w, h,
                                            ssqrt, t0, t1,
                                            params=JRenderParams(max_path_components=depth),
                                            samples_per_pass=ssqrt * ssqrt, return_stats=True))
    jimg, jstats = (np.asarray(x) for x in fn(js, jcam))
    ps = _port(js, t0, t1)
    cam = camera_from_numpy(_np(jcam), "cpu")
    static = SceneStatic.from_scene(ps)
    params = RenderParams(max_path_components=depth)
    img, stats = render_frame(ps, static, cam, CameraConfig(), SensorRGB(), w, h, ssqrt, t0, t1,
                              params, ssqrt * ssqrt, return_stats=True, device="cpu")
    img, stats = img.numpy(), stats.numpy()
    mean, jmean = float(img.astype(np.float64).mean()), float(jimg.astype(np.float64).mean())
    assert np.isfinite(img).all() and jmean > 0
    assert abs(mean - jmean) <= 2e-3 * jmean, (mean, jmean)
    np.testing.assert_allclose(stats, jstats, rtol=5e-3)
    if ps.n_spheres == 0:
        np.testing.assert_array_equal(stats, jstats)
    # the wavefront hands the frame to render_frame, in the port and in JAX
    wf, wf_stats = render_frame_wavefront(ps, static, cam, CameraConfig(), SensorRGB(), w, h,
                                          ssqrt, params, max_lanes=w * h * ssqrt * ssqrt,
                                          return_stats=True, device="cpu", t0=t0, t1=t1)
    assert np.array_equal(wf.numpy(), img) and np.array_equal(wf_stats.numpy(), stats)
    if name == "moving light":
        jwf, jwf_stats = jrender_wf(js, jstatic, jcam, JCameraConfig(), JSensorRGB(), w, h, ssqrt,
                                    t0, t1, JRenderParams(max_path_components=depth),
                                    return_stats=True)
        np.testing.assert_array_equal(np.asarray(jwf_stats), jstats)
        # the streak covers both ends of the sweep (test_shading_features.py)
        a = img[..., 0]
        assert a[14:18, 4:10].max() > 0.5 and a[14:18, 22:28].max() > 0.5 and a[0].max() < 0.25


# ---------------------------------------------------------------------------
# The differentiable animated render (K3aT)
# ---------------------------------------------------------------------------

def _jax_moving_floor():
    """utils/grad_check.moving_floor built by the JAX package's builder."""
    sc = JB.Scene()
    up, down = jquat((1.0, 0.0, 0.0), -np.pi / 2), jquat((1.0, 0.0, 0.0), np.pi / 2)
    aid = sc.take_animation(JB.AnimationKeyframes([0.0, 1.0], [
        JT.make(translation=(0.0, -0.5, 0.0)), JT.make(translation=(0.0, -0.3, 0.0))]))
    sc.take_mesh_instance(JB.MeshInstance(jquad(5.0, 5.0), JB.Lambertian(albedo=(0.7, 0.6, 0.5)),
                                          JT.make(rotation=up), animation=aid))
    sc.take_mesh_instance(JB.MeshInstance(jquad(0.3, 0.3), JB.LightDiffuse(radiance=(12.0,) * 3),
                                          JT.make(translation=(0.0, 1.5, 0.0), rotation=down)),
                          hot_spot=True)
    return sc.build(t0=0.0, t1=1.0)


def test_animated_gradients_match_jax_grad_and_central_differences():
    js = _jax_moving_floor()
    ps = _port(js, 0.0, 1.0)
    ours = gc.moving_floor("cpu")
    for f in ("p0", "e1", "e2", "anim"):
        assert torch.equal(getattr(ours.tris, f), getattr(ps.tris, f)), f
    assert torch.equal(ours.anims.trans, ps.anims.trans)
    w, ssqrt, depth = 16, 2, 3
    _, vfov = gc.moving_floor_camera("cpu")
    jcam = jmake_camera(transformation=jfrom_lookat((0.0, 0.6, 2.5), (0.0, -0.5, 0.0)),
                        vfov_deg=vfov, width=w, height=w)
    jstatic = JSceneStatic.from_scene(js)
    aid = gc.MOVING_FLOOR_KEY
    vsel = jnp.zeros_like(js.tris.p0).at[:, 1].set((js.tris.anim == aid).astype(jnp.float32))
    ksel = jnp.zeros_like(js.anims.trans).at[aid, 1, 1].set(1.0)

    def jloss(dv, dk):
        T = js.tris
        sc = js._replace(tris=T._replace(p0=T.p0 + vsel * dv),
                         anims=js.anims._replace(trans=js.anims.trans + ksel * dk))
        img = jrender_frame(sc, jstatic, jcam, JCameraConfig(), JSensorRGB(), w, w, ssqrt, 0.0,
                            1.0, params=JRenderParams(max_path_components=depth,
                                                      differentiable=True),
                            samples_per_pass=ssqrt * ssqrt)
        return jnp.mean(img)

    jval, (jgv, jgk) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(0.0, 0.0)
    loss = gc.moving_floor_loss(ps, "cpu", w, ssqrt, depth)
    dv = torch.tensor(0.0, requires_grad=True)
    dk = torch.tensor(0.0, requires_grad=True)
    value = loss(dv, dk)
    gv, gk = torch.autograd.grad(value, (dv, dk))
    assert abs(float(value) - float(jval)) <= 1e-4 * float(jval)
    for got, ref in ((gv, jgv), (gk, jgk)):
        assert float(ref) > 0 and abs(float(got) - float(ref)) <= 2e-3 * abs(float(ref)), (
            float(got), float(ref))
    eps = 1e-2
    with torch.no_grad():
        fd_v = (float(loss(torch.tensor(eps), torch.tensor(0.0)))
                - float(loss(torch.tensor(-eps), torch.tensor(0.0)))) / (2 * eps)
        fd_k = (float(loss(torch.tensor(0.0), torch.tensor(eps)))
                - float(loss(torch.tensor(0.0), torch.tensor(-eps)))) / (2 * eps)
    assert abs(float(gv) - fd_v) <= 3e-2 * abs(fd_v) and abs(float(gk) - fd_k) <= 3e-2 * abs(fd_k)
