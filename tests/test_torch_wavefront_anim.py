"""Rigid keyframe animation through the port's render_frame_wavefront, at
one shutter instant (t0 = t1), against the JAX package.

* cornell_animated (the reference Cornell box with the short box turning,
  the tall box and the light sliding; `jax_frame_reference.jax_cornell_animated`)
  at 24 x 24 pixels, 4 spp, 8 path components, t = 0.5: the JAX package
  casts it through its sweeps with object-space rays, and so does the port
  (KS1/KS2 plain versions, K3a's), on K4's diffuse class with the moving
  light in the frame's step tables. The cast counters are equal; pixels
  agree to rtol 1e-3 / atol 1e-5 (3.3e-6 absolute, 1.9e-4 relative
  measured: XLA's fused multiply-adds in the object rays and the sweep,
  ROADMAP C.4). On the CPU the K4 route (plain versions) renders the
  torch-op bounce's bits; on the card (marked `cuda`) K4's kernels match
  their plain versions on the frame's first block.
* The mirror of tests/test_animated_nee.py's first two tests (its scene):
  the moving lamp at t = 0.5 lights the floor as the static lamp placed
  there does, and the highlight follows the lamp from t = 0 to t = 1; and
  that frame against the JAX package's at t = 0.5 (equal counters).
* Animated hot spots: NEE samples and weights the light where it is at the
  frame's instant (`lights.light_frames`), with the mixture pdf (per-light MIS
  needs static lights), against the JAX package's.
* The BVH: cornell_animated_bvh (the animated box with its two spheres,
  one riding the short box's turn, in a BVH swept at t = 0.5;
  `jax_frame_reference.jax_cornell_animated(spheres=True, use_bvh=True)`)
  at 24 x 24, 4 spp, 8 path components, t = 0.5: the JAX package casts it
  through its BVH walk with object-space leaf rays, and so does the port
  (K5/K6's plain versions with the frame's animation rows), on K4's diffuse
  class. The cast counters are equal; pixels agree to rtol 1e-3 / atol
  1e-5. An animated quad in a BVH is cast where the JAX package casts it.
* What was refused before motion blur and animated cameras were ported: a
  shutter interval t0 != t1 is handed to render_frame (image and
  counters), an animated camera at one instant is posed once (the
  identity animation's frame equals the static camera's); an animated
  scene stays off K4's env and lit classes (the torch-op bounce renders
  it).
"""

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
from test_animated_nee import _light_room  # noqa: E402
from wurblpt_tpu import CameraConfig as JCameraConfig  # noqa: E402
from wurblpt_tpu import RenderParams as JRenderParams  # noqa: E402
from wurblpt_tpu import SceneStatic as JSceneStatic  # noqa: E402
from wurblpt_tpu import SensorRGB as JSensorRGB  # noqa: E402
from wurblpt_tpu import make_camera as jmake_camera  # noqa: E402
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat  # noqa: E402
from wurblpt_tpu.render import lights as jlights  # noqa: E402
from wurblpt_tpu.render.integrator import render_frame_wavefront as jrender  # noqa: E402
from wurblpt_tpu.scene.animation import make_anim_ctx as jmake_anim_ctx  # noqa: E402
from wurblpt_tpu.utils import scenes as jscenes  # noqa: E402
from wurblpt_tpu_torch import (  # noqa: E402
    CameraConfig,
    RenderParams,
    SceneStatic,
    SensorRGB,
    make_camera,
    render_frame_wavefront,
    scene_from_numpy,
)
from wurblpt_tpu_torch.core.transform import from_lookat  # noqa: E402
from wurblpt_tpu_torch import native  # noqa: E402
from wurblpt_tpu_torch.render import integrator, lights, wavefront  # noqa: E402
from wurblpt_tpu_torch.render.integrator import prepare_scene  # noqa: E402
from wurblpt_tpu_torch.render.intersect_sweep import SweepScene  # noqa: E402
from wurblpt_tpu_torch.scene.animation import anim_frames  # noqa: E402
from wurblpt_tpu_torch.utils import kernel_check as kc  # noqa: E402
from wurblpt_tpu_torch.utils import scenes  # noqa: E402

torch.set_num_threads(2)

W, SSQRT, DEPTH = 24, 2, 8


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return "cuda"


def _port(js):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")


def _jax_frame(js, pose, vfov, w, ssqrt, depth, t):
    img, stats = jrender(js, JSceneStatic.from_scene(js),
                         jmake_camera(transformation=pose, vfov_deg=vfov, width=w, height=w),
                         JCameraConfig(), JSensorRGB(), w, w, ssqrt, t, t,
                         params=JRenderParams(max_path_components=depth), return_stats=True)
    return np.asarray(img), np.asarray(stats).tolist()


def _port_frame(ps, pose, vfov, w, ssqrt, depth, t):
    img, stats = render_frame_wavefront(ps, SceneStatic.from_scene(ps),
                                        make_camera(pose, vfov, w, w, device="cpu"),
                                        CameraConfig(), SensorRGB(), w, w, ssqrt,
                                        params=RenderParams(max_path_components=depth),
                                        return_stats=True, device="cpu", t0=t, t1=t)
    return img.numpy(), stats.tolist()


def test_cornell_animated_matches_the_jax_frame():
    js = jfr.jax_cornell_animated()
    pose, vfov = jscenes.cornell_ref_camera()
    jimg, jstats = _jax_frame(js, pose, vfov, W, SSQRT, DEPTH, kc.ANIM_TIME)
    img, stats = kc.cornell_animated_frame("cpu", width=W, ssqrt=SSQRT, depth=DEPTH)()
    assert stats.tolist() == jstats
    np.testing.assert_allclose(img.numpy(), jimg, rtol=1e-3, atol=1e-5)
    # the animation moved the frame: t = 0 (the keys' rest poses) renders otherwise
    still, _ = kc._frame(scenes.cornell_box_animated("cpu"), scenes.cornell_ref_camera("cpu"),
                         W, W, SSQRT, DEPTH, "cpu", t=0.0)()
    assert np.abs(still.numpy() - img.numpy()).max() > 0.1 * img.numpy().max()


def test_the_animated_frame_takes_k4_and_the_sweeps():
    """The animated box is of K4's diffuse class, cast by the sweeps; its
    frame's step tables hold the light where it is at t = 0.5, and the
    shade refuses the scene's own tables, which hold its rest pose."""
    ps = scenes.cornell_box_animated("cpu")
    static = SceneStatic.from_scene(ps)
    assert static.has_anim and static.lights_animated and not static.per_light_mis
    static.check_slice()
    cfg = CameraConfig()
    assert wavefront.diffuse_class(ps, static, cfg)
    assert not (wavefront.env_class(ps, static, cfg) or wavefront.lit_class(ps, static, cfg))
    tables = prepare_scene(ps, static)
    assert isinstance(tables.accel, SweepScene) and tables.step is not None
    assert tables.accel.n_anims == 4 and tables.hit.n_anims == 4
    assert tables.step.lights_animated and tables.step.light_frames is None
    anim = integrator.frame_anim(ps, static, kc.ANIM_TIME)
    at = wavefront.step_tables_at(tables.step, anim.lights)
    assert wavefront.k4_route(at, cfg).shade is wavefront.shade_diffuse
    slid = torch.tensor([0.0, 0.0, kc.ANIM_TIME * kc.ANIM_LIGHT_SLIDE_Z])
    moved = at.light_tri[:, 0:3] - tables.step.light_tri[:, 0:3]
    assert torch.allclose(moved, slid.expand_as(moved), atol=1e-6)
    assert torch.allclose(at.light_tri[:, 3:], tables.step.light_tri[:, 3:], atol=1e-6)
    inp = kc.k4_inputs("cpu", "cornell_animated", width=8, ssqrt=2, m=2)
    assert inp.shade[0].light_frames is not None
    with pytest.raises(ValueError, match="lights move"):
        wavefront.shade_diffuse(tables.step, *inp.shade[1:])


def test_k4_route_gives_the_torch_op_bounce_bits_on_the_animated_frame(monkeypatch):
    """On the CPU the K4 route (plain versions with the frame's step tables)
    and the generic torch-op bounce render the animated frame bit for bit."""
    render = kc.cornell_animated_frame("cpu", width=W, ssqrt=SSQRT, depth=DEPTH)
    steps = []
    k4_step = integrator._make_k4_step

    def counting(*args):
        step = k4_step(*args)

        def run(*a):
            steps.append(1)
            return step(*a)
        return run

    monkeypatch.setattr(integrator, "_make_k4_step", counting)
    img, stats = render()
    assert len(steps) > 0
    monkeypatch.setattr(integrator, "diffuse_class", lambda *a: False)
    img_g, stats_g = render()
    assert torch.equal(img, img_g) and torch.equal(stats, stats_g)


@pytest.mark.cuda
def test_k4_kernels_match_plain_on_the_animated_block(gpu):
    """K4's regeneration, diffuse shade and resolve against their plain
    versions on the animated frame's first block after 2 steps (the casts
    KS1/KS2 and K3a, the moving light in the step tables): bit-equal."""
    inp = kc.k4_inputs(gpu, "cornell_animated")
    before = {k: native.LAUNCHES[k] for k in ("regen_pinhole", "shade_diffuse", "nee_resolve")}
    res = kc.check_k4(inp)
    torch.cuda.synchronize()
    assert {k: native.LAUNCHES[k] - v for k, v in before.items()} == dict.fromkeys(before, 1)
    for name, fields in res.items():
        assert all(v == 0 for v in fields.values()), (name, fields)


def _port_room(light_x, animate):
    return _port(_light_room(light_x, animate))


def _room_frame(ps, t):
    pose = from_lookat((0, 2.5, 3.5), (0, 0, 0), device="cpu")
    return _port_frame(ps, pose, 50.0, 24, 4, 4, t)


def test_animated_light_nee_matches_static():
    """The port's mirror of tests/test_animated_nee.py: the moving lamp at
    t = 0.5 (at x = 0) lights the floor as the static lamp at x = 0 does,
    with its full NEE contribution; and the frame is the JAX package's."""
    anim = _port_room(0.0, True)
    assert SceneStatic.from_scene(anim).lights_animated
    img_anim, stats = _room_frame(anim, 0.5)
    img_stat, _ = _room_frame(_port_room(0.0, False), 0.0)
    assert np.isfinite(img_anim).all()
    bright = img_stat.mean()
    assert abs(img_anim.mean() - bright) / bright < 0.05, (img_anim.mean(), bright)
    np.testing.assert_allclose(img_anim, img_stat, atol=0.25 * img_stat.max())
    jimg, jstats = _jax_frame(_light_room(0.0, True), jfrom_lookat((0, 2.5, 3.5), (0, 0, 0)),
                              50.0, 24, 4, 4, 0.5)
    assert stats == jstats
    np.testing.assert_allclose(img_anim, jimg, rtol=1e-3, atol=1e-5)


def test_animated_light_moves_highlight():
    """At t = 0 and t = 1 the lamp sits at x = -1 and x = +1: the floor's
    brightness follows it."""
    room = _port_room(0.0, True)
    img0, _ = _room_frame(room, 0.0)
    img1, _ = _room_frame(room, 1.0)
    w = img0.shape[1]
    left0, right0 = img0[:, : w // 2].mean(), img0[:, w // 2:].mean()
    left1, right1 = img1[:, : w // 2].mean(), img1[:, w // 2:].mean()
    assert left0 > right0 * 1.1, (left0, right0)
    assert right1 > left1 * 1.1, (left1, right1)


def test_nee_places_the_moving_light_where_it_is_at_the_rays_time():
    js = jfr.jax_cornell_animated()
    ps = _port(js)
    n = 2048
    rs = np.random.default_rng(4)
    origin = rs.uniform((-0.9, 0.05, -0.9), (0.9, 1.5, 0.9), (n, 3)).astype(np.float32)
    u3 = rs.uniform(size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 2, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jctx = jmake_anim_ctx(js.anims, jnp.full((n,), jnp.float32(kc.ANIM_TIME)), with_forward=True)
    jframes = jlights.light_frames(js, jctx)
    frames = lights.light_frames(ps, anim_frames(ps.anims, kc.ANIM_TIME))
    assert lights.light_anim_ids(ps).tolist() == [3, 3]
    np.testing.assert_allclose(frames[0].expand(n, -1, -1, -1).numpy(), np.asarray(jframes[0]),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(frames[1].expand(n, -1, -1).numpy(), np.asarray(jframes[1]),
                               rtol=0, atol=2e-6)
    ours = lights.lights_sample(ps, torch.as_tensor(origin), torch.as_tensor(u3), frames)
    ref = jlights.lights_sample(js, jnp.asarray(origin), jnp.asarray(u3), frames=jframes)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(ours[3].numpy(), np.asarray(ref[3]))
    for a, b in ((ours[0], ref[0]), (ours[2], ref[2]), (ours[4], ref[4])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    # the sampled points lie on the light where the animation has put it
    ext = (ours[0] * ours[2][:, None] + torch.as_tensor(origin))
    assert torch.allclose(ext[:, 1], torch.full((n,), 1.98), atol=1e-4)
    assert float(ext[:, 2].max()) > 0.16 + 0.05          # slid along +z (at rest: z <= 0.16)
    pdf = lights.lights_pdf_multi(ps, torch.as_tensor(origin), torch.as_tensor(d), frames)
    jpdf = jlights.lights_pdf_multi(js, jnp.asarray(origin), jnp.asarray(d), frames=jframes)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-4, atol=1e-6)
    assert (pdf > 0).any()


def test_motion_blur_is_refused():
    """No longer refused: over t0 != t1 render_frame_wavefront returns
    render_frame's image and counters (passes of integrator.pass_samples
    samples), as the JAX package's does."""
    ps = scenes.cornell_box_animated("cpu")
    pose, vfov = scenes.cornell_ref_camera("cpu")
    static, cam = SceneStatic.from_scene(ps), make_camera(pose, vfov, 8, 8, device="cpu")
    params = RenderParams(max_path_components=3)
    img, stats = render_frame_wavefront(ps, static, cam, CameraConfig(), SensorRGB(), 8, 8, 2,
                                        params, return_stats=True, device="cpu", t0=0.0,
                                        t1=1.0)
    per_pass = integrator.pass_samples(64, 4, 131072)
    assert per_pass == 4
    ref, ref_stats = integrator.render_frame(ps, static, cam, CameraConfig(), SensorRGB(), 8,
                                             8, 2, 0.0, 1.0, params, per_pass,
                                             return_stats=True, device="cpu")
    assert torch.equal(img, ref) and torch.equal(stats, ref_stats)


def test_animation_in_a_bvh_scene_is_cast_and_rendered_as_jax():
    """An animated quad in a BVH (the scene the slice refused before the
    BVH's object-space leaves), swept over [0.5, 0.5]: it passes the slice,
    its camera rays at t = 0.5 hit the moved quad where the JAX package's
    BVH walk with object-space rays hits it (prim ids and t), and its frame
    renders as the JAX package's (equal counters; unlit, so black)."""
    from wurblpt_tpu.accel.traverse import bvh_closest_hit as jbvh_closest_hit
    from wurblpt_tpu.core.transform import Transformation
    from wurblpt_tpu.scene import builder as B
    from wurblpt_tpu.scene.generator import generate_quad

    from wurblpt_tpu_torch.accel import traverse

    sc = B.Scene()
    m = sc.take_material(B.Lambertian(albedo=(0.5, 0.5, 0.5)))
    a = sc.take_animation(B.AnimationKeyframes([0.0, 1.0], [
        Transformation.make(translation=(0.0, y, 0.0)) for y in (0.0, 1.0)]))
    sc.take_mesh_instance(B.MeshInstance(generate_quad(), m, animation=a))
    js = sc.build(use_bvh=True, t0=0.5, t1=0.5)
    ps = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu", 0.5, 0.5)
    assert ps.has_bvh and ps.n_anims == 2 and ps.bvh.n_anims == 2
    static = SceneStatic.from_scene(ps)
    static.check_slice()
    pose, vfov = scenes.cornell_ref_camera("cpu")
    rays = kc.camera_lanes(16, 16, 1, "cpu", camera=(pose, vfov))
    t, prim, _, _ = traverse.bvh_closest_hit_plain(ps.bvh, *rays, kc.frames_at(ps))
    ctx = jmake_anim_ctx(js.anims, jnp.full((rays[0].shape[0],), jnp.float32(0.5)))
    obj = ctx.ray_to_object(jnp.asarray(rays[0].numpy()), jnp.asarray(rays[1].numpy()))
    jt, jprim, _, _ = jbvh_closest_hit(js, *(jnp.asarray(r.numpy()) for r in rays),
                                       obj_rays=obj)
    np.testing.assert_array_equal(prim.numpy(), np.asarray(jprim))
    hit = prim.numpy() >= 0
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(jt)[hit], rtol=1e-5)
    assert 0 < hit.sum() < hit.size
    # at rest (t = 0) the quad sits lower: another set of pixels hit it
    still, _, _, _ = traverse.bvh_closest_hit_plain(
        scene_from_numpy(jax.tree_util.tree_map(np.asarray, sc.build(use_bvh=True)),
                         "cpu").bvh, *rays, anim_frames(ps.anims, 0.0))
    assert not torch.equal(still < kc.BIG, t < kc.BIG)
    jimg, jstats = _jax_frame(js, jscenes.cornell_ref_camera()[0], vfov, 8, 1, 3, 0.5)
    img, stats = _port_frame(ps, pose, vfov, 8, 1, 3, 0.5)
    assert stats == jstats and float(np.abs(img - jimg).max()) == 0.0


def test_cornell_animated_bvh_matches_the_jax_frame():
    """The animated box with its two spheres in a BVH swept at t = 0.5,
    against the JAX package's frame of the same build: equal counters,
    pixels within rtol 1e-3 / atol 1e-5 (XLA's fused multiply-adds in the
    object rays, C.4), on K4's diffuse class casting through the BVH."""
    js = jfr.jax_cornell_animated(spheres=True, use_bvh=True, t=kc.ANIM_TIME)
    pose, vfov = jscenes.cornell_ref_camera()
    jimg, jstats = _jax_frame(js, pose, vfov, W, SSQRT, DEPTH, kc.ANIM_TIME)
    ps = scenes.cornell_box_animated("cpu", spheres=True, use_bvh=True)
    static = SceneStatic.from_scene(ps)
    assert ps.has_bvh and wavefront.diffuse_class(ps, static, CameraConfig())
    assert prepare_scene(ps, static).accel is ps.bvh
    img, stats = kc.cornell_animated_bvh_frame("cpu", ps, width=W, ssqrt=SSQRT, depth=DEPTH)()
    assert stats.tolist() == jstats
    np.testing.assert_allclose(img.numpy(), jimg, rtol=1e-3, atol=1e-5)
    # the spheres change the frame: the box without them renders otherwise
    bare, _ = kc.cornell_animated_frame("cpu", width=W, ssqrt=SSQRT, depth=DEPTH)()
    assert (np.abs(bare.numpy() - img.numpy()) > 1e-2).any(-1).mean() > 0.05


@pytest.mark.parametrize("cls", ["env", "lit"])
def test_animation_keeps_a_scene_off_the_env_and_lit_classes(cls):
    """K4's env and lit classes take no animation (ROADMAP A.8: only with a
    bench cell that holds one): a scene of either class with one animated
    triangle in its BVH leaves the class and renders on the torch-op bounce."""
    from wurblpt_tpu_torch.render.camera import SurroundMode

    if cls == "env":
        scene = scenes.terrain_city(seed=3, terrain_res=8, n_buildings=2, sphere_slices=4,
                                    device="cpu")
        cfg = CameraConfig()
        in_class = wavefront.env_class
    else:
        scene = scenes.city_night(seed=7, terrain_res=12, n_buildings=3, n_windows=8,
                                  sphere_slices=6, device="cpu")
        cfg = CameraConfig(surround=SurroundMode.S360, stereo=True)
        in_class = wavefront.lit_class
    assert in_class(scene, SceneStatic.from_scene(scene), cfg)
    moving = scene.tris.anim.clone()
    moving[0] = 1
    anims = scenes.cornell_box_animated("cpu").anims
    animated = scene._replace(tris=scene.tris._replace(anim=moving), anims=anims)
    static = SceneStatic.from_scene(animated)
    static.check_slice()
    assert static.has_anim and not in_class(animated, static, cfg)
    assert not (wavefront.diffuse_class(animated, static, cfg)
                or wavefront.env_class(animated, static, cfg)
                or wavefront.lit_class(animated, static, cfg))
    assert prepare_scene(animated, static).step is None


def test_an_animated_camera_is_refused():
    """No longer refused: an animated camera at one instant is posed once
    on the host (camera.static_pose) and the frame keeps K4's route; on the
    identity animation (row 0) the pose is the static camera's bit for bit,
    and so is the frame. tests/test_torch_dof.py holds animated cameras to
    the JAX package's."""
    ps = scenes.cornell_box_animated("cpu")
    pose, vfov = scenes.cornell_ref_camera("cpu")
    static, cam = SceneStatic.from_scene(ps), make_camera(pose, vfov, 8, 8, device="cpu")
    frames = [render_frame_wavefront(ps, static, cam, CameraConfig(anim_id=a), SensorRGB(), 8,
                                     8, 1, return_stats=True, device="cpu", t0=0.5, t1=0.5)
              for a in (0, -1)]
    assert torch.equal(frames[0][0], frames[1][0]) and torch.equal(frames[0][1], frames[1][1])
