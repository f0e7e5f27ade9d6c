"""The ground-truth AOVs of the port (`render/aov.py` get_ground_truth)
against the JAX package's, on the CPU: tests/test_aov.py's three scenes (a
quad under a sphere light; the same quad with a tilted normal map; the quad
translating over [0, 1], its flows at t 0.5 to 0.0 and 1.0), each with every
channel of ALL_AOVS, built by each package's own builder.

Every channel equal to the JAX call's within atol 2e-5 (float32 rounding of
the camera's quaternion and the hit point; the normal map's bilinear lookup
under XLA's contracted FMAs, ROADMAP C.4), the integer channels and the hit
mask exactly; then tests/test_aov.py's own assertions on the port's
channels. Also the app-sized frames that `chip_smoke.py` holds to their JAX
yardsticks (kernel_check.AOV_FRAMES, at 64 x 64 here), channel by channel
against the JAX call: at most kernel_check.AOV_PARTS pixels apart (a tie at
a seam between two primitives, the normal map's lookups), the rest within
atol 2e-4.
"""

import functools
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig
from wurblpt_tpu import SceneStatic as JSceneStatic
from wurblpt_tpu import make_camera as jmake_camera
from wurblpt_tpu.core.transform import Transformation as JT
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
from wurblpt_tpu.render.aov import ALL_AOVS as JALL_AOVS
from wurblpt_tpu.render.aov import get_ground_truth as jget_ground_truth
from wurblpt_tpu.scene import builder as JB
from wurblpt_tpu.scene import generator as JG
from wurblpt_tpu_torch import ALL_AOVS, get_ground_truth
from wurblpt_tpu_torch.core.transform import Transformation, from_lookat
from wurblpt_tpu_torch.render.bsdf import SceneStatic
from wurblpt_tpu_torch.render.camera import CameraConfig, make_camera
from wurblpt_tpu_torch.scene import builder as B
from wurblpt_tpu_torch.scene import generator as G
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import jax_frame_reference as jfr  # noqa: E402

torch.set_num_threads(2)


def _quad_scene(M, T, Gen, normal_map=None, animated=False, **build):
    """tests/test_aov.py's quad (optionally normal-mapped or translating +0.5 x
    over [0, 1]) under a sphere light, in builder module M."""
    sc = M.Scene()
    aid = None
    if animated:
        aid = sc.take_animation(M.AnimationKeyframes(
            times=[0.0, 1.0], transformations=[T.make(translation=(0.0, 0.0, 0.0)),
                                               T.make(translation=(0.5, 0.0, 0.0))]))
    nm = None if normal_map is None else M.ImageTexture(image=normal_map, srgb=False)
    sc.take_mesh_instance(M.MeshInstance(mesh=Gen.generate_quad(1.0, 1.0),
                                         material=M.Lambertian(albedo=(0.8, 0.8, 0.8),
                                                               normal_map=nm),
                                         animation=aid))
    sc.take_sphere(M.SphereObject((0, 0, 5), 0.2, M.LightDiffuse(radiance=(5.0,) * 3)),
                   hot_spot=True)
    return sc.build(**build)


def _tilted_map():
    tilt = np.array([np.sin(0.5), 0.0, np.cos(0.5)])
    return np.full((4, 4, 3), (tilt + 1.0) / 2.0, np.float32)


# (normal map, animated, width, vfov, t, t_prev, t_next)
CASES = {"frames_and_depth": (None, False, 16, 40.0, 0.0, None, None),
         "normal_map": (_tilted_map(), False, 8, 40.0, 0.0, None, None),
         "translating_quad": (None, True, 32, 60.0, 0.5, 0.0, 1.0)}


@functools.lru_cache(maxsize=None)
def _both(name):
    nmap, animated, w, vfov, t, t_prev, t_next = CASES[name]
    js = _quad_scene(JB, JT, JG, nmap, animated)
    scene = _quad_scene(B, Transformation, G, nmap, animated, device="cpu")
    jcam = jmake_camera(transformation=jfrom_lookat((0, 0, 2), (0, 0, 0)), vfov_deg=vfov,
                        width=w, height=w)
    cam = make_camera(from_lookat((0, 0, 2), (0, 0, 0), device="cpu"), vfov, w, w, device="cpu")
    times = dict(t=t, t_prev=t_prev, t_next=t_next)
    jgt = jget_ground_truth(js, JSceneStatic.from_scene(js), jcam, JCameraConfig(), w, w,
                            aovs=JALL_AOVS, **times)
    gt = get_ground_truth(scene, SceneStatic.from_scene(scene), cam, CameraConfig(), w, w,
                          aovs=ALL_AOVS, device="cpu", **times)
    return w, gt, {k: np.asarray(v) for k, v in jgt.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_every_channel_matches_jax(name):
    _, gt, jgt = _both(name)
    assert tuple(ALL_AOVS) == tuple(JALL_AOVS) and set(gt) == set(jgt)
    for k, ref in jgt.items():
        got = gt[k].numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        if k in ("material_index", "hit_mask"):
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5, err_msg=k)


def test_aov_frames_and_depth():
    """tests/test_aov.py's first test on the port's channels."""
    w, gt, _ = _both("frames_and_depth")
    c = (w // 2, w // 2)
    for k in ("geometry_normal", "material_normal", "camera_geometry_normal"):
        np.testing.assert_allclose(gt[k].numpy()[c], [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(gt["depth"].numpy()[c], 2.0, atol=3e-3)
    np.testing.assert_allclose(gt["distance"].numpy()[c], 2.0, atol=3e-3)
    assert gt["hit_mask"].numpy()[c] == 1.0 and gt["material_index"].numpy()[c] == 0
    for tan, nrm in (("geometry_tangent", "geometry_normal"),
                     ("material_tangent", "material_normal"),
                     ("camera_geometry_tangent", "camera_geometry_normal"),
                     ("camera_material_tangent", "camera_material_normal")):
        a, b = gt[tan].numpy()[c], gt[nrm].numpy()[c]
        assert abs(np.linalg.norm(a) - 1.0) < 1e-4 and abs(float(a @ b)) < 1e-4


def test_aov_material_normal_differs_with_normal_map():
    w, gt, _ = _both("normal_map")
    c = (w // 2, w // 2)
    mn, mt = gt["material_normal"].numpy()[c], gt["material_tangent"].numpy()[c]
    np.testing.assert_allclose(gt["geometry_normal"].numpy()[c], [0, 0, 1], atol=1e-5)
    assert abs(mn[2] - np.cos(0.5)) < 2e-3 and abs(float(mt @ mn)) < 1e-4


def test_aov_pixel_flow_of_translating_quad():
    w, gt, _ = _both("translating_quad")
    c = (w // 2, w // 2)
    assert gt["hit_mask"].numpy()[c] == 1.0
    np.testing.assert_allclose(gt["world_flow_next"].numpy()[c], [0.25, 0, 0], atol=1e-4)
    np.testing.assert_allclose(gt["world_flow_prev"].numpy()[c], [-0.25, 0, 0], atol=1e-4)
    pf = gt["pixel_flow_next"].numpy()[c]
    assert pf[0] > 1.0 and abs(pf[1]) < 1e-3


def _app_frame(name, width=64):
    _, t, t_prev, t_next = kc.AOV_FRAMES[name]
    if name == "normalmap":
        js, (eye, center, vfov) = jfr.jax_example_scene("normalmap")
        scene = scenes.normalmap(device="cpu")
        pose, _ = scenes.normalmap_camera("cpu")
    else:
        js = jfr.jax_cornell_animated(t=t)
        scene = scenes.cornell_box_animated("cpu")
        pose, vfov = scenes.cornell_ref_camera("cpu")
        eye, center = (0.0, 1.0, 3.2), (0.0, 1.0, -1.0)
    times = dict(t=t, t_prev=t_prev, t_next=t_next)
    jcam = jmake_camera(transformation=jfrom_lookat(eye, center), vfov_deg=vfov, width=width,
                        height=width)
    jgt = jget_ground_truth(js, JSceneStatic.from_scene(js), jcam, JCameraConfig(), width, width,
                            aovs=JALL_AOVS, **times)
    gt = get_ground_truth(scene, SceneStatic.from_scene(scene),
                          make_camera(pose, vfov, width, width, device="cpu"), CameraConfig(),
                          width, width, aovs=ALL_AOVS, device="cpu", **times)
    return gt, {k: np.asarray(v) for k, v in jax.device_get(jgt).items()}


@pytest.mark.parametrize("name", list(kc.AOV_FRAMES))
def test_app_frames_match_jax_but_for_a_few_pixels(name):
    gt, jgt = _app_frame(name)
    assert set(gt) == set(jgt)
    parted = np.zeros(next(iter(jgt.values())).shape[:2], bool)
    for k, ref in jgt.items():
        got = gt[k].numpy().astype(np.float64).reshape(ref.shape[0], ref.shape[1], -1)
        diff = np.abs(got - ref.astype(np.float64).reshape(got.shape)).max(-1)
        parted |= diff > 2e-4
    assert parted.sum() <= kc.AOV_PARTS, parted.sum()
    assert gt["hit_mask"].sum() > 0.9 * parted.size
