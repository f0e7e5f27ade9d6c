"""The city path of the port against the JAX package (bench config
city_many_lights, at a small size).

* The port's `city_night` equals the JAX build field by field after the
  OBJ/MTL round trip, BVH, RGL tables and per-light MIS rows included; the
  sky's importance tables come from the port's own radiance lookup on the
  CPU (pdf table and acceptance probabilities to rtol 1e-5, as for the mesh
  path's sky).
* Analogs of tests/test_city_roundtrip.py: the round trip keeps the hot
  spots, the triangle count, the power-weighted pick and the bounds.
* Analog of tests/test_many_lights.py's per-light identities, on triangle
  lights (the port's slice has no sphere lights): pick probability x the
  picked light's pdf, and `lights_pdf_at_hit` of a ray that hits a light,
  equal the mixture pdf where one light is hit, and equal JAX's.
* The small city rendered by both packages at 48 x 24 pixels, 360-degree
  stereo, 1 spp, depth 4: cast counters equal, mean within 1e-5 relative,
  at least 99.5 % of the pixels within rtol 1e-3 / atol 1e-4 (on this frame
  all of them are: no BVH tie and no ModPhong `pow` ulp moves a pixel).
"""

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
from wurblpt_tpu.core.transform import Transformation as JTransformation
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
from wurblpt_tpu.render import lights as jlights
from wurblpt_tpu.render.camera import SurroundMode as JSurroundMode
from wurblpt_tpu.render.integrator import render_frame_wavefront as jrender
from wurblpt_tpu.scene import builder as B
from wurblpt_tpu.scene import generator as JG
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import (
    CameraConfig,
    RenderParams,
    SceneStatic,
    SensorRGB,
    make_camera,
    render_frame_wavefront,
    scene_from_numpy,
)
from wurblpt_tpu_torch.core.transform import Transformation
from wurblpt_tpu_torch.render import lights
from wurblpt_tpu_torch.render.camera import SurroundMode
from wurblpt_tpu_torch.render.intersect import assemble_hit, build_hit_tables, scene_raw_hit
from wurblpt_tpu_torch.render.intersect_brute import build_brute_scene
from wurblpt_tpu_torch.scene import generator as G
from wurblpt_tpu_torch.scene.flatten import flatten_meshes, material_table
from wurblpt_tpu_torch.scene.ir import MaterialType
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

SMALL = dict(terrain_res=24, n_buildings=12, n_windows=12, sphere_slices=6)
W, H = 48, 24


def _port_of(jax_scene):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, jax_scene), "cpu")


@pytest.fixture(scope="module")
def small():
    """(JAX scene, the port's scene carried from it, the port's own build)."""
    jscene = jscenes.city_night(seed=7, **SMALL).build(use_bvh=True)
    return jscene, _port_of(jscene), scenes.city_night(seed=7, **SMALL, device="cpu")


def _assert_same(a, b, path="scene"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b) or (a.dtype == torch.float32 and torch.equal(
            a.view(torch.int32), b.view(torch.int32))), path
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        for f in a._fields:
            _assert_same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    else:
        assert a == b, path


def test_city_night_equals_jax_build_field_by_field(small):
    _, ref, ours = small
    for f in ("pdf_table", "alias_prob"):
        np.testing.assert_allclose(getattr(ours.envmap, f).numpy(),
                                   getattr(ref.envmap, f).numpy(), rtol=1e-5)
    _assert_same(ours, ref._replace(envmap=ref.envmap._replace(
        pdf_table=ours.envmap.pdf_table, alias_prob=ours.envmap.alias_prob)))
    typ = ours.materials.typ.tolist()
    # ground + 12 GGX-turned-Lambertian spheres; 12 buildings + 12 windows +
    # 7 mirrors as ModPhong; one RGL sphere
    assert typ.count(MaterialType.LAMBERTIAN) == 14 and typ.count(MaterialType.MODPHONG) == 31
    assert typ[-1] == MaterialType.RGL and ours.materials.rgl_id[-1] == 0
    assert ours.n_lights == 24 and SceneStatic.from_scene(ours).per_light_mis


def test_city_roundtrip_preserves_lights_scale_and_picks():
    kw = dict(terrain_res=60, n_buildings=24, n_windows=66, sphere_slices=8)
    direct = jscenes.city_night(obj_roundtrip=False, **kw).build(use_bvh=False)
    rt = scenes.city_night(**kw, device="cpu")
    assert rt.n_lights == direct.n_lights == 132
    assert rt.n_tris == direct.n_tris       # the RGL sphere comes after the round trip in both
    w = rt.light_weights.numpy()
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-5)
    assert w.max() / w.min() > 5.0
    np.testing.assert_array_equal(rt.prim_light_pick[rt.light_prims.long()].numpy(), w)
    d, r = np.asarray(direct.tris.p0), rt.tris.p0.numpy()
    np.testing.assert_allclose(d.min(0), r.min(0), atol=1e-3)
    np.testing.assert_allclose(d.max(0), r.max(0), atol=1e-3)
    assert rt.env_kind == 1 and rt.envmap.importance and rt.rgl is not None


def _two_lights(jax_side: bool):
    """A floor quad and two separated quad lights, built by either package."""
    if jax_side:
        sc = B.Scene()
        sc.take_mesh_instance(B.MeshInstance(JG.generate_quad(2.0, 2.0),
                                             B.Lambertian(albedo=(0.7,) * 3)))
        for t, r in (((-1.0, 0.5, 2.0), 9.0), ((1.2, 0.8, 1.5), 3.0)):
            sc.take_mesh_instance(B.MeshInstance(
                JG.generate_quad(0.4, 0.4), B.LightDiffuse(radiance=(r,) * 3),
                JTransformation.make(translation=t)), hot_spot=True)
        return sc.build()
    rows = [(MaterialType.LAMBERTIAN, (0.7,) * 3, None),
            (MaterialType.LIGHT_DIFFUSE, (9.0,) * 3, None),
            (MaterialType.LIGHT_DIFFUSE, (3.0,) * 3, None)]
    meshes = [G.generate_quad(2.0, 2.0)]
    for i, t in enumerate(((-1.0, 0.5, 2.0), (1.2, 0.8, 1.5))):
        meshes.append(G.generate_quad(0.4, 0.4)._replace(
            material=i + 1, hot_spot=True, transformation=Transformation.make(translation=t)))
    return flatten_meshes(meshes, material_table(rows), "cpu")


def test_per_light_pdf_matches_mixture_and_jax():
    jscene = _two_lights(True)
    scene = _two_lights(False)
    _assert_same(scene, _port_of(jscene))
    n = 4096
    u3 = np.random.default_rng(2).random((n, 3)).astype(np.float32)
    origin = np.tile(np.array([[0.1, -0.3, 0.2]], np.float32), (n, 1))
    ldir, _, _, lpick, pdf_sa = lights.lights_sample(scene, torch.from_numpy(origin),
                                                     torch.from_numpy(u3))
    per = lights.light_pick_prob_of(scene, lpick) * pdf_sa
    assert float((per > 0).float().mean()) > 0.99
    o = torch.from_numpy(origin)
    t, prim, u, v = scene_raw_hit(build_brute_scene(scene), o, ldir.contiguous(),
                                  torch.full((n,), 1e-4), torch.full((n,), 3e37))
    hr = assemble_hit(build_hit_tables(scene), o, ldir.contiguous(), t, prim, u, v)
    lp_hit = lights.lights_pdf_at_hit(lights.pick_area_table(scene), ldir, t, prim,
                                      hr.geom_normal)
    mix = lights.lights_pdf_multi(scene, o, ldir[:, None])[:, 0]
    sel = prim == scene.light_prims[lpick.long()]
    assert float(sel.float().mean()) > 0.8
    np.testing.assert_allclose(lp_hit[sel].numpy(), mix[sel].numpy(), rtol=2e-3)
    np.testing.assert_allclose(lp_hit[sel].numpy(), per[sel].numpy(), rtol=2e-3)
    j = jlights.lights_pdf_at_hit(jscene, jnp.asarray(origin), jnp.asarray(ldir.numpy()),
                                  jnp.asarray(t.numpy()), jnp.asarray(prim.numpy()),
                                  jnp.asarray(hr.geom_normal.numpy()))
    np.testing.assert_allclose(lp_hit.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_small_city_render_matches_jax(small):
    jscene, _, scene = small
    jcam = jmake_camera(transformation=jfrom_lookat((0.0, 3.5, 14.0), (0.0, 1.5, 0.0)),
                        vfov_deg=50.0, width=W, height=H, eye_distance=0.065)
    jimg, jstats = jrender(jscene, JSceneStatic.from_scene(jscene), jcam,
                           JCameraConfig(surround=JSurroundMode.S360, stereo=True), JSensorRGB(),
                           W, H, 1, params=JRenderParams(max_path_components=4),
                           return_stats=True)
    pose, vfov = scenes.city_camera("cpu")
    cam = make_camera(pose, vfov, W, H, eye_distance=0.065, device="cpu")
    img, stats = render_frame_wavefront(scene, SceneStatic.from_scene(scene), cam,
                                        CameraConfig(surround=SurroundMode.S360, stereo=True),
                                        SensorRGB(), W, H, 1,
                                        params=RenderParams(max_path_components=4),
                                        return_stats=True, device="cpu")
    jimg, img = np.asarray(jimg), img.numpy()
    assert stats.tolist() == np.asarray(jstats).tolist()
    assert abs(float(img.mean()) - float(jimg.mean())) <= 1e-5 * float(jimg.mean())
    close = np.isclose(img, jimg, rtol=1e-3, atol=1e-4).all(-1)
    assert close.mean() >= 0.995, np.argwhere(~close).tolist()
    assert np.isfinite(img).all() and (img > 0).mean() > 0.9
