"""The port's gradients against the JAX package's on the cases of
tests/test_gradients_breadth.py: GGX roughness, the sky's radiance scale
(an importance-sampled equirect map, K8T), ToF geometry (a wall's depth,
K3T through the optical path length), one texel of an albedo texture (the
bilinear lookup's gather backward) and the scale of a measured RGL
material's rgb table (K7T's tail form); and two the JAX package's tests do
not take: the sky's yaw (K8T's rotation term and its sample's backward)
and the RGL quad's camera height (the lane directions: K7T's full form with
K3T). The method and tolerances are tests/test_torch_gradients.py's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gradients import Case, _cam, _port, check, evaluate
from wurblpt_tpu import CameraConfig as JCameraConfig, RenderParams as JRenderParams
from wurblpt_tpu import SceneStatic as JSceneStatic, SensorRGB as JSensorRGB
from wurblpt_tpu import make_camera as jmake_camera
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
from wurblpt_tpu.render.integrator import render_frame as jrender_frame
from wurblpt_tpu.render.sensor import SensorTofAmcw as JSensorTofAmcw
from wurblpt_tpu.scene import builder as B
from wurblpt_tpu.scene import generator as JG
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import (CameraConfig, RenderParams, SceneStatic, SensorRGB,
                               SensorTofAmcw, render_frame)

torch.set_num_threads(2)

PARAMS3 = RenderParams(max_path_components=3, differentiable=True)
JPARAMS3 = JRenderParams(max_path_components=3, differentiable=True)


def _ggx_roughness():
    sc = B.Scene()
    sc.take_sphere(B.SphereObject((0.0, 0.0, 0.0), 0.5,
                                  B.GGX(albedo=(0.9, 0.9, 0.9), roughness=0.3)))
    sc.take_sphere(B.SphereObject((1.2, 1.5, 2.0), 0.4, B.LightDiffuse(radiance=(20.0,) * 3)),
                   hot_spot=True)
    js = sc.build()
    w = h = 16
    jcam = jmake_camera(transformation=jfrom_lookat((0, 0, 2.5), (0, 0, 0)), vfov_deg=40.0,
                        width=w, height=h)
    jstatic = JSceneStatic.from_scene(js)
    k = int(np.asarray(js.materials.typ).tolist().index(2))

    def jloss(r):
        p0 = js.materials.p0.at[k, 0].set(r).at[k, 1].set(r)
        img = jrender_frame(js._replace(materials=js.materials._replace(p0=p0)), jstatic, jcam,
                            JCameraConfig(), JSensorRGB(), w, h, 2, params=JPARAMS3)
        return jnp.mean(img)

    ps, cam = _port(js), _cam(jcam)
    static = SceneStatic.from_scene(ps)

    def loss(r):
        p0 = ps.materials.p0
        row = torch.cat([torch.stack([r, r]) + 0.0 * p0[k, :2], p0[k, 2:]])[None]
        p0 = torch.cat([p0[:k], row, p0[k + 1:]], 0)
        return render_frame(ps._replace(materials=ps.materials._replace(p0=p0)), static, cam,
                            CameraConfig(), SensorRGB(), w, h, 2, params=PARAMS3,
                            device="cpu").mean()

    return Case(jloss, loss, 0.3, 3e-2, 3e-1, rtol=2e-3)


def _envmap_radiance():
    js = jscenes.envmap_spheres(cube=False).build()
    w = h = 16
    jcam = jmake_camera(transformation=jfrom_lookat((0.0, 0.6, 4.0), (0, 0, 0)), vfov_deg=40.0,
                        width=w, height=h)
    jstatic = JSceneStatic.from_scene(js)

    def jloss(s):
        sc = js._replace(envmap=js.envmap._replace(image=js.envmap.image * s))
        return jnp.mean(jrender_frame(sc, jstatic, jcam, JCameraConfig(), JSensorRGB(), w, h, 2,
                                      params=JPARAMS3))

    ps, cam = _port(js), _cam(jcam)
    static = SceneStatic.from_scene(ps)

    def loss(s):
        sc = ps._replace(envmap=ps.envmap._replace(image=ps.envmap.image * s))
        return render_frame(sc, static, cam, CameraConfig(), SensorRGB(), w, h, 2,
                            params=PARAMS3, device="cpu").mean()

    return Case(jloss, loss, 1.0, 1e-2, 2e-2, rtol=2e-3)


def _tof_scene():
    sc = B.Scene()
    sc.take_mesh_instance(B.MeshInstance(
        mesh=JG.generate_quad(1.5, 1.5), material=B.Lambertian(albedo=(0.7,) * 3),
        transformation=B.Transformation.make(translation=(0.0, 0.0, 0.0))))
    sc.take_sphere(B.SphereObject((0.3, 0.3, 2.0), 0.08,
                                  B.LightTof(radiance_w=120.0, half_angle=np.pi / 3)),
                   hot_spot=True)
    return sc.build()


def _tof_geometry():
    js = _tof_scene()
    w = h = 8
    jcam = jmake_camera(transformation=jfrom_lookat((0, 0, 2.0), (0, 0, 0)), vfov_deg=50.0,
                        width=w, height=h)
    jstatic = JSceneStatic.from_scene(js)
    jsensor = JSensorTofAmcw(phase_index=1)
    electrons = jsensor.quantum_efficiency / jsensor.energy_per_electron

    def jloss(z):
        dz = jnp.zeros(3).at[2].set(z)
        tris = js.tris._replace(p0=js.tris.p0 + dz, v1=js.tris.v1 + dz, v2=js.tris.v2 + dz)
        img = jrender_frame(js._replace(tris=tris), jstatic, jcam, JCameraConfig(), jsensor,
                            w, h, 2, params=JPARAMS3)
        return jnp.mean(img[..., 0] - img[..., 1]) * electrons

    ps, cam = _port(js), _cam(jcam)
    static = SceneStatic.from_scene(ps)
    sensor = SensorTofAmcw(phase_index=1)

    def loss(z):
        dz = torch.stack([0.0 * z, 0.0 * z, z])
        tris = ps.tris._replace(p0=ps.tris.p0 + dz, v1=ps.tris.v1 + dz.detach(),
                                v2=ps.tris.v2 + dz.detach())
        img = render_frame(ps._replace(tris=tris), static, cam, CameraConfig(), sensor, w, h, 2,
                           params=PARAMS3, device="cpu")
        return (img[..., 0] - img[..., 1]).mean() * electrons

    return Case(jloss, loss, 0.0, 5e-3, 1.5e-1, fd_atol=1e-3)


def _lit_quad(material, table=None):
    """A 2.4 x 2.4 or 2 x 2 quad of `material` under a sphere light (the
    scenes of test_grad_texture_texel and test_grad_rgl_table_values)."""
    sc = B.Scene()
    if table is not None:
        sc.take_rgl_table("m", table)
    sc.take_mesh_instance(B.MeshInstance(mesh=JG.generate_quad(*((1.2, 1.2) if table else (1.0,
                                                                                          1.0))),
                                         material=material))
    sc.take_sphere(B.SphereObject((0.4, 0.9, 2.2) if table else (0.5, 0.8, 2.5), 0.3,
                                  B.LightDiffuse(radiance=(14.0,) * 3)), hot_spot=True)
    return sc.build()


def _texture_texel():
    tex = np.full((4, 4, 3), 0.5, np.float32)
    js = _lit_quad(B.Lambertian(albedo=B.ImageTexture(image=tex, srgb=False)))
    w = h = 16
    jcam = jmake_camera(transformation=jfrom_lookat((0, 0, 2.2), (0, 0, 0)), vfov_deg=45.0,
                        width=w, height=h)
    jstatic = JSceneStatic.from_scene(js)

    def jloss(s):
        img_data = js.textures.img_data.at[0, 1, 1, :].set(s)
        sc = js._replace(textures=js.textures._replace(img_data=img_data))
        return jnp.mean(jrender_frame(sc, jstatic, jcam, JCameraConfig(), JSensorRGB(), w, h, 2,
                                      params=JPARAMS3))

    ps, cam = _port(js), _cam(jcam)
    static = SceneStatic.from_scene(ps)

    def loss(s):
        img_data = ps.textures.img_data.clone()
        img_data[0, 1, 1, :] = s.to(torch.float16)
        sc = ps._replace(textures=ps.textures._replace(img_data=img_data))
        return render_frame(sc, static, cam, CameraConfig(), SensorRGB(), w, h, 2,
                            params=PARAMS3, device="cpu").mean()

    # the float16 texel stack quantizes the FD probe: the JAX test's large step
    return Case(jloss, loss, 0.5, 1.0 / 16, 8e-2)


def _rgl_table():
    from wurblpt_tpu.materials import rgl as jrgl

    from wurblpt_tpu_torch.utils.scenes import synthetic_rgl_fields

    fields = synthetic_rgl_fields()   # the JAX test's tables, seeds 1-5
    js = _lit_quad(B.RGLMaterial(table_name="m"), jrgl.load_rgl_material(fields))
    w = h = 12
    jcam = jmake_camera(transformation=jfrom_lookat((0, 0, 2.2), (0, 0, 0)), vfov_deg=45.0,
                        width=w, height=h)
    jstatic = JSceneStatic.from_scene(js)

    def jloss(s):
        sc = js._replace(rgl=js.rgl._replace(rgb=js.rgl.rgb * s))
        return jnp.mean(jrender_frame(sc, jstatic, jcam, JCameraConfig(), JSensorRGB(), w, h, 2,
                                      params=JPARAMS3))

    ps, cam = _port(js), _cam(jcam)
    static = SceneStatic.from_scene(ps)

    def loss(s):
        sc = ps._replace(rgl=ps.rgl._replace(rgb=ps.rgl.rgb * s))
        return render_frame(sc, static, cam, CameraConfig(), SensorRGB(), w, h, 2,
                            params=PARAMS3, device="cpu").mean()

    return Case(jloss, loss, 1.0, 1e-2, 3e-2)


def _envmap_rotation():
    """d(mean)/d(yaw) of envmap_spheres' equirect sky turned about +y, seen
    from grad_check.SKY_YAW_VIEW (the sun disk in the frame), at 16 x 16, 4
    spp, depth 3. The central difference (eps 1e-2) is held to 0.1: the
    attached estimator, the JAX package's as the port's, leaves out the
    boundary terms of what the yaw moves discontinuously, the shadow edges
    of the sun and the cells of the importance table (MIS weights), which
    the difference sees (0.4 % to 27 % apart at 16 x 16 and 32 x 32 over
    eps 2e-3 to 2e-2; 0.4 % at this size and eps)."""
    from wurblpt_tpu_torch.utils.grad_check import SKY_YAW, SKY_YAW_VIEW, yaw_rotation

    js = jscenes.envmap_spheres(cube=False).build()
    w = h = 16
    eye, target, vfov = SKY_YAW_VIEW
    jcam = jmake_camera(transformation=jfrom_lookat(eye, target), vfov_deg=vfov, width=w,
                        height=h)
    jstatic = JSceneStatic.from_scene(js)

    def jloss(yaw):
        q = jnp.stack([0.0 * yaw, jnp.sin(0.5 * yaw), 0.0 * yaw, jnp.cos(0.5 * yaw)])
        sc = js._replace(envmap=js.envmap._replace(rotation=q))
        return jnp.mean(jrender_frame(sc, jstatic, jcam, JCameraConfig(), JSensorRGB(), w, h, 2,
                                      params=JPARAMS3))

    ps, cam = _port(js), _cam(jcam)
    static = SceneStatic.from_scene(ps)

    def loss(yaw):
        sc = ps._replace(envmap=ps.envmap._replace(rotation=yaw_rotation(yaw)))
        return render_frame(sc, static, cam, CameraConfig(), SensorRGB(), w, h, 2,
                            params=PARAMS3, device="cpu").mean()

    return Case(jloss, loss, SKY_YAW, 1e-2, 0.1, rtol=2e-3)


def _rgl_direction():
    """d(mean)/d(camera height) of the RGL quad (12 x 12): the camera's
    translation moves the hits and with them the directions the RGL lanes
    see (K7T's full form, K3T)."""
    from wurblpt_tpu.materials import rgl as jrgl

    from wurblpt_tpu_torch.utils.scenes import synthetic_rgl_fields

    js = _lit_quad(B.RGLMaterial(table_name="m"), jrgl.load_rgl_material(synthetic_rgl_fields()))
    w = h = 12
    jcam = jmake_camera(transformation=jfrom_lookat((0, 0, 2.2), (0, 0, 0)), vfov_deg=45.0,
                        width=w, height=h)
    jstatic = JSceneStatic.from_scene(js)

    def jloss(dy):
        t = jcam.transformation
        c2 = jcam._replace(transformation=t._replace(
            translation=t.translation + jnp.array([0.0, 1.0, 0.0]) * dy))
        return jnp.mean(jrender_frame(js, jstatic, c2, JCameraConfig(), JSensorRGB(), w, h, 2,
                                      params=JPARAMS3))

    ps, cam = _port(js), _cam(jcam)
    static = SceneStatic.from_scene(ps)

    def loss(dy):
        t = cam.transformation
        c2 = cam._replace(transformation=t._replace(
            translation=t.translation + torch.tensor([0.0, 1.0, 0.0]) * dy))
        return render_frame(ps, static, c2, CameraConfig(), SensorRGB(), w, h, 2,
                            params=PARAMS3, device="cpu").mean()

    return Case(jloss, loss, 0.0, 1e-3, 3e-2)


CASES = {"ggx_roughness": _ggx_roughness, "envmap_radiance": _envmap_radiance,
         "tof_geometry": _tof_geometry, "texture_texel": _texture_texel,
         "rgl_table": _rgl_table, "envmap_rotation": _envmap_rotation,
         "rgl_direction": _rgl_direction}


@pytest.fixture(scope="module")
def results():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = evaluate(CASES[name]())
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradient_matches_jax_and_its_central_difference(results, name):
    check(results(name))


def test_rgl_table_gradient_is_positive(results):
    """Direct light dominates: the loss grows with the rgb table's scale."""
    _, _, g, _, _ = results("rgl_table")
    assert g > 0.0


def test_sky_gradient_is_the_loss(results):
    """All radiance comes from the sky: d(loss)/ds at s = 1 is loss(1)
    (rtol 5e-2, the JAX test's)."""
    _, _, g, loss, _ = results("envmap_radiance")
    np.testing.assert_allclose(g, loss, rtol=5e-2)
