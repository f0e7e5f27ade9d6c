"""The gradients of a measured RGL material's tables and of its lanes'
directions: the port's (K7T's full form; its plain version, autograd
through K7's plain forward, on the CPU) against `jax.grad` of the JAX
package's.

* Per lane: rgl_eval on tests/test_torch_rgl.py's two random materials
  (P = 2 and 1, T = 3 and 2 padded: phi_i's grid reaches a gradient, which
  the render's material, P = 1, does not), the gradients of every float
  table and of wi and wo from random cotangents of f*cos and the pdf, each
  within 1e-3 of its largest |entry| (float32 on both sides, other roundings
  of the same formulas; 1.7e-5 seen). The repo has no anisotropic table
  (isotropic means P <= 2), so phi_i is checked on this isotropic P = 2
  grid only.
* Per entry: tests/test_gradients_breadth.py's RGL quad (12 x 12, 4 spp, 3
  path components), the mean's gradient with respect to each of the ten
  float tables that jax.grad reaches, every entry within 1e-2 of its table's
  largest |entry| (2e-4 seen), and the count of entries above 1e-6 of that
  largest equal to jax.grad's: theta_i 2, ndf 102, sigma 117, vndf_data 204,
  vndf_marg 30, vndf_cond 194, lum_data 70, lum_marg 6, lum_cond 24, rgb
  210 (jax_frame_reference.py rgl_grad_tables); no entry is allowed to part.
  The JAX side is jitted once (a module fixture).
* The grad phase's RGL steps (grad_check.rgl_table_loss, rgl_tables_loss,
  built at 128 x 128 and 16 spp on the card) at this quad's 12 x 12 and 4
  spp: the mean and d(mean)/d(rgb scale) (jax.grad's rgb gradient
  contracted with the table) within grad_check.SCALAR_REL, every table
  entry by entry and by grad_check.check_rgl_table_grads' digest against
  jax.grad's, and grad_check.rgl_quad_lanes' capture of K7T's inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gradients import _cam, _port
from test_torch_rgl import _lanes, _t, _tables
from wurblpt_tpu import CameraConfig as JCameraConfig, RenderParams as JRenderParams
from wurblpt_tpu import SceneStatic as JSceneStatic, SensorRGB as JSensorRGB
from wurblpt_tpu import make_camera as jmake_camera
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
from wurblpt_tpu.materials import rgl as jrgl
from wurblpt_tpu.render.integrator import render_frame as jrender_frame
from wurblpt_tpu.scene import builder as B
from wurblpt_tpu.scene import generator as JG
from wurblpt_tpu_torch import CameraConfig, RenderParams, SceneStatic, SensorRGB, render_frame
from wurblpt_tpu_torch.materials import rgl
from wurblpt_tpu_torch.utils.scenes import synthetic_rgl_fields

torch.set_num_threads(2)

# entries above 1e-6 of each table's largest |entry| in jax.grad of the RGL quad's mean
JAX_COUNTS = {"theta_i": 2, "ndf": 102, "sigma": 117, "vndf_data": 204, "vndf_marg": 30,
              "vndf_cond": 194, "lum_data": 70, "lum_marg": 6, "lum_cond": 24, "rgb": 210}


def test_lane_gradients_match_jax():
    """rgl_eval's gradients on the two random materials, lane by lane."""
    jt, tt = _tables("two random")
    mid, wi, wo, _ = _lanes(4096, tt.count, seed=5)
    rs = np.random.default_rng(6)
    g_f = rs.normal(size=(len(mid), 4)).astype(np.float32)
    g_pdf = rs.normal(size=len(mid)).astype(np.float32)
    names = rgl.GRAD_TABLES

    def jloss(tabs, wi_, wo_):
        f, p = jrgl.rgl_eval(jt._replace(**tabs), jnp.asarray(mid), wi_, wo_)
        return jnp.sum(f * g_f) + jnp.sum(p * g_pdf)

    jg = jax.grad(jloss, argnums=(0, 1, 2))({k: getattr(jt, k) for k in names},
                                           jnp.asarray(wi), jnp.asarray(wo))
    jref = {**jg[0], "wi": jg[1], "wo": jg[2]}
    got = rgl.rgl_bwd_plain(tt, _t(mid), _t(wi), _t(wo), _t(g_f), False, full=True,
                            g_pdf=_t(g_pdf))
    for k, a in got.items():
        b = np.asarray(jref[k])
        scale = np.abs(b).max()
        assert scale > 0 or k in ("lum_marg", "lum_cond"), k   # eval reads no luminance CDF
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-3 * scale + 1e-30, err_msg=k)
    assert float(np.abs(np.asarray(jref["phi_i"])).max()) > 0


@functools.lru_cache(maxsize=None)
def _quad():
    """(the JAX scene, the port's scene, the JAX and the port's cameras) of the RGL quad."""
    sc = B.Scene()
    sc.take_rgl_table("m", jrgl.load_rgl_material(synthetic_rgl_fields()))
    sc.take_mesh_instance(B.MeshInstance(mesh=JG.generate_quad(1.2, 1.2),
                                         material=B.RGLMaterial(table_name="m")))
    sc.take_sphere(B.SphereObject((0.4, 0.9, 2.2), 0.3, B.LightDiffuse(radiance=(14.0,) * 3)),
                   hot_spot=True)
    js = sc.build()
    jcam = jmake_camera(transformation=jfrom_lookat((0, 0, 2.2), (0, 0, 0)), vfov_deg=45.0,
                        width=12, height=12)
    return js, _port(js), jcam, _cam(jcam)


@pytest.fixture(scope="module")
def quad_grads():
    """(jax.grad, the port's gradient) of the RGL quad's mean with respect to
    every float table, name -> numpy array, and JAX's mean."""
    js, ps, jcam, cam = _quad()
    jstatic = JSceneStatic.from_scene(js)
    jp = JRenderParams(max_path_components=3, differentiable=True)

    def jloss(tabs):
        return jnp.mean(jrender_frame(js._replace(rgl=js.rgl._replace(**tabs)), jstatic, jcam,
                                      JCameraConfig(), JSensorRGB(), 12, 12, 2, params=jp))

    jmean, jg = jax.jit(jax.value_and_grad(jloss))({k: getattr(js.rgl, k)
                                                     for k in rgl.GRAD_TABLES})
    leaves = {k: getattr(ps.rgl, k).clone().requires_grad_(True) for k in rgl.GRAD_TABLES}
    sc = ps._replace(rgl=ps.rgl._replace(**leaves))
    render_frame(sc, SceneStatic.from_scene(sc), cam, CameraConfig(), SensorRGB(), 12, 12, 2,
                 params=RenderParams(max_path_components=3, differentiable=True),
                 device="cpu").mean().backward()
    return ({k: np.asarray(v) for k, v in jg.items()},
            {k: v.grad.numpy() for k, v in leaves.items()}, float(jmean))


@pytest.mark.parametrize("name", rgl.GRAD_TABLES)
def test_quad_table_gradient_matches_jax_entry_by_entry(quad_grads, name):
    jg, g = quad_grads[0][name], quad_grads[1][name]
    scale = np.abs(jg).max()
    if name == "phi_i":   # P = 1: its weight is 0 whatever phi_i holds
        assert scale == 0 and np.abs(g).max() == 0
        return
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-2 * scale)
    assert int((np.abs(jg) > 1e-6 * scale).sum()) == JAX_COUNTS[name]
    assert int((np.abs(g) > 1e-6 * scale).sum()) == JAX_COUNTS[name]


def _digest(jg):
    """RGL_TABLE_REFS' digest of jax.grad's tables (phi_i apart)."""
    out = {}
    for k, a in jg.items():
        a = np.asarray(a, np.float64)
        m = np.abs(a).max()
        if k != "phi_i":
            out[k] = (int((np.abs(a) > 1e-6 * m).sum()), float(a.sum()), float(np.abs(a).sum()),
                      float(m))
    return out


def test_rgl_scale_step_matches_jax(quad_grads):
    """grad_check.rgl_table_loss, the tail-form step the card runs at 128 x
    128: its mean and d(mean)/d(rgb scale) at 12 x 12 against JAX's."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    jg, _, jmean = quad_grads
    ref = float((np.asarray(_quad()[1].rgl.rgb, np.float64) * jg["rgb"]).sum())
    s = torch.tensor(1.0, requires_grad=True)
    value = gc.rgl_table_loss("cpu", 12, 2)(s)
    value.backward()
    assert abs(float(value) - jmean) <= gc.SCALAR_REL * abs(jmean)
    assert abs(float(s.grad) - ref) <= gc.SCALAR_REL * abs(ref)


def test_rgl_tables_step_matches_jax(quad_grads):
    """grad_check.rgl_tables_loss, the full-form step the card runs at 128 x
    128: every table's gradient at 12 x 12 entry by entry (1e-2 of its
    largest |entry|) and by check_rgl_table_grads' digest against jax.grad."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    jg = quad_grads[0]
    quad = _quad()[1]
    leaves = [getattr(quad.rgl, k).clone().requires_grad_(True) for k in rgl.GRAD_TABLES]
    gc.rgl_tables_loss("cpu", 12, 2)(*leaves).backward()
    got = {k: x.grad for k, x in zip(rgl.GRAD_TABLES, leaves)}
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), jg[k], rtol=0, atol=1e-2 * np.abs(jg[k]).max(),
                                   err_msg=k)
    rel = gc.check_rgl_table_grads(got, _digest(jg))
    assert max(rel.values()) <= gc.TABLE_REL


def test_rgl_quad_lanes_capture_k7t_inputs():
    """grad_check.rgl_quad_lanes at 12 x 12: K7T's eval and sample inputs of
    the first bounce, a lane per sample of the pass (576), with the full
    form's cotangents, some lanes of each carrying one; the plain full
    form on them finite."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    calls = gc.rgl_quad_lanes("cpu", 12, 2)
    assert set(calls) == {"eval", "sample"}
    for kind, (tables, mid, wi, x, g_f, g_pdf, g_wo) in calls.items():
        sample = kind == "sample"
        assert mid.shape == (576,) and x.shape == (576, 2 if sample else 3)
        assert (g_wo is not None) == sample and g_pdf.shape == (576,)
        carry = (g_f != 0).any(-1) | (g_pdf != 0)
        assert bool(carry.any()), kind
        out = rgl.rgl_bwd(tables, mid, wi, x, g_f, sample, full=True, g_pdf=g_pdf, g_wo=g_wo)
        assert all(bool(torch.isfinite(v).all()) for v in out.values()), kind
