"""The ToF path of the port (bench config tof_amcw) against the JAX package on
the CPU: SensorTofAmcw, the spot and ToF light materials with their cone,
generate_disk, the tof_box scene, a small render in all four phases and the
4-phase distance at depth 1.

Inputs are made with numpy from a seed and go through both packages; the
tolerances are stated where they are used (XLA contracts a * b + c into
FMAs on the CPU, so floats agree to a few ulps, not bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig, RenderParams as JRenderParams
from wurblpt_tpu import SceneStatic as JSceneStatic, make_camera as jmake_camera
from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
from wurblpt_tpu.render import bsdf as jbsdf
from wurblpt_tpu.render import integrator as jintegrator
from wurblpt_tpu.render.intersect import HitRecord as JHitRecord
from wurblpt_tpu.render.integrator import render_frame_wavefront as jrender
from wurblpt_tpu.render.sensor import SensorEvent as JSensorEvent
from wurblpt_tpu.render.sensor import SensorTofAmcw as JSensorTofAmcw
from wurblpt_tpu.scene import builder as jbuilder
from wurblpt_tpu.scene import generator as jgenerator
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import SceneStatic, SensorTofAmcw
from wurblpt_tpu_torch.core.constants import SPEED_OF_LIGHT
from wurblpt_tpu_torch.render import bsdf
from wurblpt_tpu_torch.render.intersect import HitRecord
from wurblpt_tpu_torch.render.sensor import SensorEvent
from wurblpt_tpu_torch.render.wavefront import light_emitted_at
from wurblpt_tpu_torch.scene import generator
from wurblpt_tpu_torch.scene.flatten import MeshSpec, flatten_meshes, material_table
from wurblpt_tpu_torch.scene.ir import MaterialFlags, MaterialType
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

W = 24
SSQRT = 2
DEPTH = 6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# SensorTofAmcw
# ---------------------------------------------------------------------------

def _events(n, seed):
    """Seeded events: NIR radiance up to 1e-3, optical path lengths up to 20 m
    (beyond the 7.5 m ambiguity range at 20 MHz), a fifth inactive."""
    rs = np.random.default_rng(seed)
    rad = rs.uniform(0.0, 1e-3, (n, 4)).astype(np.float32)
    opl = rs.uniform(0.0, 20.0, (n, 4)).astype(np.float32)
    dtl = rs.uniform(0.0, 3.0, n).astype(np.float32)
    active = rs.uniform(size=n) > 0.2
    pc = np.zeros(n, np.int32)
    jev = JSensorEvent(jnp.asarray(rad), jnp.asarray(pc), jnp.asarray(opl[:, 3]),
                       jnp.asarray(opl), jnp.asarray(dtl), jnp.asarray(active))
    ev = SensorEvent(torch.as_tensor(rad), torch.as_tensor(pc), torch.as_tensor(opl[:, 3]),
                     torch.as_tensor(opl), torch.as_tensor(dtl), torch.as_tensor(active))
    return jev, ev


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_accumulate_and_finish_match_jax(phase):
    """The buckets of 4096 seeded events in a 64 x 64 image: rtol 1e-5 (the
    cos of the phase and XLA's FMAs differ in the last bits)."""
    jev, ev = _events(4096, seed=phase)
    acc0 = np.random.default_rng(9).uniform(0, 1e-12, (4096, 3)).astype(np.float32)
    jacc = JSensorTofAmcw(phase_index=phase).accumulate(jnp.asarray(acc0), jev)
    acc = SensorTofAmcw(phase_index=phase).accumulate(torch.as_tensor(acc0), ev)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-5, atol=0)
    img = SensorTofAmcw().finish(acc.reshape(64, 64, 3), 1.0 / 16)
    jimg = JSensorTofAmcw().finish(jacc.reshape(64, 64, 3), 1.0 / 16)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-5, atol=0)
    inactive = ~ev.active.numpy()
    np.testing.assert_array_equal(acc.numpy()[inactive], acc0[inactive])


@pytest.mark.parametrize("noise", [0.0, 0.5, 3.0])
def test_phase_and_result_match_jax(noise):
    """Four seeded phase images through phase (electrons, Box-Muller shot
    noise from hash4, saturation at max_electrons) and result (I/Q distance,
    amplitude, intensity): rtol 1e-5 on the electrons, distances to 1e-4 m."""
    rs = np.random.default_rng(3)
    sensors = [SensorTofAmcw(phase_index=i, max_electrons=60.0) for i in range(4)]
    jsensors = [JSensorTofAmcw(phase_index=i, max_electrons=60.0) for i in range(4)]
    phases, jphases = [], []
    for i in range(4):
        img = rs.uniform(0.0, 1.2e-17, (16, 24, 3)).astype(np.float32)   # up to ~74 electrons
        p = sensors[i].phase(torch.as_tensor(img), shot_noise_factor=noise, seed=i)
        jp = jsensors[i].phase(jnp.asarray(img), shot_noise_factor=noise, seed=i)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-5)
        assert float(p.max()) == 60.0 and float(p.min()) >= 0.0          # saturation, clip
        phases.append(p)
        jphases.append(jp)
    dist, amp, inten = sensors[0].result(phases)
    jdist, jamp, jinten = jsensors[0].result(jphases)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=0, atol=1e-4)
    np.testing.assert_allclose(amp.numpy(), np.asarray(jamp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inten.numpy(), np.asarray(jinten), rtol=1e-5, atol=1e-5)
    assert dist.shape == (16, 24) and float(dist.min()) >= 0.0


def test_sensor_timing_matches_jax():
    s, js_ = SensorTofAmcw(fps=25.0, exposure_time=2e-3), JSensorTofAmcw(fps=25.0,
                                                                        exposure_time=2e-3)
    assert s.phase_image_duration() == js_.phase_image_duration()
    assert s.frame_duration() == js_.frame_duration()
    assert [s.phase_start_time(i) for i in range(4)] == [js_.phase_start_time(i)
                                                        for i in range(4)]


# Analogs of tests/test_sensors_optics.py:76-145, on the port's sensor.

def _capture(opl_w, irradiance_w, **kw):
    """The 4-phase capture of one synthetic path event."""
    phases = []
    for i in range(4):
        s = SensorTofAmcw(phase_index=i, **kw)
        ev = SensorEvent(torch.tensor([[0.0, 0.0, 0.0, irradiance_w]]), torch.zeros(1),
                         torch.tensor([opl_w]), torch.tensor([[opl_w] * 4]), torch.zeros(1),
                         torch.ones(1, dtype=torch.bool))
        acc = s.accumulate(torch.zeros((1, 3)), ev)
        phases.append(s.phase(s.finish(acc, 1.0).reshape(1, 1, 3)))
    return SensorTofAmcw(**kw), phases


def test_distance_reconstruction_in_closed_form():
    s, phases = _capture(opl_w=5.0, irradiance_w=0.1)   # below the saturation knee
    dist, _, _ = s.result(phases)
    assert abs(float(dist[0, 0]) - 2.5) < 1e-3          # distance = opl / 2
    assert float(dist[0, 0]) < SPEED_OF_LIGHT / (2 * s.modulation_frequency)


def test_distance_wraps_at_the_ambiguity_range():
    r_unamb = SPEED_OF_LIGHT / (2.0 * SensorTofAmcw().modulation_frequency)
    s, phases = _capture(opl_w=2.0 * (r_unamb + 1.0), irradiance_w=0.1)
    assert abs(float(s.result(phases)[0][0, 0]) - 1.0) < 1e-2


def test_energy_to_electrons_and_amplitude():
    s = SensorTofAmcw()
    irr = 0.1
    energy = irr * s.pixel_area * s.aperture_factor * s.exposure_time * s.duty_cycle
    electrons = energy * s.quantum_efficiency / s.energy_per_electron
    _, phases = _capture(opl_w=4.0, irradiance_w=irr)
    assert abs(float(phases[0][0, 0, 2]) - electrons) / electrons < 1e-4
    _, amp, _ = s.result(phases)
    assert abs(float(amp[0, 0]) - electrons) / electrons < 1e-3


def test_saturation_clips_electrons():
    out = SensorTofAmcw(max_electrons=100.0).phase(torch.full((1, 1, 3), 1.0))
    assert float(out.max()) == 100.0


# ---------------------------------------------------------------------------
# Scene: the disk, the cone lights, tof_box
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slices", [3, 32])
def test_generate_disk_matches_jax(slices):
    m = generator.generate_disk(0.02, slices)
    jm = jgenerator.generate_disk(0.02, slices)
    for a, b in ((m.positions, jm.positions), (m.normals, jm.normals),
                 (m.texcoords, jm.texcoords), (m.indices, jm.indices)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_cone_light_rows_and_power_weights_match_jax():
    """A spot-lit quad and a ToF disk: the material rows (p0.x = cos of the
    half angle, the ToF flag, NIR-only emission) and the light pick weighted
    by area x luminance x the cone's share 0.5 (1 - cos), alias table
    included, equal to the JAX flattener's."""
    js = jbuilder.Scene()
    white = js.take_material(jbuilder.Lambertian(albedo=(0.5, 0.5, 0.5)))
    spot = js.take_material(jbuilder.LightSpot(radiance=(3.0, 2.0, 1.0), half_angle=0.3))
    tof = js.take_material(jbuilder.LightTof(radiance_w=5.0, half_angle=0.7))
    js.take_mesh_instance(jbuilder.MeshInstance(jgenerator.generate_quad(2.0, 2.0), white))
    js.take_mesh_instance(jbuilder.MeshInstance(jgenerator.generate_quad(0.5, 0.25), spot),
                          hot_spot=True)
    js.take_mesh_instance(jbuilder.MeshInstance(jgenerator.generate_disk(0.1, 8), tof),
                          hot_spot=True)
    j = _np(js.build())
    rows = [(MaterialType.LAMBERTIAN, (0.5, 0.5, 0.5), None),
            (MaterialType.LIGHT_SPOT, (3.0, 2.0, 1.0), 0.3),
            (MaterialType.LIGHT_TOF, 5.0, 0.7)]
    meshes = [MeshSpec.of(generator.generate_quad(2.0, 2.0)),
              MeshSpec.of(generator.generate_quad(0.5, 0.25), 1, hot_spot=True),
              MeshSpec.of(generator.generate_disk(0.1, 8), 2, hot_spot=True)]
    p = flatten_meshes(meshes, material_table(rows), "cpu")
    for f in ("typ", "flags", "albedo", "emissive", "p0"):
        np.testing.assert_array_equal(getattr(p.materials, f).numpy(),
                                      getattr(j.materials, f), err_msg=f)
    assert p.materials.flags[2] == MaterialFlags.TOF_LIGHT
    for f in ("light_prims", "light_weights", "light_alias_prob", "light_alias_idx",
              "prim_light_pick", "prim_inv_area"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), getattr(j, f), err_msg=f)
    w = p.light_weights.numpy()
    spot_share, tof_share = 0.5 * (1 - np.cos(0.3)), 0.5 * (1 - np.cos(0.7))
    ratio = w[0] / w[2]   # a quad triangle (area 0.25) against a disk triangle
    disk_tri = 0.5 * 0.1 * 0.1 * np.sin(2 * np.pi / 8)
    expect = (0.25 * 3.0 * spot_share) / (disk_tri * 5.0 * tof_share)
    assert ratio == pytest.approx(expect, rel=1e-5)


def test_tof_box_matches_jax_field_by_field():
    j = _np(jscenes.tof_box().build())
    p = scenes.tof_box(device="cpu")
    assert p.n_tris == 54 and p.n_lights == 32
    for f in p.tris._fields:
        np.testing.assert_array_equal(getattr(p.tris, f).numpy(), getattr(j.tris, f), err_msg=f)
    for f in p.materials._fields:
        np.testing.assert_array_equal(getattr(p.materials, f).numpy(),
                                      np.asarray(getattr(j.materials, f)), err_msg=f)
    for f in ("light_prims", "light_weights", "light_alias_prob", "light_alias_idx",
              "prim_light_pick", "prim_inv_area"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), getattr(j, f), err_msg=f)
    static, jstatic = SceneStatic.from_scene(p), JSceneStatic.from_scene(j)
    assert static.per_light_mis and jstatic.per_light_mis
    assert static.mat_types == frozenset({MaterialType.LAMBERTIAN, MaterialType.LIGHT_TOF})


# ---------------------------------------------------------------------------
# Emission inside, at the edge of and outside the cone
# ---------------------------------------------------------------------------

def _cone_cosines():
    """cos(view, normal) well inside the 40-degree cone, exactly at its edge
    (the float32 cos of the half angle, p0.x), one float inside and outside
    of it, well outside, and behind the light."""
    c = np.float32(np.cos(np.deg2rad(40)))
    return np.array([1.0, np.cos(np.deg2rad(20)), c, np.nextafter(c, np.float32(1)),
                     np.nextafter(c, np.float32(0)), np.cos(np.deg2rad(60)), -0.5], np.float32)


def test_emitted_follows_the_cone_as_jax_does():
    """Hits on the ToF light (normal (0, 0, -1)) seen from directions at the
    angles of _cone_cosines, front and back side, and on a Lambertian wall."""
    j = jscenes.tof_box().build()
    p = scenes.tof_box(device="cpu")
    cos = np.repeat(_cone_cosines(), 3)
    n = cos.shape[0]
    sin = np.sqrt(np.maximum(1.0 - cos * cos, 0.0)).astype(np.float32)
    view = np.stack([sin, np.zeros_like(sin), -cos], -1).astype(np.float32)
    normal = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    backside = np.tile([False, True, False], n // 3)
    mat = np.tile(np.int32([1, 1, 0]), n // 3)
    zeros3, zeros2 = np.zeros((n, 3), np.float32), np.zeros((n, 2), np.float32)
    fields = dict(t=np.ones(n, np.float32), hit=np.ones(n, bool), prim=np.zeros(n, np.int32),
                  position=zeros3, normal=normal, geom_normal=normal, tangent=zeros3, uv=zeros2,
                  backside=backside, mat=mat)
    hr = HitRecord(**{k: torch.as_tensor(v) for k, v in fields.items()})
    jhr = JHitRecord(**{k: jnp.asarray(v) for k, v in fields.items()})
    mrow = bsdf.gather_material_rows(bsdf.pack_material_table(p.materials), hr.mat)
    jmrow = jbsdf.gather_material_rows(jbsdf.pack_material_table(j.materials), jhr.mat)
    e = bsdf.emitted(hr, torch.as_tensor(view), mrow).numpy()
    je = np.asarray(jbsdf.emitted(j, JSceneStatic.from_scene(j), jhr, jnp.asarray(view),
                                  mrow=jmrow))
    np.testing.assert_array_equal(e, je)
    lit = e[:, 3] > 0
    expect = (mat == 1) & ~backside & (cos >= _cone_cosines()[2])
    np.testing.assert_array_equal(lit, expect)
    assert lit.sum() == 4 and (e[:, :3] == 0).all() and (e[lit, 3] == 8.0).all()


def test_light_emitted_at_follows_the_cone_as_jax_does():
    """NEE's view of the ToF disk's 32 triangles toward receivers at 10, 39,
    41 and 70 degrees off its axis and behind it: emitted inside |cos| >= p0.x
    only, on the front side only."""
    j = jscenes.tof_box().build()
    p = scenes.tof_box(device="cpu")
    ang = np.deg2rad(np.array([10.0, 39.0, 41.0, 70.0, 170.0]))
    lights = p.light_prims.numpy()
    prim = np.repeat(lights, ang.shape[0]).astype(np.int32)
    a = np.tile(ang, lights.shape[0])
    toward = np.stack([np.sin(a), np.zeros_like(a), -np.cos(a)], -1).astype(np.float32)
    le = light_emitted_at(p, torch.as_tensor(prim), torch.as_tensor(toward),
                          bsdf.pack_material_table(p.materials)).numpy()
    jle = np.asarray(jintegrator._light_emitted_at(
        j, JSceneStatic.from_scene(j), jnp.asarray(prim), jnp.zeros((prim.shape[0], 3)),
        jnp.asarray(toward), mat_packed=jbsdf.pack_material_table(j.materials)))
    np.testing.assert_array_equal(le, jle)
    np.testing.assert_array_equal(le[:, 3] > 0, np.tile([True, True, False, False, False],
                                                        lights.shape[0]))


# ---------------------------------------------------------------------------
# Renders
# ---------------------------------------------------------------------------

def _jax_tof_frame(phase, depth, randomize=True):
    jscene = jscenes.tof_box().build()
    jcam = jmake_camera(transformation=jfrom_lookat((0.0, 0.0, 1.19), (0.0, 0.0, 0.0)),
                        vfov_deg=60.0, width=W, height=W)
    img, stats = jrender(jscene, JSceneStatic.from_scene(jscene), jcam, JCameraConfig(),
                         JSensorTofAmcw(phase_index=phase), W, W, SSQRT,
                         params=JRenderParams(max_path_components=depth,
                                              randomize_ray_over_pixel=randomize),
                         return_stats=True)
    return np.asarray(img), np.asarray(stats)


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_small_tof_render_matches_jax_per_pixel(phase):
    """tof_box at 24 x 24, 2 x 2 spp, 6 path components, one phase image:
    counters equal, every pixel's (a, b, energy) within rtol 1e-5."""
    jimg, jstats = _jax_tof_frame(phase, DEPTH)
    img, stats = kc.tof_frame("cpu", phase_index=phase, depth=DEPTH, width=W, ssqrt=SSQRT)()
    img, stats = img.numpy(), stats.numpy()
    assert img.shape == (W, W, 3) and np.isfinite(img).all()
    np.testing.assert_array_equal(stats, jstats)
    np.testing.assert_allclose(img, jimg, rtol=1e-5, atol=0)
    assert (img != 0).mean() > 0.5                     # the light shines into the room
    np.testing.assert_allclose(img[..., 0] + img[..., 1], img[..., 2], rtol=1e-5)


def test_depth_one_distance_reconstructs_the_first_hit():
    """Direct light only, every sample at its pixel centre: the port's
    4-phase distance at 24 x 24 is within 2 mm (median) of the pixel-centre
    rays' first-hit distance, and on 99 % of the pixels within 1e-4 m of the
    JAX package's reconstruction from its own 4 phase images. The rest lie
    on the edge of the light's cone, which passes through a corner pixel:
    there the last bit of |cos| against cos(40 degrees) (XLA's FMAs in the
    light's normal and the dot product) decides whether the pixel is lit,
    for all its samples at once."""
    res = kc.tof_distance_check("cpu", width=W, ssqrt=SSQRT, randomize=False)
    assert res["lit_pixels"] >= 0.99 * W * W
    assert res["median_abs_err_m"] < kc.TOF_DISTANCE_MEDIAN_MAX
    s, js_ = SensorTofAmcw(), JSensorTofAmcw()
    jphases = [js_.phase(jnp.asarray(_jax_tof_frame(i, 1, randomize=False)[0]))
               for i in range(4)]
    phases = [s.phase(kc.tof_frame("cpu", phase_index=i, depth=1, width=W, ssqrt=SSQRT,
                                   randomize=False)()[0]) for i in range(4)]
    close = np.isclose(s.result(phases)[0].numpy(), np.asarray(js_.result(jphases)[0]),
                       rtol=0, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()
