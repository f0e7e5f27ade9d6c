"""K4's env class (render/wavefront.py `shade_env`, csrc/wavefront.cu
wpt_shade_env): Lambertian, GGX and mirror surfaces under an
importance-sampled equirect sky, no light, brute force or a BVH. Its plain
versions against the JAX package's bounce, the K4 route against the
torch-op route, the routing, the wrapper's input checks and bounds, and
(marked `cuda`) the kernel against its plain version on the card.

Two small scenes: the mesh path's terrain_city at a small size (BVH, GGX
and mirror spheres) and a brute-force scene of 16 triangles (a Lambertian
ground, a GGX box with an anisotropic roughness, a mirror quad) under a
small procedural sky, built by the JAX package and carried over with
`scene_from_numpy`, so that both packages read the same arrays.

The JAX comparisons import jax inside the test, so that on a machine with
a GPU and no jax this file runs without the repository's conftest:
    python -m pytest --noconftest tests/test_torch_kernels.py tests/test_torch_wavefront*.py
"""

import numpy as np
import pytest
import torch

from wurblpt_tpu_torch import CameraConfig, SceneStatic, native
from wurblpt_tpu_torch.render import integrator
from wurblpt_tpu_torch.render import wavefront as wf
from wurblpt_tpu_torch.render.camera import DistortionModel, SurroundMode
from wurblpt_tpu_torch.render.envmap import EnvironmentMapCube, build_envmap_arrays
from wurblpt_tpu_torch.render.intersect import assemble_hit, scene_any_hit, scene_raw_hit
from wurblpt_tpu_torch.render.sensor import SensorRGB, SensorTofAmcw
from wurblpt_tpu_torch.scene.ir import MaterialType
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

SMALL = dict(width=16, height=12, ssqrt=2, m=2)
TERRAIN = dict(terrain_res=8, n_buildings=2, sphere_slices=4)
SCENES = ("mesh", "brute")


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return "cuda"


def _jax_brute_scene():
    """The brute-force env-class scene, as the JAX package builds it."""
    from wurblpt_tpu.core.transform import Transformation, quat_from_axis_angle
    from wurblpt_tpu.scene import generator as G
    from wurblpt_tpu.scene.builder import (
        GGX,
        EnvironmentMapEquiRect,
        Lambertian,
        MeshInstance,
        Mirror,
        Scene,
    )
    from wurblpt_tpu.utils.scenes import procedural_sky

    scene = Scene()
    ground = scene.take_material(Lambertian(albedo=(0.5, 0.45, 0.4)))
    ggx = scene.take_material(GGX(albedo=(0.9, 0.7, 0.5), roughness=(0.15, 0.3)))
    mirror = scene.take_material(Mirror(color=(0.9, 0.9, 0.95)))
    down = quat_from_axis_angle((1.0, 0.0, 0.0), -np.pi / 2)
    scene.take_mesh_instance(MeshInstance(G.generate_quad(20.0, 20.0), ground,
                                          Transformation.make(rotation=down)))
    scene.take_mesh_instance(MeshInstance(
        G.generate_cube(2.0), ggx,
        Transformation.make(translation=(-2.5, 2.0, 0.0),
                            rotation=quat_from_axis_angle((0.0, 1.0, 0.0), 0.4))))
    scene.take_mesh_instance(MeshInstance(
        G.generate_quad(3.0, 2.5), mirror,
        Transformation.make(translation=(2.5, 2.5, -1.5),
                            rotation=quat_from_axis_angle((0.0, 1.0, 0.0), 0.6))))
    scene.set_environment_map(EnvironmentMapEquiRect(image=procedural_sky(16),
                                                     importance_resolution=16))
    return scene.build(use_bvh=False)


def _scenes(name):
    """(the JAX scene, the port's scene on the CPU) of a test scene."""
    import jax

    from wurblpt_tpu.utils import scenes as jscenes
    from wurblpt_tpu_torch import scene_from_numpy

    if name == "mesh":
        return (jscenes.terrain_city(seed=3, **TERRAIN).build(use_bvh=True),
                scenes.terrain_city(seed=3, **TERRAIN, device="cpu"))
    jscene = _jax_brute_scene()
    return jscene, scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")


def _port_scene(name):
    pytest.importorskip("jax")
    return _scenes(name)[1]


def _split_step(inp):
    """One env-class K4 step on the CPU from the regeneration's inputs:
    regen_plain, the scene's closest-hit cast, K3, shade_env_plain, the
    scene's any-hit cast and nee_resolve_plain. Returns (the regenerated
    state, its sample ids, the next state, its cast counts)."""
    st, sample, k_next, t_max = wf.regen_plain(*inp.regen)
    tables, sensor, params = inp.shade[:3]
    lanes = inp.regen[5]
    n = st.active.shape[0]
    prepared = integrator.prepare_scene(tables.scene, SceneStatic.from_scene(tables.scene))
    t_min = torch.full((n,), params.min_hit_distance)
    t, prim, u, v = scene_raw_hit(prepared.accel, st.o, st.d, t_min, t_max)
    hr = assemble_hit(prepared.hit, st.o, st.d, t, prim, u, v)
    st = st._replace(stats=torch.zeros((2,), dtype=torch.int64))
    new, shadow_d, shadow_tmax, pending = wf.shade_env_plain(
        tables, sensor, params, st, lanes.pixel, sample, t, prim, hr)
    occluded = scene_any_hit(prepared.accel, hr.position, shadow_d, t_min, shadow_tmax)
    acc, _ = wf.nee_resolve_plain(new.acc, pending, occluded, new.active, k_next, lanes)
    return st, sample, new._replace(acc=acc), new.stats


@pytest.mark.parametrize("name", SCENES)
def test_split_env_step_matches_the_jax_bounce_on_identical_states(name):
    """States of a 16 x 12 frame with 4 spp (2 sample lanes per pixel) after
    2 steps, regenerated: the port's split env step and one JAX bounce on
    the same state give the same discrete outcomes on every lane and floats
    within XLA's FMA contraction (rtol 1e-5, atol 1e-6; the hit positions
    rtol 1e-5 of the addends of o + t d), with lanes that escape to the sky,
    Lambertian, GGX and mirror hits and env NEE."""
    jax = pytest.importorskip("jax")
    with jax.default_device(jax.devices("cpu")[0]):      # XLA's CPU rounding, as in conftest
        _split_step_against_jax(jax, name)


def _split_step_against_jax(jax, name):
    from wurblpt_tpu import RenderParams as JRenderParams, SceneStatic as JSceneStatic
    from wurblpt_tpu import SensorRGB as JSensorRGB
    from wurblpt_tpu.render import integrator as jintegrator
    from wurblpt_tpu.render.intersect import mxu_eligible
    from wurblpt_tpu.render.intersect_mxu import build_mxu_scene

    jscene, scene = _scenes(name)
    inp = kc.k4_inputs("cpu", "mesh", scene=scene, **SMALL)
    assert kc.k4_shade(inp) == "shade_env"
    st, sample, new, stats = _split_step(inp)
    n = st.active.shape[0]
    assert 0 < int((~inp.regen[0].active).sum()) < n     # lanes due for regeneration
    _, _, _, _, _, _, t, prim, hr = inp.shade
    typ = scene.materials.typ[hr.mat.long()]
    hit = (prim >= 0) & inp.shade[3].active
    for mt in (MaterialType.LAMBERTIAN, MaterialType.GGX, MaterialType.MIRROR):
        assert bool((hit & (typ == mt)).any()), mt
    assert bool((inp.shade[3].active & (prim < 0)).any())    # lanes that see the sky
    jstatic = JSceneStatic.from_scene(jscene)
    depth = inp.shade[2].max_path_components
    body = jax.jit(jintegrator._make_bounce_fn(
        jscene, jstatic, JSensorRGB(), JRenderParams(max_path_components=depth), None,
        build_mxu_scene(jscene) if mxu_eligible(jscene, None) else None, n))
    a = {f: getattr(st, f).numpy() for f in st._fields}
    jnew = body(jintegrator._LoopState(
        bounce=a["bounce"].astype(np.int32), o=a["o"], d=a["d"], time=np.zeros((n,), np.float32),
        ior=a["ior"], throughput=a["throughput"], active=a["active"], acc=a["acc"],
        geom_len=a["geom_len"], opt_len=a["opt_len"], prev_pdf=a["prev_pdf"],
        prev_random=a["prev_random"], prev_light_pdf=a["prev_light_pdf"],
        stats=np.zeros((2,), np.int32)),
        inp.regen[5].pixel.numpy().astype(np.int32), sample.numpy().astype(np.int32))
    jnew = jax.tree_util.tree_map(np.asarray, jnew._asdict())
    for f in ("bounce", "active", "prev_random", "stats"):
        np.testing.assert_array_equal(getattr(new, f).numpy(), jnew[f], err_msg=f)
    for f in ("d", "ior", "throughput", "acc", "geom_len", "opt_len", "prev_pdf",
              "prev_light_pdf"):
        np.testing.assert_allclose(getattr(new, f).numpy(), jnew[f], rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    # The hit position o + t d: XLA rounds it once (an FMA) from a t that its
    # own FMAs moved by an ulp or two, the port twice. Where the sum cancels
    # (the camera 20 units away, a hit near an axis plane) that is rtol 1e-5
    # of the addends, not of the sum.
    o_new = new.o.numpy()
    addends = np.abs(a["o"]) + np.abs(jnew["o"] - a["o"])
    assert (np.abs(o_new - jnew["o"]) <= 1e-5 * addends + 1e-6).all()
    assert float(new.acc.abs().sum()) > 0 and int(stats[1]) > int(stats[0]) > 0


@pytest.mark.parametrize("name", SCENES + ("mesh, ToF sensor",))
def test_env_k4_route_gives_the_torch_op_bounce_bits(name, monkeypatch):
    """On the CPU the env-class K4 route (plain versions) and the generic
    torch-op bounce render the same frame bit for bit, and both scenes take
    the K4 route with the env shade; the mesh also seen by the ToF sensor."""
    scene = _port_scene(name.split(",")[0])
    sensor = SensorTofAmcw() if name.endswith("ToF sensor") else SensorRGB()
    render = kc._frame(scene, scenes.terrain_camera("cpu"), 24, 18, 2, 4, "cpu", sensor=sensor)
    shades = []
    shade_env = integrator.shade_env

    def counting(*args):
        shades.append(1)
        return shade_env(*args)

    monkeypatch.setattr(integrator, "shade_env", counting)
    img, stats = render()
    assert len(shades) > 0
    monkeypatch.setattr(integrator, "env_class", lambda *a: False)
    n_shades = len(shades)
    img_g, stats_g = render()
    assert len(shades) == n_shades
    assert torch.equal(img, img_g) and torch.equal(stats, stats_g)
    assert float(img.mean()) > 0 and int(stats[1]) > int(stats[0]) > 0


def test_each_scene_takes_its_route():
    """mesh -> K4's env class; Cornell, ToF -> K4's diffuse class; the city,
    the sphere scenes, the mesh through a lens or a 360-degree camera -> the
    torch-op bounce."""
    cpu = "cpu"
    mesh = scenes.terrain_city(seed=3, **TERRAIN, device=cpu)
    city = scenes.city_night(seed=7, terrain_res=12, n_buildings=3, n_windows=8,
                             sphere_slices=6, device=cpu)
    cases = {
        "mesh": (mesh, CameraConfig(), "env"),
        "cornell": (scenes.cornell_box_ref(cpu), CameraConfig(), "diffuse"),
        "tof": (scenes.tof_box(device=cpu), CameraConfig(), "diffuse"),
        "city": (city, CameraConfig(surround=SurroundMode.S360, stereo=True), "torch-op"),
        "city, pinhole": (city, CameraConfig(), "torch-op"),
        "envmap": (scenes.envmap_spheres(cube=True, device=cpu), CameraConfig(), "torch-op"),
        "rtiow": (scenes.rtiow(device=cpu), CameraConfig(), "torch-op"),
        "mesh, lens": (mesh, CameraConfig(distortion=DistortionModel.OPENCV), "torch-op"),
        "mesh, 360": (mesh, CameraConfig(surround=SurroundMode.S360), "torch-op"),
    }
    for name, (scene, cfg, route) in cases.items():
        static = SceneStatic.from_scene(scene)
        got = ("diffuse" if wf.diffuse_class(scene, static, cfg)
               else "env" if wf.env_class(scene, static, cfg) else "torch-op")
        assert got == route, name
        tables = integrator.prepare_scene(scene, static)
        k4_scene = wf.diffuse_scene(scene, static) or wf.env_scene(scene, static)
        assert (tables.step is not None) == k4_scene, name
        assert (tables.step is not None and tables.step.env is not None) == (
            wf.env_scene(scene, static)), name


def _mesh_inputs():
    return kc.k4_inputs("cpu", "mesh", scene=scenes.terrain_city(seed=3, **TERRAIN, device="cpu"),
                        **SMALL)


def test_shade_env_wrapper_takes_the_plain_version_on_cpu():
    inp = _mesh_inputs()
    counts = dict(native.LAUNCHES)
    res = kc.check_k4(inp)
    assert native.LAUNCHES == counts            # no kernel ran
    assert set(res) == {"regen_pinhole", "shade_env", "nee_resolve"}
    for name, fields in res.items():
        assert all(v == 0 for v in fields.values()), (name, fields)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "tangent", "cube sky", "no sky",
                                 "lights", "glass"])
def test_shade_env_rejects_what_the_kernel_does_not_take(bad):
    inp = _mesh_inputs()
    args = list(inp.shade)
    tables, st, hr = args[0], args[3], args[8]
    if bad == "dtype":
        args[3] = st._replace(bounce=st.bounce.to(torch.int32))
    elif bad == "shape":
        args[3] = st._replace(d=st.d[:, :2].contiguous())
    elif bad == "device":
        args[5] = args[5].to("meta")
    elif bad == "tangent":
        args[8] = hr._replace(tangent=hr.tangent[:-1].contiguous())
    elif bad == "cube sky":
        face = np.ones((4, 4, 3), np.float32)
        cube = build_envmap_arrays(EnvironmentMapCube([face] * 6, importance_resolution=4), "cpu")
        args[0] = tables._replace(env=cube)
    elif bad == "no sky":
        args[0] = tables._replace(env=None)
    elif bad == "lights":
        args[0] = tables._replace(n_lights=2)
    else:
        args[0] = tables._replace(mat_types=tables.mat_types | {MaterialType.GLASS})
    with pytest.raises(ValueError):
        wf.shade_env(*args)


def test_env_k4_bound_counts_what_the_branch_reads():
    """The env shade's bound charges every lane its state and the sample ids
    (the sky's sample); the primitive id only on active lanes; the hit record
    (t, position, normal, backside, material) and the ray IOR only on hit
    lanes, the tangent only on GGX hits; the origin only where the ray
    missed (the next origin is the hit otherwise), the previous bsdf
    sample's flag and pdf only where the ray escaped (its MIS weight); the
    sky's image and tables and the material rows once; no previous mixture
    pdf (no light)."""
    inp = _mesh_inputs()
    tables, _, _, st, _, _, _, prim, hr = inp.shade
    n = st.active.shape[0]
    hit = (prim >= 0) & st.active
    escaped = st.active & (prim < 0)
    ggx = hit & (tables.scene.materials.typ[hr.mat.long()] == MaterialType.GGX)
    assert 0 < int(ggx.sum()) and 0 < int(escaped.sum()) and int(hit.sum()) < n
    every = 1 + 8 + 12 + 16 + 12 + 4 + 16 + 8 + 8
    on_hit = 4 + 16 + 12 + 12 + 1 + 4
    out = 8 + 12 + 12 + 16 + 1 + 12 + 4 + 16 + 4 + 1 + 12 + 4 + 12
    env = tables.env
    rows = sum(x.numel() * x.element_size() for x in (tables.mat, env.image, env.pdf_table,
                                                       env.alias_prob, env.alias_idx,
                                                       env.rotation))
    expect = (n * every + 4 * int(st.active.sum()) + on_hit * int(hit.sum())
              + 12 * int((~hit).sum()) + int(escaped.sum())
              + 4 * int((escaped & st.prev_random).sum()) + 12 * int(ggx.sum()) + n * out
              + rows + 16)
    n_bytes, flops = kc.k4_work(inp, "shade_env")
    assert n_bytes == expect
    assert flops >= 250.0 * n + 350.0 * int(ggx.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("sensor", ["rgb", "tof"])
def test_shade_env_kernel_matches_plain_on_the_mesh_block(gpu, sensor):
    """The env shade (and the regeneration and resolve) against their plain
    versions on the mesh frame's first block after 2 steps (76800 lanes),
    seen by each sensor the kernel is built for: bit-equal on the H100
    (every field 0)."""
    inp = kc.k4_inputs(gpu, "mesh", sensor=SensorTofAmcw() if sensor == "tof" else None)
    before = {k: native.LAUNCHES[k] for k in ("regen_pinhole", "shade_env", "nee_resolve")}
    res = kc.check_k4(inp)
    torch.cuda.synchronize()
    assert {k: native.LAUNCHES[k] - v for k, v in before.items()} == dict.fromkeys(before, 1)
    for name, fields in res.items():
        assert all(v == 0 for v in fields.values()), (name, fields)

