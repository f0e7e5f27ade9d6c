"""K4's env class (render/wavefront.py `shade_env`, csrc/wavefront.cu
wpt_shade_env): Lambertian, GGX, mirror and glass surfaces, triangles and
analytic spheres, under an equirect, cube or constant sky with or without
importance tables, no light, brute force or a BVH; and the regeneration
through the lens models (`regen_pinhole`). Its plain versions against the
JAX package's bounce and camera, the K4 route against the torch-op route,
the routing, the wrapper's input checks and bounds, and (marked `cuda`)
the kernels against their plain versions on the card.

Small scenes: the mesh path's terrain_city at a small size (BVH, GGX and
mirror spheres); a brute-force scene of 16 triangles (a Lambertian ground,
a GGX box with an anisotropic roughness, a mirror quad) under a small
procedural sky; the two sphere paths' scenes (envmap_spheres with its cube
sky, rtiow with its constant sky and OpenCV lens); a dispersive, absorbing
glass sphere beside a GGX sphere under a small cube sky. All but the first
are built by the JAX package and carried over with `scene_from_numpy`, so
that both packages read the same arrays.

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
from wurblpt_tpu_torch.render.intersect import assemble_hit, scene_any_hit, scene_raw_hit
from wurblpt_tpu_torch.render.sensor import SensorRGB, SensorTofAmcw
from wurblpt_tpu_torch.scene.ir import MaterialType, Spheres
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

SMALL = dict(width=16, height=12, ssqrt=2, m=2)
TERRAIN = dict(terrain_res=8, n_buildings=2, sphere_slices=4)
SCENES = ("mesh", "brute")
SPHERE_SCENES = ("envmap", "rtiow", "dispersive glass")
# The frame of kc.k4_inputs (camera, lens, sizes) each scene is seen through.
FRAMES = {"mesh": "mesh", "brute": "mesh", "envmap": "envmap", "rtiow": "rtiow",
          "dispersive glass": "envmap"}


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


def _jax_glass_scene():
    """A dispersive glass sphere (per-channel IOR) with Beer-Lambert
    absorption beside a GGX sphere, over a Lambertian ground, under a small
    cube sky with importance tables, as the JAX package builds it."""
    from wurblpt_tpu.scene.builder import (
        GGX,
        EnvironmentMapCube,
        Glass,
        Lambertian,
        MeshInstance,
        Scene,
        SphereObject,
    )
    from wurblpt_tpu.utils.scenes import _equirect_to_cube_faces, _quad_to, procedural_sky

    scene = Scene()
    ground = scene.take_material(Lambertian(albedo=(0.4, 0.45, 0.5)))
    gm, gtf = _quad_to((0.0, -0.8, 0.0), (1.0, 0.0, 0.0), -np.pi / 2, half=20.0)
    scene.take_mesh_instance(MeshInstance(gm, ground, gtf))
    glass = scene.take_material(Glass(ior=(1.45, 1.5, 1.55, 1.5),
                                      absorption=(0.4, 0.2, 0.1, 0.2)))
    scene.take_sphere(SphereObject((-0.3, 0.0, 0.0), 0.8, glass))
    scene.take_sphere(SphereObject((1.3, 0.0, -0.5), 0.5,
                                   scene.take_material(GGX(albedo=(0.8, 0.6, 0.3),
                                                           roughness=0.2))))
    scene.set_environment_map(EnvironmentMapCube(
        faces=_equirect_to_cube_faces(procedural_sky(16), 8), importance_resolution=8))
    return scene.build(use_bvh=False)


def _scenes(name):
    """(the JAX scene, the port's scene on the CPU) of a test scene."""
    import jax

    from wurblpt_tpu.utils import scenes as jscenes
    from wurblpt_tpu_torch import scene_from_numpy

    if name == "mesh":
        return (jscenes.terrain_city(seed=3, **TERRAIN).build(use_bvh=True),
                scenes.terrain_city(seed=3, **TERRAIN, device="cpu"))
    jscene = {"brute": _jax_brute_scene,
              "envmap": lambda: jscenes.envmap_spheres(cube=True).build(),
              "rtiow": lambda: jscenes.rtiow().build(),
              "dispersive glass": _jax_glass_scene}[name]()
    return jscene, scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")


def _port_scene(name):
    pytest.importorskip("jax")
    return _scenes(name)[1]


def _split_step(inp):
    """One env-class K4 step on the CPU from the regeneration's inputs:
    regen_plain, the scene's closest-hit cast, K3, shade_env_plain, the
    scene's any-hit cast and nee_resolve_plain. Returns (the regenerated
    state, its sample ids, the next state, its cast counts, the pending NEE
    deposits and their shadow casts' occlusion, None without shadow rays)."""
    st, sample, k_next, t_max = wf.regen_plain(*inp.regen)
    tables, sensor, params = inp.shade[:3]
    lanes = inp.regen[5]
    n = st.active.shape[0]
    prepared = integrator.prepare_scene(tables.scene, SceneStatic.from_scene(tables.scene))
    t_min = torch.full((n,), params.min_hit_distance)
    t, prim, u, v = scene_raw_hit(prepared.accel, st.o, st.d, t_min, t_max)
    hr = assemble_hit(prepared.hit, st.o, st.d, t, prim, u, v)
    st = st._replace(stats=torch.zeros((2,), dtype=torch.int64))
    new, shadow_o, shadow_d, shadow_tmax, pending = wf.shade_env_plain(
        tables, sensor, params, st, lanes.pixel, sample, t, prim, hr)
    assert shadow_o is (None if shadow_tmax is None else hr.position)
    occluded = (None if shadow_tmax is None
                else scene_any_hit(prepared.accel, shadow_o, shadow_d, t_min, shadow_tmax))
    acc, _ = wf.nee_resolve_plain(new.acc, pending, occluded, new.active, k_next, lanes)
    return st, sample, new._replace(acc=acc), new.stats, pending, occluded


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


def _jax_bounce(jax, jscene, st, pixel, sample, depth):
    """One JAX bounce (jintegrator._make_bounce_fn, jitted) on the port's
    state `st`: the next state's fields as numpy arrays."""
    from wurblpt_tpu import RenderParams as JRenderParams, SceneStatic as JSceneStatic
    from wurblpt_tpu import SensorRGB as JSensorRGB
    from wurblpt_tpu.render import integrator as jintegrator
    from wurblpt_tpu.render.intersect import mxu_eligible
    from wurblpt_tpu.render.intersect_mxu import build_mxu_scene

    n = st.active.shape[0]
    body = jax.jit(jintegrator._make_bounce_fn(
        jscene, JSceneStatic.from_scene(jscene), JSensorRGB(),
        JRenderParams(max_path_components=depth), None,
        build_mxu_scene(jscene) if mxu_eligible(jscene, None) else None, n))
    a = {f: getattr(st, f).numpy() for f in st._fields}
    jnew = body(jintegrator._LoopState(
        bounce=a["bounce"].astype(np.int32), o=a["o"], d=a["d"], time=np.zeros((n,), np.float32),
        ior=a["ior"], throughput=a["throughput"], active=a["active"], acc=a["acc"],
        geom_len=a["geom_len"], opt_len=a["opt_len"], prev_pdf=a["prev_pdf"],
        prev_random=a["prev_random"], prev_light_pdf=a["prev_light_pdf"],
        stats=np.zeros((2,), np.int32)),
        pixel.numpy().astype(np.int32), sample.numpy().astype(np.int32))
    return jax.tree_util.tree_map(np.asarray, jnew._asdict())


def _materials_met(scene, inp):
    """The material types of `scene` that some active lane of the shade's
    inputs hits, and whether some active lane sees the sky."""
    _, _, _, st, _, _, _, prim, hr = inp.shade
    hit = (prim >= 0) & st.active
    typ = scene.materials.typ[hr.mat.long()]
    return ({int(mt) for mt in torch.unique(typ[hit])}, bool((st.active & (prim < 0)).any()))


def _split_step_against_jax(jax, name):
    jscene, scene = _scenes(name)
    inp = kc.k4_inputs("cpu", "mesh", scene=scene, **SMALL)
    assert kc.k4_route(inp).shade is wf.shade_env
    st, sample, new, stats, _, _ = _split_step(inp)
    n = st.active.shape[0]
    assert 0 < int((~inp.regen[0].active).sum()) < n     # lanes due for regeneration
    met, sky = _materials_met(scene, inp)
    assert met >= {MaterialType.LAMBERTIAN, MaterialType.GGX, MaterialType.MIRROR} and sky
    a = {f: getattr(st, f).numpy() for f in st._fields}
    jnew = _jax_bounce(jax, jscene, st, inp.regen[5].pixel, sample,
                       inp.shade[2].max_path_components)
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


# Per field, (rtol, atol) of the port's split step against the JAX bounce on
# the sphere scenes' lanes whose cast agrees. The sphere quadratic, re-centred
# on the scene's centre, cancels where a ray starts near a sphere, and XLA
# rounds it differently by context (ROADMAP C.1): t moves by up to 1e-3
# relative there, and with it the hit position, the normal and what follows
# from them. Measured on these inputs: directions 3.3e-3 apart (a refraction
# or a GGX sample turns the normal's error), throughput and deposits 2.1e-4
# relative, path lengths 4.2e-5, the GGX sample's pdf 3.5e-3 (a roughness of
# 0.15-0.2 turns the normal's error into ten times as much); no light, so no
# mixture pdf.
SPHERE_TOL = {"d": (0.0, 1e-2), "throughput": (1e-3, 1e-6), "acc": (1e-3, 1e-6),
              "geom_len": (1e-4, 1e-6), "opt_len": (1e-4, 1e-6), "prev_pdf": (1e-2, 1e-6),
              "prev_light_pdf": (0.0, 0.0)}


@pytest.mark.parametrize("name", SPHERE_SCENES)
def test_split_env_step_on_spheres_matches_the_jax_bounce_on_identical_states(name):
    """States of a small frame of the sphere scenes after 2 steps,
    regenerated (rtiow's through its OpenCV lens): the port's split env
    step (regen_plain, K1, K3, shade_env_plain, K2 where the sky is
    importance-sampled, nee_resolve_plain) and one JAX bounce on the same
    state. A lane's cast agrees when the JAX bounce's next origin is the
    port's hit (its position to 1e-3 of its addends) or, on a miss, the ray's
    own origin. On those lanes the outcomes are equal (active, bounce index,
    the previous sample's flag, the per-channel IOR) and the floats within
    SPHERE_TOL; the lanes whose cast parts are fewer than 2 % of the active
    ones, and the closest-cast counter is equal, the shadow-cast counter
    within the parting lanes. A shadow cast parts like a closest one (the
    JAX deposit is the port's with the other occlusion), on fewer than 2 %
    of the active lanes too. Glass lanes (a dispersive, absorbing one in
    the third scene) refract and reflect, the sky is a cube map with
    importance tables or rtiow's constant sky without (no shadow ray)."""
    jax = pytest.importorskip("jax")
    with jax.default_device(jax.devices("cpu")[0]):      # XLA's CPU rounding, as in conftest
        jscene, scene = _scenes(name)
        size = dict(width=24, height=16, ssqrt=2, m=2)
        inp = kc.k4_inputs("cpu", FRAMES[name], scene=scene, **size)
        st, sample, new, stats, pending, occluded = _split_step(inp)
        jnew = _jax_bounce(jax, jscene, st, inp.regen[5].pixel, sample,
                           inp.shade[2].max_path_components)
    met, sky = _materials_met(scene, inp)
    assert met == {int(mt) for mt in torch.unique(scene.materials.typ)} and sky, met
    assert MaterialType.GLASS in met
    _, _, _, _, _, _, t, prim, _ = inp.shade
    o0, port_o, jax_o = st.o.numpy(), new.o.numpy(), jnew["o"]
    active = st.active.numpy()
    hit = (prim >= 0).numpy() & active
    moved = (jax_o != o0).any(-1)
    near = (np.abs(port_o - jax_o) <= 1e-3 * (np.abs(o0) + np.abs(port_o - o0)) + 1e-6).all(-1)
    agree = ~active | np.where(hit, moved & near, ~moved)
    parted = int((~agree).sum())
    assert parted < 0.02 * int(active.sum()), (parted, int(active.sum()))
    for f in ("active", "bounce", "prev_random", "ior"):
        got, ref = getattr(new, f).numpy(), jnew[f]
        same = (got == ref) if got.ndim == 1 else (got == ref).all(-1)
        assert same[agree].all(), (f, np.nonzero(~same & agree)[0][:8])
    # A shadow ray from a sphere's surface can part like a closest cast: the
    # JAX bounce's deposit is then the port's with the other occlusion.
    acc = new.acc.numpy()
    if pending is not None:
        flipped = acc + np.where(occluded.numpy()[:, None], 1.0, -1.0) * pending.numpy()
        tol = dict(rtol=SPHERE_TOL["acc"][0], atol=SPHERE_TOL["acc"][1])
        shadow_parted = (~np.isclose(acc, jnew["acc"], **tol).all(-1)
                         & np.isclose(flipped, jnew["acc"], **tol).all(-1))
        assert int(shadow_parted.sum()) < 0.02 * int(active.sum()), int(shadow_parted.sum())
        agree &= ~shadow_parted
        parted += int(shadow_parted.sum())
    for f, (rtol, atol) in SPHERE_TOL.items():
        np.testing.assert_allclose(getattr(new, f).numpy()[agree], jnew[f][agree], rtol=rtol,
                                   atol=atol, err_msg=f)
    assert int(stats[0]) == int(jnew["stats"][0])
    assert abs(int(stats[1]) - int(jnew["stats"][1])) <= parted
    if scene.envmap.importance:          # env NEE on the diffuse and glossy bounces
        assert int(stats[1]) > int(stats[0]) > 0
    else:                                # no light, no sky importance: no shadow ray
        assert int(stats[1]) == int(stats[0]) > 0


@pytest.mark.parametrize("name", SCENES + ("mesh, ToF sensor", "envmap", "rtiow"))
def test_env_k4_route_gives_the_torch_op_bounce_bits(name, monkeypatch):
    """On the CPU the env-class K4 route (plain versions) and the generic
    torch-op bounce render the same frame bit for bit, and every scene takes
    the K4 route with the env shade; the mesh also seen by the ToF sensor;
    the two sphere paths' scenes built by the port, rtiow through its OpenCV
    lens (no shadow ray: the resolve evaluates the loop condition alone)."""
    sensor = SensorTofAmcw() if name.endswith("ToF sensor") else SensorRGB()
    if name == "envmap":
        render = kc._frame(scenes.envmap_spheres(cube=True, device="cpu"),
                           scenes.envmap_camera("cpu"), 24, 18, 2, 8, "cpu")
    elif name == "rtiow":
        render = kc._frame(scenes.rtiow(device="cpu"), scenes.rtiow_camera("cpu"), 24, 16, 2, 8,
                           "cpu", kc.RTIOW_CAMERA, lens=kc.RTIOW_LENS)
    else:
        render = kc._frame(_port_scene(name.split(",")[0]), scenes.terrain_camera("cpu"), 24, 18,
                           2, 4, "cpu", sensor=sensor)
    shades = []
    shade_env = wf.shade_env

    def counting(*args):
        shades.append(1)
        return shade_env(*args)

    monkeypatch.setattr(wf, "shade_env", counting)
    img, stats = render()
    assert len(shades) > 0
    monkeypatch.setattr(integrator, "env_class", lambda *a: False)
    n_shades = len(shades)
    img_g, stats_g = render()
    assert len(shades) == n_shades
    assert torch.equal(img, img_g) and torch.equal(stats, stats_g)
    assert float(img.mean()) > 0 and int(stats[1]) >= int(stats[0]) > 0
    assert (int(stats[1]) == int(stats[0])) == (name == "rtiow")


def test_each_scene_takes_its_route():
    """mesh, the sphere scenes (envmap with its cube sky, rtiow with its
    constant sky and glass), the mesh through a lens -> K4's env class;
    Cornell, ToF -> K4's diffuse class; the city through its 360-degree
    stereo camera, a 180-degree mono one or a pinhole -> K4's lit class,
    each with the regeneration, shade and shadow rows `k4_route` names for
    its tables and camera; just outside it, the city through a stereo pinhole, under a constant
    sky (no importance tables), with mixture MIS, and the mesh through a
    360-degree camera -> the torch-op bounce."""
    cpu = "cpu"
    mesh = scenes.terrain_city(seed=3, **TERRAIN, device=cpu)
    city = scenes.city_night(seed=7, terrain_res=12, n_buildings=3, n_windows=8,
                             sphere_slices=6, device=cpu)
    const_sky = scenes.rtiow(device=cpu).envmap
    city_const = city._replace(envmap=const_sky)
    cases = {
        "mesh": (mesh, CameraConfig(), "env"),
        "cornell": (scenes.cornell_box_ref(cpu), CameraConfig(), "diffuse"),
        "tof": (scenes.tof_box(device=cpu), CameraConfig(), "diffuse"),
        "city": (city, CameraConfig(surround=SurroundMode.S360, stereo=True), "lit"),
        "city, 180 mono": (city, CameraConfig(surround=SurroundMode.S180), "lit"),
        "city, pinhole": (city, CameraConfig(), "lit"),
        "city, stereo pinhole": (city, CameraConfig(stereo=True), "torch-op"),
        "city, constant sky": (city_const, CameraConfig(surround=SurroundMode.S360), "torch-op"),
        "city, mixture MIS": (city, CameraConfig(surround=SurroundMode.S360), "torch-op"),
        "envmap": (scenes.envmap_spheres(cube=True, device=cpu), CameraConfig(), "env"),
        "rtiow": (scenes.rtiow(device=cpu), kc.RTIOW_CAMERA, "env"),
        "mesh, lens": (mesh, CameraConfig(distortion=DistortionModel.OPENCV), "env"),
        "mesh, 360": (mesh, CameraConfig(surround=SurroundMode.S360), "torch-op"),
    }
    for name, (scene, cfg, route) in cases.items():
        static = SceneStatic.from_scene(scene)
        if name == "city, mixture MIS":
            static = static._replace(per_light_mis=False)
        got = ("diffuse" if wf.diffuse_class(scene, static, cfg)
               else "env" if wf.env_class(scene, static, cfg)
               else "lit" if wf.lit_class(scene, static, cfg) else "torch-op")
        assert got == route, name
        tables = integrator.prepare_scene(scene, static)
        k4_scene = (wf.diffuse_scene(scene, static) or wf.env_scene(scene, static)
                    or wf.lit_scene(scene, static))
        assert (tables.step is not None) == k4_scene, name
        assert (tables.step is not None and tables.step.env is not None) == (
            wf.env_scene(scene, static) or wf.lit_scene(scene, static)), name
        assert (tables.step is not None and tables.step.rgl is not None) == (
            wf.lit_scene(scene, static)), name
        if route != "torch-op":     # the step's kernels follow from its tables and camera
            r = wf.k4_route(tables.step, cfg)
            assert (r.shade, r.shade_plain, r.shadow_rows) == {
                "diffuse": (wf.shade_diffuse, wf.shade_diffuse_plain, 1),
                "env": (wf.shade_env, wf.shade_env_plain, 1),
                "lit": (wf.shade_lit, wf.shade_lit_plain, 2)}[route], name
            assert r.regen is (wf.regen_pinhole if cfg.surround == SurroundMode.OFF
                               else wf.regen_surround), name


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


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "tangent", "modphong", "no sky",
                                 "lights", "spheres in a BVH scene"])
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
    elif bad == "modphong":
        args[0] = tables._replace(mat_types=tables.mat_types | {MaterialType.MODPHONG})
    elif bad == "no sky":
        args[0] = tables._replace(env=None)
    elif bad == "lights":
        args[0] = tables._replace(n_lights=2)
    else:
        sphere = Spheres(torch.zeros((1, 3)), torch.ones((1,)),
                         torch.zeros((1,), dtype=torch.int32))
        assert tables.scene.has_bvh
        args[0] = tables._replace(scene=tables.scene._replace(spheres=sphere))
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


@pytest.mark.parametrize("frame", ["envmap", "rtiow"])
def test_env_k4_bound_charges_glass_and_the_sky_by_branch(frame):
    """On the sphere paths' blocks the env shade's bound charges what their
    branches read and write: with glass the ray IOR on every lane, read and
    written back (without glass only read, on hit lanes); the cube sky its
    faces, rotation and importance tables, the previous bsdf sample's flag
    and pdf on escaped lanes (its MIS weight) and the shadow ray and pending
    deposit of every lane; the constant sky its one radiance, and no MIS
    input, shadow ray or pending deposit (no importance tables)."""
    inp = kc.k4_inputs("cpu", frame, width=24, height=16, ssqrt=2, m=2)
    tables, _, _, st, _, _, _, prim, hr = inp.shade
    env = tables.env
    n = st.active.shape[0]
    hit = (prim >= 0) & st.active
    escaped = st.active & (prim < 0)
    typ = tables.scene.materials.typ[hr.mat.long()]
    ggx = hit & (typ == MaterialType.GGX)
    assert bool((hit & (typ == MaterialType.GLASS)).any()) and bool(escaped.any())
    every = 1 + 8 + 12 + 16 + 12 + 4 + 16 + 8 + 8 + 16          # ... pixel, sample, ior
    on_hit = 4 + 12 + 12 + 1 + 4                                # t, position, normal, back, mat
    out = 8 + 12 + 12 + 16 + 1 + 12 + 4 + 16 + 4 + 1 + 16       # the next state, ior
    expect = (n * every + 4 * int(st.active.sum()) + on_hit * int(hit.sum())
              + 12 * int((~hit).sum()) + 12 * int(ggx.sum()) + n * out + 16)
    if frame == "envmap":
        assert env.kind == 2 and env.importance
        expect += int(escaped.sum()) + 4 * int((escaped & st.prev_random).sum())
        expect += n * (12 + 4 + 12)                             # shadow d, t_max, pending
        rows = (tables.mat, env.image, env.rotation, env.pdf_table, env.alias_prob,
                env.alias_idx)
    else:
        assert env.kind == 3 and not env.importance
        rows = (tables.mat, env.const_radiance)
    expect += sum(x.numel() * x.element_size() for x in rows)
    n_bytes, flops = kc.k4_work(inp, "shade_env")
    assert n_bytes == expect
    assert flops >= 170.0 * n + 100.0 * int((hit & (typ == MaterialType.GLASS)).sum())


@pytest.mark.parametrize("model", [DistortionModel.RADIAL_AND_PLANAR, DistortionModel.RADIAL_ONLY,
                                   DistortionModel.OPENCV])
def test_regen_through_each_lens_matches_the_jax_camera(model):
    """regen_plain through each lens model (rtiow's camera and coefficients,
    8 fixed-point steps for OpenCV) on a small rtiow block after 2 steps:
    the regenerated lanes' rays are the JAX package's camera_rays
    (camera.py:235-240 with undistort_normalized, :140) at the pixel
    coordinates its regeneration jitters them to, to 1e-6 (XLA's FMA
    contraction in the lens polynomials)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from wurblpt_tpu import CameraConfig as JCameraConfig, make_camera as jmake_camera
    from wurblpt_tpu.core.rng import Salt as JSalt, uniform2 as juniform2
    from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
    from wurblpt_tpu.render.camera import camera_rays as jcamera_rays
    from wurblpt_tpu_torch.render.camera import camera_from_numpy

    w, h, ssqrt = 24, 16, 2
    cfg = CameraConfig(distortion=model, undistort_iters=8)
    inp = kc.k4_inputs("cpu", "rtiow", width=w, height=h, ssqrt=ssqrt, m=2, cfg=cfg)
    st, sample, k_next, _, _, lanes, _ = inp.regen
    need = ((~st.active) & (k_next < lanes.P) & lanes.valid).numpy()
    assert 0 < need.sum() < need.size
    with jax.default_device(jax.devices("cpu")[0]):
        jcam = jmake_camera(transformation=jfrom_lookat((13.0, 2.0, 3.0), (0.0, 0.0, 0.0)),
                            vfov_deg=30.0, width=w, height=h, **kc.RTIOW_LENS)
        cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam), "cpu")
        new, new_sample, _, _ = wf.regen_plain(st, sample, k_next, cam, cfg, lanes, True)
        s_new = new_sample.numpy()[need].astype(np.int32)
        uj = np.asarray(juniform2(jnp.asarray(lanes.pixel.numpy()[need].astype(np.int32)),
                                  jnp.asarray(s_new), 0, JSalt.PIXEL_JITTER))
        jx = ((s_new % ssqrt).astype(np.float32) + uj[:, 0]) * np.float32(1.0 / ssqrt)
        jy = ((s_new // ssqrt).astype(np.float32) + uj[:, 1]) * np.float32(1.0 / ssqrt)
        pxy = np.stack([lanes.px.numpy()[need] + jx, lanes.py.numpy()[need] + jy], -1)
        k = pxy.shape[0]
        jo, jd, _ = jcamera_rays(jcam, JCameraConfig(distortion=model, undistort_iters=8),
                                 jnp.asarray(pxy), w, h, 0.0, 0.0, jnp.zeros((k,)),
                                 jnp.zeros((k, 2)))
    np.testing.assert_allclose(new.o.numpy()[need], np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(new.d.numpy()[need], np.asarray(jd), rtol=0, atol=1e-6)
    straight, _, _, _ = wf.regen_plain(st, sample, k_next, cam, CameraConfig(), lanes, True)
    assert float((new.d - straight.d).abs().max()) > 1e-3        # the lens does bend


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


@pytest.mark.cuda
@pytest.mark.parametrize("sensor", ["rgb", "tof"])
@pytest.mark.parametrize("frame", ["envmap", "rtiow"])
def test_shade_env_kernel_matches_plain_on_the_sphere_blocks(gpu, frame, sensor):
    """The env shade's glass instantiations (the cube sky with importance
    tables on the envmap block, 131072 lanes; the constant sky without, on
    the rtiow block, 98304 lanes), the regeneration (rtiow's through its
    OpenCV lens) and the resolve (rtiow's the loop condition alone) against
    their plain versions after 2 steps, seen by each sensor: bit-equal on
    the H100 (every field 0)."""
    inp = kc.k4_inputs(gpu, frame, sensor=SensorTofAmcw() if sensor == "tof" else None)
    assert (inp.resolve[1] is None) == (frame == "rtiow")
    before = {k: native.LAUNCHES[k] for k in ("regen_pinhole", "shade_env", "nee_resolve")}
    res = kc.check_k4(inp)
    torch.cuda.synchronize()
    assert {k: native.LAUNCHES[k] - v for k, v in before.items()} == dict.fromkeys(before, 1)
    for name, fields in res.items():
        assert all(v == 0 for v in fields.values()), (name, fields)


@pytest.mark.cuda
@pytest.mark.parametrize("model", [DistortionModel.RADIAL_AND_PLANAR, DistortionModel.RADIAL_ONLY,
                                   DistortionModel.OPENCV])
def test_lens_regen_kernel_matches_plain_on_the_rtiow_block(gpu, model):
    """The regeneration through each lens model against regen_plain on the
    rtiow frame's first block after 2 steps (98304 lanes): bit-equal on the
    H100 (every field 0)."""
    inp = kc.k4_inputs(gpu, "rtiow", cfg=CameraConfig(distortion=model, undistort_iters=8))
    before = native.LAUNCHES["regen_pinhole"]
    res = kc.check_k4(inp)["regen_pinhole"]
    torch.cuda.synchronize()
    assert native.LAUNCHES["regen_pinhole"] == before + 1
    assert all(v == 0 for v in res.values()), res
