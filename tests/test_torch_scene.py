"""The port's scene: jax-free Cornell, terrain_city, envmap_spheres, rtiow,
tof_box and animated Cornell builds against the JAX flattener (also the
BVH paths' rtiow(n=22) and animated box with spheres, each with its tree),
the import boundary, the builders' GPU default, and refusal of scenes
outside the ported slice; spheres and animation in a BVH scene are in it
and render as the JAX package renders them."""

import inspect
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from wurblpt_tpu import CameraConfig as JCameraConfig
from wurblpt_tpu.core.transform import Transformation as JTransformation
from wurblpt_tpu.scene import builder as B
from wurblpt_tpu.scene.generator import generate_quad
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
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _port_of(jax_scene):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, jax_scene), "cpu")


def _assert_same(a, b, path="scene"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        # bit-equal; float32 tensors may hold int bit patterns (BVH links)
        assert torch.equal(a, b) or (a.dtype == torch.float32 and torch.equal(
            a.view(torch.int32), b.view(torch.int32))), path
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        for f in a._fields:
            _assert_same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    else:
        assert a == b, path


def test_cornell_box_ref_equals_jax_build_field_by_field():
    ours = scenes.cornell_box_ref("cpu")
    ref = _port_of(jscenes.cornell_box_ref().build())
    _assert_same(ours, ref)
    assert ours.n_tris == 36 and ours.n_spheres == 0
    assert ours.light_prims.tolist() == [34, 35]


@pytest.mark.parametrize("spheres", [False, True])
def test_cornell_box_animated_equals_jax_build_field_by_field(spheres):
    """The port builds, without JAX, the arrays the JAX builder makes of the
    animated box: keyframe tables, animation ids, and no per-light MIS rows
    (the light moves)."""
    sys.path.insert(0, str(REPO))
    import jax_frame_reference as jfr

    ours = scenes.cornell_box_animated("cpu", spheres=spheres)
    ref = _port_of(jfr.jax_cornell_animated(spheres=spheres))
    _assert_same(ours, ref)
    assert ours.n_tris == 36 and ours.n_anims == 4 and not ours.has_bvh
    assert ours.prim_light_pick is None and ours.tris.anim[34:].tolist() == [3, 3]


def test_terrain_city_equals_jax_build_field_by_field():
    """The mesh path's scene at a small size, BVH and sky included. The port's
    importance tables come from its own radiance lookup on the CPU: pdf table
    and acceptance probabilities to rtol 1e-5, everything else bit-equal."""
    small = dict(terrain_res=24, n_buildings=8, sphere_slices=6)
    ours = scenes.terrain_city(seed=3, **small, device="cpu")
    ref = _port_of(jscenes.terrain_city(seed=3, **small).build(use_bvh=True))
    for f in ("pdf_table", "alias_prob"):
        np.testing.assert_allclose(getattr(ours.envmap, f).numpy(),
                                   getattr(ref.envmap, f).numpy(), rtol=1e-5)
    env = ref.envmap._replace(pdf_table=ours.envmap.pdf_table, alias_prob=ours.envmap.alias_prob)
    _assert_same(ours, ref._replace(envmap=env))
    assert ours.n_tris == 2594 and ours.n_lights == 0 and ours.light_weights is None
    assert ours.has_bvh and ours.env_kind == 1 and ours.envmap.importance
    assert not torch.equal(ours.tris.v1, ours.tris.p0 + ours.tris.e1)   # why v1/v2 are kept


def test_envmap_spheres_equals_jax_build_field_by_field():
    """The envmap path's scene (2 triangles, 3 spheres: glass, mirror, GGX)
    with the cube-map sky.
    Its importance tables come from the port's own radiance lookup: pdf
    table to rtol 1e-5, acceptance probabilities to atol 1e-5, the rest
    bit-equal."""
    ours = scenes.envmap_spheres(cube=True, device="cpu")
    ref = _port_of(jscenes.envmap_spheres(cube=True).build())
    np.testing.assert_allclose(ours.envmap.pdf_table.numpy(), ref.envmap.pdf_table.numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(ours.envmap.alias_prob.numpy(), ref.envmap.alias_prob.numpy(),
                               rtol=0, atol=1e-5)
    env = ref.envmap._replace(pdf_table=ours.envmap.pdf_table, alias_prob=ours.envmap.alias_prob)
    _assert_same(ours, ref._replace(envmap=env))
    assert ours.n_tris == 2 and ours.n_spheres == 3 and ours.env_kind == 2
    assert ours.materials.typ.tolist() == [1, 3, 4, 2] and ours.spheres.mat.tolist() == [1, 2, 3]
    assert ours.envmap.pdf_table.shape == (64, 64)


def test_rtiow_equals_jax_build_field_by_field():
    """The rtiow path's scene: 40 spheres drawn as the JAX builder draws them,
    no triangle at all, a constant sky."""
    ours = scenes.rtiow(device="cpu")
    _assert_same(ours, _port_of(jscenes.rtiow().build()))
    assert ours.n_tris == 0 and ours.n_spheres == 40 and ours.n_lights == 0
    assert ours.env_kind == 3 and not ours.envmap.importance
    assert float(ours.spheres.radius[0]) == 1000.0
    assert set(ours.materials.typ.tolist()) == {1, 2, 3}
    for seed, n in ((3, 4), (11, 2)):
        _assert_same(scenes.rtiow(seed, n, device="cpu"), _port_of(jscenes.rtiow(seed, n).build()))


def test_flatten_spheres_with_a_pose_and_no_triangle():
    """SphereSpec poses bake into the centre (scale, rotate, translate) and
    the radius (mean scale); sphere j gets prim id T + j."""
    from wurblpt_tpu_torch.core.transform import Transformation, quat_from_axis_angle
    from wurblpt_tpu_torch.scene.flatten import Glass, SphereSpec, flatten_meshes, material_table
    from wurblpt_tpu_torch.scene.ir import MaterialType

    tf = Transformation.make(translation=(1.0, 2.0, 3.0),
                             rotation=quat_from_axis_angle((0, 0, 1), np.pi / 2), scale=2.0)
    rows = [(MaterialType.GLASS, None, Glass(ior=(1.4, 1.5, 1.6), absorption=(0.1, 0.2, 0.3)))]
    scene = flatten_meshes([], material_table(rows), "cpu",
                           spheres=[SphereSpec((1.0, 0.0, 0.0), 0.5, 0, tf)])
    assert scene.n_tris == 0 and scene.tris.p0.shape == (0, 3) and scene.tris.uv0.shape == (0, 2)
    np.testing.assert_allclose(scene.spheres.center.numpy(), [[1.0, 4.0, 3.0]], atol=1e-6)
    assert float(scene.spheres.radius[0]) == 1.0
    np.testing.assert_array_equal(scene.materials.p0.numpy(), np.float32([[1.4, 1.5, 1.6, 1.6]]))
    np.testing.assert_array_equal(scene.materials.p1.numpy(), np.float32([[0.1, 0.2, 0.3, 0.0]]))


BUILDERS = ("cornell_box_ref", "cornell_ref_camera", "terrain_city", "terrain_camera",
            "city_night", "city_camera", "envmap_spheres", "envmap_camera", "rtiow", "rtiow_camera",
            "tof_box", "tof_camera")


def test_builders_default_to_the_gpu():
    """Scene, camera and table builders build on the GPU unless the caller
    names another device; without one they raise instead of building on the
    CPU."""
    from wurblpt_tpu_torch import from_lookat, make_camera
    from wurblpt_tpu_torch.materials.rgl import stack_rgl_tables

    for fn in [getattr(scenes, n) for n in BUILDERS] + [from_lookat, make_camera,
                                                         stack_rgl_tables]:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if not torch.cuda.is_available():
        for call in (lambda: scenes.cornell_box_ref(), lambda: scenes.rtiow_camera(),
                     lambda: from_lookat((0.0, 0.0, 1.0), (0.0, 0.0, 0.0))):
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def test_port_imports_without_jax():
    code = ("import sys, wurblpt_tpu_torch, wurblpt_tpu_torch.native, "
            "wurblpt_tpu_torch.utils.scenes as s; s.cornell_box_ref('cpu'); "
            "from wurblpt_tpu_torch import SceneStatic, CameraConfig, SensorRGB, make_camera, "
            "RenderParams, render_frame_wavefront as r; "
            "t = s.terrain_city(seed=3, terrain_res=8, n_buildings=2, sphere_slices=4, "
            "device='cpu'); "
            "p, f = s.terrain_camera('cpu'); "
            "img = r(t, SceneStatic.from_scene(t), make_camera(p, f, 8, 6, device='cpu'), "
            "CameraConfig(), "
            "SensorRGB(), 8, 6, 1, params=RenderParams(max_path_components=2), device='cpu'); "
            "assert bool(img.isfinite().all()) and float(img.mean()) > 0; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'wurblpt_tpu' or m.startswith('wurblpt_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_stands_alone_without_the_jax_package(tmp_path):
    """The port copied alone, with no wurblpt_tpu beside it and jax blocked,
    builds its host libraries (g++) and the Cornell, terrain and city scenes,
    the animated Cornell box, the C.1 fields and, through its Scene, the
    example apps' three scenes, without importing PIL."""
    shutil.copytree(REPO / "wurblpt_tpu_torch", tmp_path / "wurblpt_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'wurblpt_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import wurblpt_tpu_torch\n"
            "assert wurblpt_tpu_torch.__file__.startswith(sys.argv[1]), wurblpt_tpu_torch.__file__\n"
            "from wurblpt_tpu_torch.utils import scenes as s\n"
            "assert s.cornell_box_ref('cpu').n_tris == 36\n"
            "assert s.terrain_city(seed=3, terrain_res=8, n_buildings=2, sphere_slices=4,\n"
            "                      device='cpu').has_bvh\n"
            "c = s.city_night(terrain_res=8, n_buildings=3, n_windows=4, sphere_slices=4,\n"
            "                 device='cpu')\n"
            "assert c.has_bvh and c.n_lights == 8 and c.rgl is not None\n"
            "e = s.envmap_spheres(cube=True, importance_resolution=8, device='cpu')\n"
            "assert e.n_tris == 2 and e.n_spheres == 3 and e.env_kind == 2\n"
            "r = s.rtiow(device='cpu')\n"
            "assert r.n_tris == 0 and r.n_spheres == 40 and r.env_kind == 3\n"
            "t = s.tof_box(device='cpu')\n"
            "assert t.n_tris == 54 and t.n_lights == 32\n"
            "a = s.cornell_box_animated('cpu', spheres=True)\n"
            "assert a.n_tris == 36 and a.n_spheres == 2 and a.n_anims == 4\n"
            "assert s.sphere_field(device='cpu').n_spheres == 3000\n"
            "f = s.tri_sphere_field(device='cpu')\n"
            "assert (f.n_tris, f.n_spheres) == (2000, 40)\n"
            "assert s.noise_textures('cpu').n_textures == 6\n"
            "assert s.normalmap(16, 'cpu').textures.img_data.shape == (1, 16, 16, 4)\n"
            "assert s.material_comparison('cpu').rgl is not None\n"
            "assert not any(m.split('.')[0] == 'PIL' for m in sys.modules)\n")
    env = {k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert not (tmp_path / "wurblpt_tpu").exists()


@pytest.mark.parametrize("name", ["bvh_builder.cpp", "obj_parser.cpp"])
def test_host_sources_are_copies_of_the_jax_packages(name):
    """The port's host C++ equals the JAX package's line for line; only a
    comment line may differ (the builder's header cites the reference
    renderer by a path relative to that project)."""
    ours = (REPO / "wurblpt_tpu_torch" / "csrc" / "host" / name).read_text().splitlines()
    ref = (REPO / "wurblpt_tpu" / "native" / "src" / name).read_text().splitlines()
    assert len(ours) == len(ref)
    diff = [(a, b) for a, b in zip(ours, ref) if a != b]
    assert all(a.startswith("//") and b.startswith("//") for a, b in diff), diff
    assert len(diff) == (1 if name == "bvh_builder.cpp" else 0)


def test_static_of_the_slice():
    st = SceneStatic.from_scene(scenes.cornell_box_ref("cpu"))
    assert st.mat_types == frozenset({1, 7}) and st.n_lights == 2
    st.check_slice()
    st = SceneStatic.from_scene(scenes.terrain_city(seed=3, terrain_res=8, n_buildings=2,
                                                    sphere_slices=4, device="cpu"))
    assert st.mat_types == frozenset({1, 2, 4}) and st.n_lights == 0
    assert st.has_bvh and st.env_kind == 1 and st.env_importance
    st.check_slice()
    st = SceneStatic.from_scene(scenes.envmap_spheres(cube=True, importance_resolution=8,
                                                      device="cpu"))
    assert st.mat_types == frozenset({1, 2, 3, 4}) and st.env_kind == 2 and st.env_importance
    st.check_slice()
    st = SceneStatic.from_scene(scenes.envmap_spheres(cube=True, importance_resolution=0,
                                                      device="cpu"))
    assert st.env_kind == 2 and not st.env_importance
    st.check_slice()
    st = SceneStatic.from_scene(scenes.rtiow(device="cpu"))
    assert st.mat_types == frozenset({1, 2, 3}) and st.env_kind == 3 and not st.env_importance
    assert st.n_lights == 0 and not st.sphere_lights
    st.check_slice()


def _quad_scene(material, animated=False, **build):
    scene = B.Scene()
    inst = B.MeshInstance(generate_quad(), scene.take_material(material))
    if animated:
        inst.animation = scene.take_animation(B.AnimationKeyframes(
            [0.0, 1.0], [JTransformation.make(), JTransformation.make(translation=(0, 1, 0))]))
    scene.take_mesh_instance(inst)
    return scene.build(**build)


def _medium_scene():
    scene = B.Scene()
    scene.take_mesh_instance(B.MeshInstance(generate_quad(), B.Lambertian()))
    scene.take_medium(B.MediumObject(B.SphereObject((0, 0, 0), 1.0, B.PhaseIso()), 1.0,
                                     B.PhaseIso()))
    return scene.build()


@pytest.mark.parametrize("build", [lambda: _quad_scene(B.PhaseIso()), _medium_scene],
                         ids=["phase_material", "medium"])
def test_phase_function_and_media_come_across(build):
    """The phase function and media, refused here before, are in the slice:
    check_slice takes them, and scene_from_numpy carries the JAX scene's
    media (boundaries, densities, phase materials) across unchanged, the
    rows ordered by medium with their offsets."""
    jscene = build()
    scene = _port_of(jscene)
    st = SceneStatic.from_scene(scene)
    st.check_slice()
    assert 6 in st.mat_types
    jm = jscene.media
    assert st.has_media == (int(jm.density.shape[0]) > 0)
    if not st.has_media:
        assert scene.media is None
        return
    md = scene.media
    for f in ("tri_p0", "tri_e1", "tri_e2", "tri_med", "sph_center", "sph_radius", "sph_med",
              "density", "phase_mat"):
        np.testing.assert_array_equal(getattr(md, f).numpy(), np.asarray(getattr(jm, f)), f)
    assert md.sph_off.tolist() == [0, 1] and md.tri_off.tolist() == [0, 0]


@pytest.mark.parametrize("build, feature", [
    (lambda: jscenes.envmap_spheres(cube=False, importance_resolution=0).build(),
     "environment map kind 1 without importance sampling"),
])
def test_scenes_outside_the_slice_are_refused(build, feature):
    """Each refusal names its feature (and its ROADMAP item). Textures,
    refused here before, are in the slice: tests/test_torch_textures.py."""
    scene = _port_of(build())
    with pytest.raises(NotImplementedError, match=feature.replace("[", r"\[").replace(
            "(", r"\(").replace(")", r"\)")):
        SceneStatic.from_scene(scene).check_slice()


def _animated_box_in_a_bvh():
    sys.path.insert(0, str(REPO))
    import jax_frame_reference as jfr

    return jfr.jax_cornell_animated(use_bvh=True, t=0.5)


@pytest.mark.parametrize("build, eye, center, t", [
    (_animated_box_in_a_bvh, (0.0, 1.0, 3.2), (0.0, 1.0, -1.0), 0.5),
    (lambda: jscenes.cornell_box(short_object="sphere").build(use_bvh=True), (0.0, 0.0, 3.2),
     (0.0, 0.0, 0.0), 0.0),
], ids=["animation", "spheres in a BVH scene"])
def test_bvh_scenes_with_spheres_or_animation_are_in_the_slice(build, eye, center, t):
    """The scenes the slice refused before the BVH's sphere and object-space
    leaves (the animated Cornell box, cornell_box(short_object="sphere"),
    each with a BVH): they pass check_slice and render (8 x 8, 1 spp, 3 path
    components, at t) as the JAX package renders them: equal counters,
    pixels within rtol 1e-3 / atol 1e-5 (ROADMAP C.4)."""
    from wurblpt_tpu import RenderParams as JRenderParams
    from wurblpt_tpu import SceneStatic as JSceneStatic
    from wurblpt_tpu import SensorRGB as JSensorRGB
    from wurblpt_tpu import make_camera as jmake_camera
    from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
    from wurblpt_tpu.render.integrator import render_frame_wavefront as jrender
    from wurblpt_tpu_torch.core.transform import from_lookat

    js = build()
    ps = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu", t, t)
    static = SceneStatic.from_scene(ps)
    assert ps.has_bvh and (ps.n_spheres > 0 or static.has_anim)
    static.check_slice()
    jimg, jstats = jrender(js, JSceneStatic.from_scene(js),
                           jmake_camera(transformation=jfrom_lookat(eye, center), vfov_deg=50.0,
                                        width=8, height=8),
                           JCameraConfig(), JSensorRGB(), 8, 8, 1, t, t,
                           params=JRenderParams(max_path_components=3), return_stats=True)
    cam = make_camera(from_lookat(eye, center, device="cpu"), 50.0, 8, 8, device="cpu")
    img, stats = render_frame_wavefront(ps, static, cam, CameraConfig(), SensorRGB(), 8, 8, 1,
                                        params=RenderParams(max_path_components=3),
                                        return_stats=True, device="cpu", t0=t, t1=t)
    assert stats.tolist() == np.asarray(jstats).tolist()
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=1e-3, atol=1e-5)
    assert float(img.max()) > 0


@pytest.mark.parametrize("name", ["rtiow n=22", "animated box with spheres"])
def test_bvh_path_scenes_equal_jax_build_field_by_field(name):
    """The BVH paths' scenes: the port builds without JAX the arrays and the
    tree that the JAX build's arrays give it (the same SAH build over the
    same boxes, swept over [0.5, 0.5] for the animated box)."""
    if name == "rtiow n=22":
        ours = scenes.rtiow(n=22, device="cpu", use_bvh=True)
        ref = _port_of(jscenes.rtiow(n=22).build(use_bvh=True))
        assert ours.n_spheres == 488 and ours.n_tris == 0
    else:
        sys.path.insert(0, str(REPO))
        import jax_frame_reference as jfr

        ours = scenes.cornell_box_animated("cpu", spheres=True, use_bvh=True)
        js = jfr.jax_cornell_animated(spheres=True, use_bvh=True, t=0.5)
        ref = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu", 0.5, 0.5)
        assert ours.n_anims == 4 and ours.bvh.n_anims == 4
    assert ours.has_bvh
    _assert_same(ours, ref)


@pytest.mark.parametrize("material", [B.LightTof(), B.LightSpot(radiance=(1.0, 1.0, 1.0))])
def test_spot_and_tof_lights_are_in_the_slice(material):
    SceneStatic.from_scene(_port_of(_quad_scene(material))).check_slice()


def test_render_refuses_a_non_pinhole_camera():
    """A camera outside the port (an unknown distortion model) is refused at
    render start; depth of field, which the port takes since its thin lens
    was ported, renders (its lens moves the image)."""
    scene = scenes.cornell_box_ref("cpu")
    cam = make_camera(scenes.cornell_ref_camera("cpu")[0], 50.0, 8, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="distortion model 7"):
        render_frame_wavefront(scene, SceneStatic.from_scene(scene), cam,
                               CameraConfig(distortion=7), SensorRGB(), 8, 8, 1,
                               params=RenderParams(max_path_components=2), device="cpu")
    lens = cam._replace(aperture_diameter=torch.tensor(0.3), focus_distance=torch.tensor(3.0))
    img, sharp = (render_frame_wavefront(scene, SceneStatic.from_scene(scene), lens,
                                         CameraConfig(dof=dof), SensorRGB(), 8, 8, 1,
                                         params=RenderParams(max_path_components=2),
                                         device="cpu") for dof in (True, False))
    assert bool(torch.isfinite(img).all()) and not torch.equal(img, sharp)
    assert JCameraConfig.__dataclass_fields__.keys() == CameraConfig.__dataclass_fields__.keys()
