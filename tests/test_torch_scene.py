"""The port's scene: jax-free Cornell, terrain_city, envmap_spheres, rtiow,
tof_box and animated Cornell builds against the JAX flattener, the import
boundary, the builders' GPU default, and refusal of scenes outside the
ported slice."""

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
    the animated Cornell box and the C.1 fields."""
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
            "assert (f.n_tris, f.n_spheres) == (2000, 40)\n")
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


@pytest.mark.parametrize("build, feature", [
    (lambda: _quad_scene(B.PhaseIso()), "material types [6]"),
    (lambda: _quad_scene(B.ModPhong(diffuse=(0.5, 0.5, 0.5), specular=B.CheckerTexture())),
     "textures"),
    (lambda: jscenes.envmap_spheres(cube=False, importance_resolution=0).build(),
     "environment map kind 1 without importance sampling"),
    (lambda: jscenes.mis_test().build(), "sphere lights"),
    (lambda: _quad_scene(B.Lambertian(albedo=B.CheckerTexture())), "textures"),
    # animation without a BVH is in the slice (the sweeps); with one it is not
    (lambda: _quad_scene(B.Lambertian(), animated=True, use_bvh=True), "animation"),
    (lambda: jscenes.cornell_box(short_object="sphere").build(use_bvh=True),
     "spheres in a BVH scene"),
])
def test_scenes_outside_the_slice_are_refused(build, feature):
    scene = _port_of(build())
    with pytest.raises(NotImplementedError, match=feature.replace("[", r"\[")):
        SceneStatic.from_scene(scene).check_slice()


@pytest.mark.parametrize("material", [B.LightTof(), B.LightSpot(radiance=(1.0, 1.0, 1.0))])
def test_spot_and_tof_lights_are_in_the_slice(material):
    SceneStatic.from_scene(_port_of(_quad_scene(material))).check_slice()


def test_render_refuses_a_non_pinhole_camera():
    scene = scenes.cornell_box_ref("cpu")
    cam = make_camera(scenes.cornell_ref_camera("cpu")[0], 50.0, 8, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="depth of field"):
        render_frame_wavefront(scene, SceneStatic.from_scene(scene), cam,
                               CameraConfig(dof=True), SensorRGB(), 8, 8, 1,
                               params=RenderParams(max_path_components=2), device="cpu")
    assert JCameraConfig.__dataclass_fields__.keys() == CameraConfig.__dataclass_fields__.keys()
