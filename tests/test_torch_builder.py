"""The port's scene builder API (`wurblpt_tpu_torch.Scene` and its
descriptors) against the JAX package's: the same descriptors built by both
give the same SceneArrays field by field, bits included (the port's BVH is
its own layout and is compared by test_torch_bvh.py), the texture tables'
float16 image stacks and the materials' texture ids among them.

Cases: the three example apps' scenes (noise_textures, normalmap with a
32^2 map, material_comparison), the two with participating media
(participating_media, stagelights), the textured quad of
tests/test_gradients_breadth.py, and one scene that takes every descriptor
the slice renders: ModPhong with textured diffuse, specular, opacity and
emission, a normal map, a two-sided material, images in grey + alpha, RGB
and RGBA (uint8 sRGB-decoded: the decode's pow rounds in numpy here and in
XLA there, equal after the float16 rounding on these texels), a mesh with
its own tangents under a keyframe animation, an equirect sky with a
rotation and the surround x convention, and the uniform light pick. An
importance-sampled sky's tables come from each package's own radiance
lookup (pdf table to rtol 1e-5, acceptance probabilities to atol 1e-5, as
test_torch_scene.py holds them). An odd-width surround equirect raises
ValueError, as in the JAX package (ROADMAP C.2). Media (a sphere boundary
with a transformation, a mesh boundary, three media two of which share an
inline phase function) build as the JAX builder builds them, their
MediumArrays included."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from wurblpt_tpu.core.transform import Transformation as JTransformation
from wurblpt_tpu.scene import builder as JB
from wurblpt_tpu.scene import generator as JG
from wurblpt_tpu_torch import scene_from_numpy
from wurblpt_tpu_torch.core.transform import Transformation
from wurblpt_tpu_torch.scene import builder as B
from wurblpt_tpu_torch.scene import generator as G
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import jax_frame_reference as jfr  # noqa: E402


def _port_of(jax_scene):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, jax_scene), "cpu")


def _assert_same(a, b, path="scene"):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        assert torch.equal(a, b), path
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        for f in a._fields:
            _assert_same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    else:
        assert a == b, (path, a, b)


def _same_scene(ours, ref):
    """Field by field, the port's own BVH apart and the importance tables
    to the tolerances above."""
    assert (ours.bvh is None) == (ref.bvh is None)
    ours, ref = ours._replace(bvh=None), ref._replace(bvh=None)
    if ref.envmap is not None and ref.envmap.importance:
        np.testing.assert_allclose(ours.envmap.pdf_table.numpy(), ref.envmap.pdf_table.numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(ours.envmap.alias_prob.numpy(),
                                   ref.envmap.alias_prob.numpy(), rtol=0, atol=1e-5)
        ref = ref._replace(envmap=ref.envmap._replace(pdf_table=ours.envmap.pdf_table,
                                                      alias_prob=ours.envmap.alias_prob))
    _assert_same(ours, ref)


def _textured_quad(M, **build):
    sc = M.Scene()
    sc.take_mesh_instance(M.MeshInstance(
        mesh=(JG if M is JB else G).generate_quad(1.0, 1.0),
        material=M.Lambertian(albedo=M.ImageTexture(image=np.full((4, 4, 3), 0.5, np.float32),
                                                    srgb=False))))
    sc.take_sphere(M.SphereObject((0.5, 0.8, 2.5), 0.3, M.LightDiffuse(radiance=(14.0,) * 3)),
                   hot_spot=True)
    return sc.build(**build)


def _everything(M, T, Gen, **build):
    """Every descriptor the slice renders, in the builder module M with
    transformations T and generators Gen."""
    rs = np.random.RandomState(5)
    grey_alpha = rs.uniform(0, 1, (6, 5, 2)).astype(np.float32)
    rgb8 = rs.randint(0, 256, (4, 6, 3)).astype(np.uint8)
    rgba8 = rs.randint(0, 256, (3, 3, 4)).astype(np.uint8)
    sc = M.Scene()
    phong = sc.take_material(M.ModPhong(
        diffuse=M.ImageTexture(image=rgb8), specular=M.CheckerTexture(squares=(3, 5)),
        shininess=40.0, opacity=M.ImageTexture(image=grey_alpha, srgb=False),
        emissive=M.ImageTexture(image=rgba8, linear_filtering=False), ior=1.2,
        transmissive=(0.5, 0.6, 0.7),
        normal_map=M.ImageTexture(image=scenes.brick_normal_map(8, 8), srgb=False),
        two_sided=True), "phong")
    quad = Gen.generate_quad(1.0, 1.0, slices=2)
    tangents = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (len(quad.positions), 1))
    quad = M.Mesh(quad.positions, quad.normals, quad.texcoords, tangents, quad.indices)
    anim = sc.take_animation(M.AnimationKeyframes(
        [0.0, 1.0], [T.make(), T.make(translation=(0.0, 0.5, 0.0))]))
    sc.take_mesh_instance(M.MeshInstance(quad, "phong", T.make(translation=(0.0, 0.0, -1.0)),
                                         animation=anim))
    sc.take_mesh_instance(M.MeshInstance(Gen.generate_torus(1.0, 0.3, 8, 6), M.Mirror(
        color=M.NoiseTexture(octaves=3, seed=4))))
    sc.take_mesh_instance(M.MeshInstance(Gen.generate_quad(0.2, 0.2), M.LightDiffuse(
        radiance=M.ConstantTexture(color=(4.0, 3.0, 2.0))), T.make(translation=(0, 2, 0))),
        hot_spot=True)
    sc.take_sphere(M.SphereObject((0.0, 3.0, 1.0), 0.2, M.LightSpot(radiance=(9.0,) * 3)),
                   hot_spot=True)
    sc.take_sphere(M.SphereObject((1.0, 0.0, 0.0), 0.5, M.GGX(
        albedo=M.ImageTexture(image=rgb8, uv_scale=(2.0, 3.0)), roughness=(0.1, 0.3))))
    assert sc.material_index("phong") == phong
    sky = rs.uniform(0.1, 2.0, (8, 16, 3)).astype(np.float32)
    q = np.array([0.1, 0.2, 0.3, 0.9], np.float32)
    sc.set_environment_map(M.EnvironmentMapEquiRect(image=sky, importance_resolution=8,
                                                    x_convention_surround=True,
                                                    rotation=q / np.linalg.norm(q)))
    return sc.build(light_sampling="uniform", **build)


CASES = {
    "noise_textures": (lambda: scenes.noise_textures("cpu"),
                       lambda: jfr.jax_example_scene("noise_textures")[0]),
    "normalmap": (lambda: scenes.normalmap(32, "cpu"),
                  lambda: jfr.jax_example_scene("normalmap", 32)[0]),
    "material_comparison": (lambda: scenes.material_comparison("cpu"),
                            lambda: jfr.jax_example_scene("material_comparison")[0]),
    "textured_quad": (lambda: _textured_quad(B, device="cpu"), lambda: _textured_quad(JB)),
    "every_descriptor": (lambda: _everything(B, Transformation, G, device="cpu"),
                         lambda: _everything(JB, JTransformation, JG)),
    "participating_media": (lambda: scenes.participating_media(device="cpu"),
                            lambda: jfr.jax_media_scene("participating_media")[0]),
    "stagelights": (lambda: scenes.stagelights(device="cpu"),
                    lambda: jfr.jax_media_scene("stagelights")[0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_scene_build_equals_jax_build_field_by_field(name):
    ours_fn, ref_fn = CASES[name]
    ours = ours_fn()
    _same_scene(ours, _port_of(ref_fn()))
    assert ours.device.type == "cpu"


def test_every_descriptor_scene_carries_its_textures():
    """The big case's tables are what its descriptors ask for: eight textures
    (normal map first, then the ModPhong's four, the mirror's noise, the
    light's constant, the GGX image), five images padded to the largest,
    two-sided and animated rows, the uniform pick."""
    s = _everything(B, Transformation, G, device="cpu")
    assert s.textures.count == 8 and s.textures.img_data.dtype == torch.float16
    assert s.textures.img_data.shape == (5, 8, 8, 4)
    assert s.textures.img_hw.tolist() == [[8, 8], [4, 6], [6, 5], [3, 3], [4, 6]]
    m = s.materials
    assert [m.normal_tex[0].item(), m.albedo_tex[0].item(), m.spec_tex[0].item(),
            m.opacity_tex[0].item(), m.emissive_tex[0].item()] == [0, 1, 2, 3, 4]
    assert float(m.p0[0, 1]) == 1.0 and int(m.flags[0]) & 1
    assert s.light_weights is None and s.prim_light_pick is not None
    assert s.n_anims == 2 and int(s.tris.flags[0]) == 3


def test_build_defaults_to_the_gpu():
    import inspect

    assert inspect.signature(B.Scene.build).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            _textured_quad(B)


@pytest.mark.parametrize("M", [JB, B], ids=["jax", "port"])
def test_odd_width_surround_equirect_raises(M):
    """ROADMAP C.2, a known fault of the reference kept in the port: the
    surround x convention rolls the image by half its width, so an odd
    width raises ValueError."""
    sc = M.Scene()
    sc.set_environment_map(M.EnvironmentMapEquiRect(image=np.ones((4, 7, 3), np.float32),
                                                    x_convention_surround=True))
    with pytest.raises(ValueError, match="even-width"):
        sc.build(**({} if M is JB else dict(device="cpu")))


def _media(M, T, Gen, kind, **build):
    """A quad and media in builder module M: a sphere boundary with a
    transformation (its translation and largest scale apply), a mesh
    boundary (an octahedron turned, scaled and moved), or both, overlapping,
    added mesh first (the rows are ordered by medium); inline phase
    functions, one shared by two media."""
    sc = M.Scene()
    sc.take_mesh_instance(M.MeshInstance(Gen.generate_quad(), M.Lambertian()))
    shared = M.PhaseIso(albedo=(0.9, 0.8, 0.7))
    sphere = M.MediumObject(M.SphereObject((0.1, 0.2, 0.3), 1.0, M.PhaseIso(),
                                           T.make(translation=(0.5, 0.0, -1.0),
                                                  scale=(1.0, 2.0, 1.5))), 1.5, shared)
    octa = M.MediumObject(M.MeshInstance(Gen.generate_octahedron(), 0, T.make(
        translation=(0.2, 0.1, -0.6), scale=(0.8,) * 3)), 2.5, M.PhaseIso(albedo=(1.0,) * 3))
    for med in {"sphere": [sphere], "mesh": [octa], "both": [octa, sphere,
                                                              M.MediumObject(sphere.boundary,
                                                                             0.3, shared)]}[kind]:
        sc.take_medium(med)
    return sc.build(**build)


@pytest.mark.parametrize("kind", ["sphere", "mesh", "both"])
def test_media_build_as_the_jax_builder_builds_them(kind):
    """The scene with its MediumArrays equal to the JAX build's, carried
    across by scene_from_numpy (ordered by medium, with each medium's row
    offsets), and each phase function a PHASE_ISO row of the table."""
    ours = _media(B, Transformation, G, kind, device="cpu")
    ref = _port_of(_media(JB, JTransformation, JG, kind))
    _same_scene(ours, ref)
    md = ours.media
    assert md.count == {"sphere": 1, "mesh": 1, "both": 3}[kind]
    assert (ours.materials.typ[md.phase_mat.long()] == 6).all()
    assert md.tri_off.tolist()[-1] == md.tri_p0.shape[0]
    assert md.sph_off.tolist()[-1] == md.sph_center.shape[0]
    if kind == "both":
        assert md.phase_mat[1] == md.phase_mat[2] != md.phase_mat[0]
        assert md.tri_off.tolist() == [0, 8, 8, 8] and md.sph_off.tolist() == [0, 0, 1, 2]


def test_inline_materials_are_registered_once():
    """An inline material shared by two instances takes one row, as
    `Scene._resolve_material` registers it on its first resolve."""
    sc = B.Scene()
    mat = B.Lambertian(albedo=(0.2, 0.3, 0.4))
    for x in (0.0, 3.0):
        sc.take_mesh_instance(B.MeshInstance(G.generate_quad(), mat,
                                             Transformation.make(translation=(x, 0, 0))))
    s = sc.build(device="cpu")
    assert s.materials.count == 1 and s.tris.mat.tolist() == [0, 0, 0, 0]
