"""The port's environment maps (K8's plain versions and the table build)
against the JAX package's: the equirect map on the mesh path's sky, the cube
map on the envmap path's (the same sky point-sampled into 32 x 32 faces)
and the constant map on rtiow's.

Directions and uniforms are made with numpy from a seed and handed to both
packages, with the JAX package's tables, so any difference is the port's
arithmetic. Tolerances: radiance and directions rtol 1e-5, atol 1e-6 (XLA's
and PyTorch's atan2/acos/sin/cos may differ by an ulp, and the bilinear
weights carry that); pdfs are table lookups and equal except where such an
ulp moves a direction across a cell edge (at most 1e-3 of the lanes). The
port's own importance tables come from its plain radiance lookup on the
CPU: pdf_table to rtol 1e-5, alias tables equal.

Cube map: radiance rtol 1e-6 (XLA contracts the bilinear blend into FMAs on
the CPU, the port does not: 2.3e-7 relative at most on these directions), on
random directions and on the axis, diagonal, face-edge and texel-boundary
directions where the face pick and the clamps decide by ties; its
importance tables (64 x 64) to rtol 1e-5 (pdf) and atol 1e-5 (acceptance
probabilities, which Vose's subtractions make relatively larger where they
are small), alias partners equal. The constant map: equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu.render import envmap as jenvmap
from wurblpt_tpu.scene.builder import EnvironmentMapConstant as JConstant
from wurblpt_tpu.scene.builder import EnvironmentMapCube as JCube
from wurblpt_tpu.scene.builder import EnvironmentMapEquiRect as JEquiRect
from wurblpt_tpu.utils import scenes as jscenes
from wurblpt_tpu_torch import native
from wurblpt_tpu_torch.render import envmap
from wurblpt_tpu_torch.scene.ir import EnvMapArrays
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

N = 8192


@functools.lru_cache(maxsize=None)
def _envs():
    """(JAX envmap, the same arrays as the port's EnvMapArrays)."""
    jenv = jenvmap.build_envmap_arrays(JEquiRect(image=jscenes.procedural_sky(),
                                                 importance_resolution=32))
    a = jax.tree_util.tree_map(np.asarray, jenv)
    env = EnvMapArrays(int(a.kind), *(torch.as_tensor(np.array(getattr(a, f)))
                                      for f in EnvMapArrays._fields[1:]))
    return jenv, env


def _dirs(kind):
    rs = np.random.default_rng(4)
    if kind == "random":
        d = rs.normal(size=(N, 3))
    else:   # axis directions: the poles, the u seam (-z) and the centre column (+z)
        d = np.eye(3)[rs.integers(0, 3, N)] * rs.choice([-1.0, 1.0], size=(N, 1))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


def _pdf_agree(a, b):
    off = a.numpy() != np.asarray(b)
    assert off.mean() <= 1e-3, off.mean()


def test_procedural_sky_equals_jax():
    np.testing.assert_array_equal(scenes.procedural_sky(), jscenes.procedural_sky())


def test_build_envmap_arrays_matches_jax():
    jenv, _ = _envs()
    env = envmap.build_envmap_arrays(
        envmap.EnvironmentMapEquiRect(scenes.procedural_sky(), importance_resolution=32), "cpu")
    assert env.kind == 1 and env.importance
    np.testing.assert_array_equal(env.image.numpy(), np.asarray(jenv.image))
    np.testing.assert_array_equal(env.rotation.numpy(), np.asarray(jenv.rotation))
    _close(env.pdf_table, jenv.pdf_table, atol=0.0)
    np.testing.assert_array_equal(env.alias_idx.numpy(), np.asarray(jenv.alias_idx))
    _close(env.alias_prob, jenv.alias_prob, atol=0.0)
    # The sun's cells carry most of the mass.
    assert float(env.pdf_table.max()) > 100 * float(env.pdf_table.median())


@pytest.mark.parametrize("kind", ["random", "axis"])
def test_radiance_and_pdf_match_jax(kind):
    jenv, env = _envs()
    d = _dirs(kind)
    _close(envmap.env_radiance_plain(env, torch.from_numpy(d)),
           jenvmap.env_radiance(jenv, jnp.asarray(d)))
    _pdf_agree(envmap.env_pdf_plain(env, torch.from_numpy(d)), jenvmap.env_pdf(jenv, jnp.asarray(d)))


def test_sample_matches_jax():
    jenv, env = _envs()
    u3 = np.random.default_rng(5).uniform(size=(N, 3)).astype(np.float32)
    u3[:8] = [[0.0, 0.0, 0.0], [0.9999999, 0.9999999, 0.9999999]] * 4   # the table's edges
    d, pdf = envmap.env_sample_plain(env, torch.from_numpy(u3))
    jd, jpdf = jenvmap.env_sample(jenv, jnp.asarray(u3))
    _close(d, jd)
    np.testing.assert_array_equal(pdf.numpy(), np.asarray(jpdf))
    np.testing.assert_allclose(torch.linalg.norm(d, dim=-1).numpy(), 1.0, atol=1e-6)
    # The sampled direction's pdf is the pdf it was sampled with.
    _pdf_agree(envmap.env_pdf_plain(env, d), pdf)


def test_square_sphere_maps_match_jax():
    uv = np.random.default_rng(6).uniform(size=(N, 2)).astype(np.float32)
    s = envmap.square_to_sphere(torch.from_numpy(uv))
    _close(s, jenvmap.square_to_sphere(jnp.asarray(uv)))
    _close(envmap.sphere_to_square(s), jenvmap.sphere_to_square(jnp.asarray(s.numpy())),
           atol=1e-5)


def test_wrappers_take_the_plain_version_on_cpu_and_check_inputs():
    _, env = _envs()
    d = torch.from_numpy(_dirs("random"))
    u3 = torch.rand((N, 3), generator=torch.Generator().manual_seed(0))
    counts = dict(native.LAUNCHES)
    assert torch.equal(envmap.env_radiance(env, d), envmap.env_radiance_plain(env, d))
    for a, b in zip(envmap.env_sample(env, u3), envmap.env_sample_plain(env, u3)):
        assert torch.equal(a, b)
    assert torch.equal(envmap.env_pdf(env, d), envmap.env_pdf_plain(env, d))
    assert native.LAUNCHES == counts           # no kernel ran
    with pytest.raises(ValueError):
        envmap.env_radiance(env, d.double())
    with pytest.raises(ValueError):
        envmap.env_pdf(env, d[:, :2].contiguous())
    with pytest.raises(ValueError, match="cube"):        # an equirect image read as a cube
        envmap.env_radiance(env._replace(kind=2), d)


@functools.lru_cache(maxsize=None)
def _cubes():
    """(JAX cube map, the port's own build of it) with 64 x 64 importance tables."""
    faces = scenes._equirect_to_cube_faces(scenes.procedural_sky(), 32)
    jenv = jenvmap.build_envmap_arrays(JCube(faces=faces, importance_resolution=64))
    return jenv, envmap.build_envmap_arrays(envmap.EnvironmentMapCube(faces, 64), "cpu")


def test_cube_faces_equal_jax():
    ours = scenes._equirect_to_cube_faces(scenes.procedural_sky(), 32)
    ref = jscenes._equirect_to_cube_faces(jscenes.procedural_sky(), 32)
    assert len(ours) == 6
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_cube_tables_match_jax():
    jenv, env = _cubes()
    assert env.kind == 2 and tuple(env.image.shape) == (6, 32, 32, 4) and env.importance
    np.testing.assert_array_equal(env.image.numpy(), np.asarray(jenv.image))
    _close(env.pdf_table, jenv.pdf_table, atol=0.0)
    np.testing.assert_allclose(env.alias_prob.numpy(), np.asarray(jenv.alias_prob), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(env.alias_idx.numpy(), np.asarray(jenv.alias_idx))
    assert float(env.pdf_table.max()) > 100 * float(env.pdf_table.median())   # the sun


@pytest.mark.parametrize("kind", ["random", "axis", "edges"])
def test_cube_radiance_and_pdf_match_jax(kind):
    jenv, env = _cubes()
    d = (kc.cube_edge_directions("cpu") if kind == "edges"
         else torch.from_numpy(_dirs(kind)))
    r = envmap.env_radiance_plain(env, d)
    _close(r, jenvmap.env_radiance(jenv, jnp.asarray(d.numpy())), rtol=1e-6, atol=0.0)
    # The port's tables (not JAX's) differ from JAX's at rtol 4e-7.
    off = ~np.isclose(envmap.env_pdf_plain(env, d).numpy(),
                      np.asarray(jenvmap.env_pdf(jenv, jnp.asarray(d.numpy()))), rtol=1e-6, atol=0)
    assert off.mean() <= 1e-3
    assert float(r.max()) > 100.0 if kind == "random" else bool(torch.isfinite(r).all())


def test_cube_lookup_picks_faces_and_clamps_edges():
    """Axis directions read their face's central texels; +y reads the zenith
    (sky colour), -y the ground colour; ties go to x, then y."""
    img = torch.arange(6, dtype=torch.float32)[:, None, None, None].expand(6, 4, 4, 4).contiguous()
    env = envmap.EnvMapArrays(2, img, torch.zeros((0, 0)), torch.zeros((0,)),
                              torch.zeros((0,), dtype=torch.int32),
                              torch.tensor([0.0, 0.0, 0.0, 1.0]), torch.zeros((4,)))
    d = torch.tensor([[1.0, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                      [1, 1, 0], [0, -1, 1], [-1, 0, 1], [1, 1, 1]])
    face = envmap.env_radiance_plain(env, d / d.norm(dim=-1, keepdim=True))[:, 0]
    assert face.tolist() == [0, 1, 2, 3, 4, 5, 0, 3, 1, 0]


def test_constant_map_matches_jax():
    jenv = jenvmap.build_envmap_arrays(JConstant(radiance=(0.7, 0.8, 1.0)))
    env = envmap.build_envmap_arrays(envmap.EnvironmentMapConstant((0.7, 0.8, 1.0)), "cpu")
    assert env.kind == 3 and not env.importance
    np.testing.assert_array_equal(env.const_radiance.numpy(), np.asarray(jenv.const_radiance))
    d = torch.from_numpy(_dirs("random"))
    np.testing.assert_array_equal(envmap.env_radiance_plain(env, d).numpy(),
                                  np.asarray(jenvmap.env_radiance(jenv, jnp.asarray(d.numpy()))))
    with pytest.raises(ValueError, match="importance"):
        envmap.env_sample(env, torch.zeros((4, 3)))


def test_cube_and_constant_wrappers_take_the_plain_version_on_cpu():
    _, cube = _cubes()
    const = envmap.build_envmap_arrays(envmap.EnvironmentMapConstant((0.7, 0.8, 1.0)), "cpu")
    d = torch.from_numpy(_dirs("random"))
    counts = dict(native.LAUNCHES)
    for env in (cube, const):
        assert torch.equal(envmap.env_radiance(env, d), envmap.env_radiance_plain(env, d))
    assert torch.equal(envmap.env_pdf(cube, d), envmap.env_pdf_plain(cube, d))
    assert native.LAUNCHES == counts
    with pytest.raises(ValueError, match="cube"):
        envmap.env_radiance(cube._replace(image=cube.image[0]), d)
