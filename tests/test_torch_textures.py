"""Textures, normal maps and textured ModPhong of the port against the JAX
package, on the same texture tables, hits and uniforms.

* `sample_texture` per texture type (constant, checker, image bilinear and
  nearest, value, gradient, Worley, signed Perlin, Perlin turbulence) on
  seeded uv over [-3, 3]^2 (negative lattice cells, wrapped images): equal
  but for the hashed gradient's cos/sin and the Worley distance's sqrt,
  which XLA and PyTorch round an ulp apart (atol 1e-6).
* `apply_normal_map`: the identity map leaves the normal, a tilted map
  tilts it by its angle and the tangent stays orthogonal (mirrors
  tests/test_shading_features.py:48,63), and on random hits of a brick map
  the port's frame equals JAX's (atol 1e-5: the Gram-Schmidt residual).
* ModPhong with map_Ks (a checker), a map_d opacity texture and an
  emission texture: bsdf_eval and bsdf_sample on the same hits equal JAX's
  (rtol 1e-4, the pow of the Phong lobe); the map_Ks checker modulates the
  specular lobe and the textured sample agrees with its pdf (mirrors
  tests/test_modphong.py:183,213); the opacity map gates transmission
  (mirrors :102).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu import SceneStatic as JSceneStatic
from wurblpt_tpu.render import bsdf as jbsdf
from wurblpt_tpu.render.intersect import scene_closest_hit as jscene_closest_hit
from wurblpt_tpu.render.texture import sample_texture as jsample_texture
from wurblpt_tpu.scene import builder as JB
from wurblpt_tpu.scene import generator as JG
from wurblpt_tpu_torch import scene_from_numpy
from wurblpt_tpu_torch.render import bsdf
from wurblpt_tpu_torch.render.intersect import HitRecord
from wurblpt_tpu_torch.render.texture import TexCtx, apply_textures, sample_texture
from wurblpt_tpu_torch.scene import builder as B
from wurblpt_tpu_torch.scene.ir import TextureType

torch.set_num_threads(2)

_IMG = np.random.RandomState(0).uniform(0, 1, (5, 7, 3)).astype(np.float32)


def _textures(M):
    """One texture of each type, in the builder module M (JAX's or the port's)."""
    return {
        "constant": M.ConstantTexture(color=(0.2, 0.3, 0.4), val_scale=(2.0, 1.0, 1.0, 1.0)),
        "checker": M.CheckerTexture(color1=(0.1,) * 3, color2=(0.9, 0.5, 0.2), squares=(5, 3)),
        "image": M.ImageTexture(image=_IMG, srgb=False, uv_offset=(0.1, -0.2)),
        "image_nearest": M.ImageTexture(image=_IMG, srgb=False, linear_filtering=False),
        "value": M.NoiseTexture(kind=TextureType.VALUE_NOISE, octaves=4, frequency=6.0),
        "gradient": M.NoiseTexture(kind=TextureType.GRADIENT_NOISE, octaves=3, frequency=5.0,
                                   seed=2),
        "worley": M.NoiseTexture(kind=TextureType.WORLEY_NOISE, frequency=8.0, seed=3),
        "perlin": M.NoiseTexture(kind=TextureType.PERLIN_NOISE, frequency=8.0,
                                 val_scale=(0.7, 0.7, 0.7, 1.0), val_offset=(0.5, 0.5, 0.5, 0.0)),
        "turbulence": M.NoiseTexture(kind=TextureType.PERLIN_NOISE, octaves=7, frequency=6.0,
                                     turbulence=True),
    }


def _texture_scene(M, **build):
    sc = M.Scene()
    for i, tex in enumerate(_textures(M).values()):
        mesh = M.Mesh(np.array([[0, 0, i], [1, 0, i], [0, 1, i]], np.float32),
                      texcoords=np.zeros((3, 2), np.float32))
        sc.take_mesh_instance(M.MeshInstance(mesh, M.Lambertian(albedo=tex)))
    return sc.build(**build)


@pytest.fixture(scope="module")
def texture_scenes():
    return _texture_scene(JB), _texture_scene(B, device="cpu")


@pytest.mark.parametrize("tid, name", list(enumerate(_textures(B))))
def test_sample_texture_matches_jax(texture_scenes, tid, name):
    js, ps = texture_scenes
    n = 4096
    uv = np.random.default_rng(tid).uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    ids = np.full((n,), tid, np.int32)
    ref = np.asarray(jsample_texture(js.textures, jnp.asarray(ids), jnp.asarray(uv)))
    ctx = TexCtx.of(ps)
    got = sample_texture(ps.textures, torch.from_numpy(ids), torch.from_numpy(uv), ctx.static,
                         ctx.desc)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0.0, atol=1e-6)


def _quad_scene(M, material, **build):
    sc = M.Scene()
    sc.take_mesh_instance(M.MeshInstance(M.Mesh(*_quad_arrays()), material))
    return sc.build(**build)


def _quad_arrays():
    q = JG.generate_quad(2.0, 2.0)
    return q.positions, q.normals, q.texcoords, None, q.indices


def _hits(js, n, seed, tilt=0.0):
    """JAX hits of n rays down onto the z = 0 quad from z = 1.5 (tilted by
    `tilt` in x), and the rays' directions."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.4, 1.4, (n, 2)).astype(np.float32)
    o = np.concatenate([xy, np.full((n, 1), 1.5, np.float32)], 1)
    d = np.tile(np.array([[tilt, 0.0, -1.0]], np.float32), (n, 1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jhr = jscene_closest_hit(js, jnp.asarray(o), jnp.asarray(d), jnp.full((n,), 1e-4),
                             jnp.full((n,), 1e9))
    assert bool(np.asarray(jhr.hit).all())
    return jhr, d


def _port_rows(ps, jhr):
    """The port's hit record of the JAX hits, its material rows with their
    texture ids, the normal map applied and the textures folded in."""
    hr = HitRecord(*(torch.from_numpy(np.array(x)) for x in jhr))
    tex = TexCtx.of(ps)
    mrow = bsdf.gather_material_rows(bsdf.pack_material_table(ps.materials), hr.mat,
                                     None if tex is None else tex.ids)
    hr = bsdf.apply_normal_map(hr, mrow, tex)
    return hr, apply_textures(mrow, tex, hr.uv)


def _port(js):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")


@pytest.mark.parametrize("texel, tilt", [((0.5, 0.5, 1.0), 0.0),
                                         (((np.sin(0.4) + 1) / 2, 0.5, (np.cos(0.4) + 1) / 2),
                                          0.4)], ids=["identity", "tilted"])
def test_normal_map_identity_and_tilt(texel, tilt):
    """The identity map leaves the normal; a map tilted by 0.4 rad in x
    tilts it by that angle, its tangent re-orthogonalized."""
    nm = B.ImageTexture(image=np.full((4, 4, 3), texel, np.float32), srgb=False)
    ps = _quad_scene(B, B.Lambertian(albedo=(0.8,) * 3, normal_map=nm), device="cpu")
    js = _quad_scene(JB, JB.Lambertian(albedo=(0.8,) * 3, normal_map=JB.ImageTexture(
        image=np.full((4, 4, 3), texel, np.float32), srgb=False)))
    jhr, _ = _hits(js, 1, 0)
    hr, _ = _port_rows(ps, jhr)
    n = hr.normal[0].numpy()
    assert abs(np.linalg.norm(n) - 1.0) < 1e-5
    assert abs(n[2] - np.cos(tilt)) < 1e-3 and abs(abs(n[0]) - np.sin(tilt)) < 1e-3
    assert abs(float(torch.dot(hr.tangent[0], hr.normal[0]))) < 1e-4
    jn = np.asarray(jbsdf.apply_normal_map(js, JSceneStatic.from_scene(js), jhr).normal)[0]
    np.testing.assert_allclose(n, jn, atol=1e-6)


def test_normal_map_frames_match_jax():
    """A 64^2 brick normal map on the quad: on 4096 random hits the mapped
    normal and tangent equal JAX's (atol 1e-5, the Gram-Schmidt residual)."""
    from wurblpt_tpu_torch.utils.scenes import brick_normal_map

    img = brick_normal_map(64, 64)
    js = _quad_scene(JB, JB.Lambertian(normal_map=JB.ImageTexture(image=img, srgb=False)))
    ps = _port(js)
    jhr, _ = _hits(js, 4096, 5)
    hr, _ = _port_rows(ps, jhr)
    jhr2 = jbsdf.apply_normal_map(js, JSceneStatic.from_scene(js), jhr)
    moved = (np.abs(np.asarray(jhr2.normal) - np.asarray(jhr.normal)) > 1e-3).any(-1)
    assert moved.mean() > 0.2
    np.testing.assert_allclose(hr.normal.numpy(), np.asarray(jhr2.normal), atol=1e-5)
    np.testing.assert_allclose(hr.tangent.numpy(), np.asarray(jhr2.tangent), atol=1e-5)


def _modphong(M, **kw):
    return M.ModPhong(diffuse=M.CheckerTexture(color1=(0.1, 0.2, 0.3), color2=(0.5, 0.4, 0.3),
                                               squares=(3, 3)),
                      specular=M.CheckerTexture(color1=(0.05,) * 3, color2=(0.9,) * 3,
                                                squares=(4, 4)),
                      shininess=30.0, **kw)


@pytest.mark.parametrize("opacity", ["opaque", "map_d"])
def test_textured_modphong_matches_jax(opacity):
    """ModPhong with a checker diffuse and map_Ks (and a map_d opacity
    texture, an emission texture): bsdf_eval, bsdf_sample and the emission
    on the same hits and uniforms as JAX's."""
    def mat(M):
        extra = {}
        if opacity == "map_d":
            alpha = np.zeros((4, 8, 3), np.float32)
            alpha[:, :4] = 1.0
            extra = dict(opacity=M.ImageTexture(image=alpha, srgb=False, linear_filtering=False),
                         ior=1.3, transmissive=(0.9, 0.8, 0.7),
                         emissive=M.ConstantTexture(color=(0.3, 0.2, 0.1)))
        return _modphong(M, **extra)

    js = _quad_scene(JB, mat(JB))
    ps = _quad_scene(B, mat(B), device="cpu")
    n = 4096
    jhr, d = _hits(js, n, 9, tilt=0.3)
    hr, mrow = _port_rows(ps, jhr)
    static = JSceneStatic.from_scene(js)
    rng = np.random.default_rng(4)
    u4, ul, uc = (rng.random((n, 4)).astype(np.float32), rng.random(n).astype(np.float32),
                  rng.random(n).astype(np.float32))
    wd = rng.normal(size=(n, 3)).astype(np.float32)
    wd[:, 2] = np.abs(wd[:, 2])
    wd /= np.linalg.norm(wd, axis=-1, keepdims=True)
    jf, jp = jbsdf.bsdf_eval(js, static, jhr, jnp.asarray(d), jnp.asarray(wd))
    f, p = bsdf.bsdf_eval(hr, torch.from_numpy(d), torch.from_numpy(wd), mrow,
                          frozenset({5}))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-6)
    jsr = jbsdf.bsdf_sample(js, static, jhr, jnp.asarray(d), jnp.ones((n, 4)), jnp.asarray(u4),
                            jnp.asarray(ul), jnp.asarray(uc))
    sr = bsdf.bsdf_sample(hr, torch.from_numpy(d), torch.ones((n, 4)), torch.from_numpy(u4),
                          torch.from_numpy(ul), torch.from_numpy(uc), mrow, frozenset({5}))
    assert np.array_equal(sr.kind.numpy(), np.asarray(jsr.kind))
    np.testing.assert_allclose(sr.direction.numpy(), np.asarray(jsr.direction), atol=1e-5)
    np.testing.assert_allclose(sr.atten.numpy(), np.asarray(jsr.atten), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sr.pdf.numpy(), np.asarray(jsr.pdf), rtol=1e-4, atol=1e-6)
    je = jbsdf.emitted(js, static, jhr, -jnp.asarray(d))
    np.testing.assert_allclose(bsdf.emitted(hr, -torch.from_numpy(d), mrow).numpy(),
                               np.asarray(je), rtol=1e-6, atol=1e-7)
    if opacity == "map_d":
        # the opacity map gates transmission: opaque in u < 1/2, see-through beyond
        through = sr.kind.numpy() == bsdf.ScatterKind.EXPLICIT
        u = hr.uv[:, 0].numpy()
        assert not through[u < 0.45].any() and through[u > 0.55].mean() > 0.9


def test_map_ks_drives_specular_and_sample_agrees_with_pdf():
    """A black-and-white map_Ks checker: black squares shade as pure diffuse,
    white ones add the Phong lobe; a textured sample's pdf equals bsdf_eval's
    pdf of its direction (tests/test_modphong.py:183,213)."""
    ps = _quad_scene(B, B.ModPhong(diffuse=(0.3,) * 3, specular=B.CheckerTexture(
        color1=(0, 0, 0), color2=(1, 1, 1), squares=(4, 4)), shininess=30.0), device="cpu")
    js = _quad_scene(JB, JB.ModPhong(diffuse=(0.3,) * 3, shininess=30.0))
    n = 4096
    jhr, d = _hits(js, n, 11)
    hr, mrow = _port_rows(ps, jhr)
    d = torch.from_numpy(d)
    f, _ = bsdf.bsdf_eval(hr, d, torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3), mrow,
                          frozenset({5}))
    f = f[:, :3].mean(-1)
    black = mrow.p1[:, 0] < 0.5
    assert bool(black.any()) and bool((~black).any())
    assert torch.allclose(f[black], torch.tensor(0.3 / np.pi), rtol=1e-3)
    assert bool((f[~black] > 5 * 0.3 / np.pi).all())
    rng = np.random.default_rng(7)
    sr = bsdf.bsdf_sample(hr, d, torch.ones((n, 4)), torch.from_numpy(rng.random((n, 4)).astype(
        np.float32)), torch.from_numpy(rng.random(n).astype(np.float32)),
        torch.from_numpy(rng.random(n).astype(np.float32)), mrow, frozenset({5}))
    rand = sr.kind == bsdf.ScatterKind.RANDOM
    _, pe = bsdf.bsdf_eval(hr, d, sr.direction, mrow, frozenset({5}))
    rel = ((sr.pdf - pe).abs() / torch.clamp_min(sr.pdf, 1e-6))[rand]
    assert float((rel < 5e-3).float().mean()) >= 0.97
