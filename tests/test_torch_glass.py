"""The glass lobe and the Fresnel terms of the port against the JAX package,
on the same hits and uniforms.

Hits are JAX hit records of random rays on analytic glass spheres, from
outside and from inside (backside hits, total internal reflection): a
non-dispersive sphere (ior 1.5), a dispersive one (ior per channel 1.45 /
1.5 / 1.55 / 1.55) and an absorbing one (absorption 0.3 / 0.2 / 0.1 / 0).
The incoming per-channel IOR is 1 or the sphere's, by lane. Scatter kind
and the new IOR must be equal; directions and attenuations within atol
1e-5 (XLA contracts the Fresnel and refraction terms into FMAs on the CPU,
PyTorch does not, so the last bits differ; the refracted direction
magnifies them near the critical angle). Fresnel on its own: atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wurblpt_tpu import SceneStatic as JSceneStatic
from wurblpt_tpu.core import fresnel as jfresnel
from wurblpt_tpu.render import bsdf as jbsdf
from wurblpt_tpu.render.intersect import assemble_hit as jassemble_hit
from wurblpt_tpu.render.intersect import scene_raw_hit as jscene_raw_hit
from wurblpt_tpu.scene import builder as B
from wurblpt_tpu_torch import scene_from_numpy
from wurblpt_tpu_torch.core import fresnel
from wurblpt_tpu_torch.render import bsdf
from wurblpt_tpu_torch.render.intersect import HitRecord
from wurblpt_tpu_torch.scene.ir import MaterialType

torch.set_num_threads(2)

N = 8192
IORS = (1.5, (1.45, 1.5, 1.55), 1.5)


def test_fresnel_matches_jax():
    rs = np.random.default_rng(21)
    cos_i = rs.uniform(-0.1, 1.1, N).astype(np.float32)
    n_i = rs.choice([1.0, 1.33, 1.5, 2.4], N).astype(np.float32)
    n_t = rs.choice([1.0, 1.33, 1.5, 2.4], N).astype(np.float32)
    f = fresnel.fresnel_unpolarized(*(torch.from_numpy(x) for x in (cos_i, n_i, n_t)))
    jf = jfresnel.fresnel_unpolarized(*(jnp.asarray(x) for x in (cos_i, n_i, n_t)))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-6)
    tir = (n_i > n_t) & ((n_i / n_t) ** 2 * (1 - np.clip(cos_i, 0, 1) ** 2) >= 1.0)
    assert tir.sum() > 100 and (f.numpy()[tir] == 1.0).all()
    r0 = fresnel.schlick_r0(torch.from_numpy(n_i), torch.from_numpy(n_t))
    np.testing.assert_allclose(r0.numpy(), np.asarray(jfresnel.schlick_r0(n_i, n_t)), atol=1e-7)


@functools.lru_cache(maxsize=None)
def _glass_case():
    sc = B.Scene()
    for i, ior in enumerate(IORS):
        absorption = (0.3, 0.2, 0.1, 0.0) if i == 2 else (0.0, 0.0, 0.0, 0.0)
        sc.take_sphere(B.SphereObject((3.0 * i - 3.0, 0.0, 0.0), 1.0,
                                      sc.take_material(B.Glass(ior=ior, absorption=absorption))))
    jscene = sc.build()
    scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")
    rs = np.random.default_rng(22)
    o = np.stack([rs.uniform(-5, 5, N), rs.uniform(-2, 2, N), rs.uniform(-2, 2, N)], -1)
    inside = rs.uniform(size=N) < 0.4
    o[inside] = np.array([[-3.0, 0, 0], [0, 0, 0], [3.0, 0, 0]])[rs.integers(0, 3, inside.sum())]
    o[inside] += rs.uniform(-0.5, 0.5, (inside.sum(), 3))
    d = rs.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
    jhr = jassemble_hit(jscene, o, d, *jscene_raw_hit(jscene, o, d, jnp.full((N,), 1e-4),
                                                      jnp.full((N,), 3e37)))
    uni = rs.uniform(size=(N, 4)).astype(np.float32)
    mat_ior = np.asarray(jscene.materials.p0)[np.asarray(jhr.mat)]
    ior = np.where((rs.uniform(size=N) < 0.5)[:, None], mat_ior, 1.0).astype(np.float32)
    return jscene, scene, d, jhr, uni, ior


def test_material_rows_of_glass():
    jscene, scene, *_ = _glass_case()
    m = scene.materials
    assert (m.typ == MaterialType.GLASS).all() and (m.albedo == 1.0).all()
    np.testing.assert_array_equal(m.p0.numpy(), np.float32([[1.5] * 4, [1.45, 1.5, 1.55, 1.55],
                                                         [1.5] * 4]))
    np.testing.assert_array_equal(m.p1[2].numpy(), np.float32([0.3, 0.2, 0.1, 0.0]))


def test_glass_sample_matches_jax():
    jscene, scene, d, jhr, uni, ior = _glass_case()
    static = JSceneStatic.from_scene(jscene)
    assert static.mat_types == {MaterialType.GLASS}
    js = jbsdf.bsdf_sample(jscene, static, jhr, d, jnp.asarray(ior), jnp.asarray(uni),
                           jnp.asarray(uni[:, 2]), jnp.asarray(uni[:, 3]))
    hr = HitRecord(*(torch.from_numpy(np.array(x)) for x in jhr))
    mrow = bsdf.gather_material_rows(bsdf.pack_material_table(scene.materials), hr.mat)
    ts = bsdf.bsdf_sample(hr, torch.from_numpy(np.array(d)), torch.from_numpy(ior),
                          torch.from_numpy(uni), torch.from_numpy(uni[:, 2]),
                          torch.from_numpy(uni[:, 3]), mrow, static.mat_types)
    hit = np.asarray(jhr.hit)
    kind = ts.kind.numpy()
    np.testing.assert_array_equal(kind, np.asarray(js.kind))
    assert (kind[hit] == bsdf.ScatterKind.EXPLICIT).all()
    np.testing.assert_array_equal(ts.ior.numpy(), np.asarray(js.ior))
    np.testing.assert_allclose(ts.direction.numpy(), np.asarray(js.direction), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.atten.numpy(), np.asarray(js.atten), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ts.pdf.numpy()[hit], 1.0)

    # Every branch occurs: backsides, refraction and reflection (the Fresnel
    # pick and total internal reflection), the x4 dispersion channel, absorption.
    back = np.asarray(jhr.backside) & hit
    refracted = hit & (np.sum(ts.direction.numpy() * np.asarray(jhr.normal), -1) < 0)
    a = ts.atten.numpy()
    assert back.sum() > 1000 and refracted.sum() > 2000 and (hit & ~refracted).sum() > 300
    assert ((a == 4.0).sum(-1) == 1)[hit & (np.asarray(jhr.mat) == 1)].all()
    absorbed = back & (np.asarray(jhr.mat) == 2)
    assert absorbed.sum() > 100 and (a[absorbed, 0] < a[absorbed, 2]).all()
    # The ray's IOR: kept on reflection, 1 on exit, the material's on entry.
    n_after, n_mat = ts.ior.numpy(), scene.materials.p0.numpy()[np.asarray(jhr.mat)]
    assert (n_after[refracted & back] == 1.0).all()
    assert (n_after[refracted & ~back] == n_mat[refracted & ~back]).all()
    assert (n_after[hit & ~refracted] == ior[hit & ~refracted]).all()
