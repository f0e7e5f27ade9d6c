"""Texture maps through the port's OBJ/MTL export and import (io/obj.py)
against the JAX package's.

A scene whose ModPhong names map_Kd (an RGBA image, written as RGB: the
export drops the alpha, as the JAX package's does), map_Ks, map_Ke and a
normal map, a Lambertian with a map_Bump
height map turned into a normal map on import (bump_to_normal_map), and a
plain Lambertian is exported by the port; the MTL and the PNG files equal
what the JAX package writes for the same scene; the port's import of them
builds, field by field, what the JAX import builds (the texels as PIL
reads them), and the map_Ks round trip of tests/test_modphong.py:241
holds: the re-imported specular map modulates the Phong lobe across uv.
PIL reads and writes the images; without it the test skips."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

from wurblpt_tpu.io import obj as jobj  # noqa: E402
from wurblpt_tpu.scene import builder as JB  # noqa: E402
from wurblpt_tpu.scene import generator as JG  # noqa: E402
from wurblpt_tpu_torch import scene_from_numpy  # noqa: E402
from wurblpt_tpu_torch.io import obj  # noqa: E402
from wurblpt_tpu_torch.render import bsdf  # noqa: E402
from wurblpt_tpu_torch.render.integrator import prepare_scene  # noqa: E402
from wurblpt_tpu_torch.render.intersect import assemble_hit, scene_raw_hit  # noqa: E402
from wurblpt_tpu_torch.render.texture import apply_textures  # noqa: E402
from wurblpt_tpu_torch.scene import builder as B  # noqa: E402
from wurblpt_tpu_torch.scene import generator as G  # noqa: E402
from wurblpt_tpu_torch.core.transform import Transformation  # noqa: E402

from test_torch_builder import _same_scene  # noqa: E402

torch.set_num_threads(2)


def _scene(M, Gen, T):
    rs = np.random.RandomState(1)
    rgba = rs.uniform(0, 1, (8, 8, 4)).astype(np.float32)
    ks = np.zeros((8, 8, 3), np.float32)
    ks[:, 4:] = 1.0
    ke = rs.uniform(0, 1, (4, 4, 3)).astype(np.float32)
    nm = np.tile(np.array([0.55, 0.5, 0.9], np.float32), (4, 4, 1))
    sc = M.Scene()
    sc.take_mesh_instance(M.MeshInstance(Gen.generate_quad(2.0, 2.0), M.ModPhong(
        diffuse=M.ImageTexture(image=rgba, srgb=False), specular=M.ImageTexture(image=ks,
                                                                                srgb=False),
        emissive=M.ImageTexture(image=ke, srgb=False), shininess=25.0,
        normal_map=M.ImageTexture(image=nm, srgb=False))))
    sc.take_mesh_instance(M.MeshInstance(Gen.generate_quad(1.0, 1.0), M.Lambertian(
        albedo=(0.4, 0.5, 0.6)), T.make(translation=(0.0, 0.0, -1.0))))
    return sc


def _bump_mtl(dirname):
    """A Lambertian whose MTL names a map_Bump height map (PNG)."""
    from PIL import Image

    h = (np.add.outer(np.arange(8), np.arange(8)) % 4 * 60).astype(np.uint8)
    Image.fromarray(h).save(os.path.join(dirname, "bump.png"))
    with open(os.path.join(dirname, "bumpy.mtl"), "w") as f:
        f.write("newmtl bumpy\nKd 0.5 0.5 0.5\nTf 1 1 1\nmap_Bump -bm 0.5 bump.png\n")
    with open(os.path.join(dirname, "bumpy.obj"), "w") as f:
        f.write("mtllib bumpy.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
                "vn 0 0 1\nusemtl bumpy\nf 1/1/1 2/2/1 3/3/1\n")
    return os.path.join(dirname, "bumpy.obj")


def test_export_writes_what_the_jax_package_writes(tmp_path):
    ours, ref = tmp_path / "port", tmp_path / "jax"
    obj.export_scene_to_obj(_scene(B, G, Transformation), str(ours / "s.obj"))
    from wurblpt_tpu.core.transform import Transformation as JT

    jobj.export_scene_to_obj(_scene(JB, JG, JT), str(ref / "s.obj"))
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(ours)) and len(names) == 6   # obj, mtl, 4 PNGs
    for n in names:
        assert (ours / n).read_bytes() == (ref / n).read_bytes(), n
    mtl = (ours / "s.mtl").read_text()
    for key in ("map_Kd", "map_Ks", "map_Ke", "norm"):
        assert key in mtl, key


def test_import_builds_what_the_jax_import_builds(tmp_path):
    obj.export_scene_to_obj(_scene(B, G, Transformation), str(tmp_path / "s.obj"))
    bump = _bump_mtl(str(tmp_path))
    ours, ref = B.Scene(), JB.Scene()
    for path in (str(tmp_path / "s.obj"), bump):
        assert obj.import_into_scene(ours, path) == jobj.import_into_scene(ref, path)
    ps = ours.build(device="cpu")
    _same_scene(ps, scene_from_numpy(jax.tree_util.tree_map(np.asarray, ref.build()), "cpu"))
    m = ps.materials
    # the ModPhong's maps (the alpha dropped: no opacity map); map_Bump: a normal map
    assert int(m.albedo_tex[0]) >= 0 and int(m.spec_tex[0]) >= 0 and int(m.opacity_tex[0]) < 0
    assert int(m.emissive_tex[0]) >= 0 and int(m.normal_tex[0]) >= 0
    assert int(m.normal_tex[2]) >= 0 and int(m.albedo_tex[2]) < 0
    assert ps.light_prims.numel() == 2       # the ModPhong's map_Ke makes it a hot spot


def test_map_ks_survives_the_round_trip(tmp_path):
    """tests/test_modphong.py:241: the re-imported map_Ks modulates the
    specular lobe across uv (its white half at least 3x its black half)."""
    img = np.zeros((8, 8, 3), np.float32)
    img[:, 4:] = 1.0
    sc = B.Scene()
    sc.take_mesh_instance(B.MeshInstance(G.generate_quad(2.0, 2.0), B.ModPhong(
        diffuse=(0.3, 0.3, 0.3), specular=B.ImageTexture(image=img, srgb=False),
        shininess=25.0)))
    path = str(tmp_path / "ks.obj")
    obj.export_scene_to_obj(sc, path)
    sc2 = B.Scene()
    obj.import_into_scene(sc2, path)
    scene = sc2.build(device="cpu")
    assert int(scene.materials.spec_tex.max()) >= 0, "map_Ks lost in the OBJ round trip"
    static = bsdf.SceneStatic.from_scene(scene)
    tables = prepare_scene(scene, static, step=False)
    n = 512
    xy = np.random.default_rng(3).uniform(-0.9, 0.9, (n, 2)).astype(np.float32)
    o = torch.from_numpy(np.concatenate([xy, np.full((n, 1), 1.5, np.float32)], 1))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(n, 3).contiguous()
    t, prim, u, v = scene_raw_hit(tables.accel, o, d, torch.full((n,), 1e-4),
                                  torch.full((n,), 1e9))
    hr = assemble_hit(tables.hit, o, d, t, prim, u, v)
    mrow = apply_textures(bsdf.gather_material_rows(tables.mat, hr.mat, tables.tex.ids),
                          tables.tex, hr.uv)
    f, _ = bsdf.bsdf_eval(hr, d, torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3), mrow,
                          static.mat_types)
    f = f[:, :3].mean(-1)
    uu = hr.uv[:, 0]
    lo, hi = f[uu < 0.45], f[uu > 0.55]
    assert lo.numel() and hi.numel() and float(hi.mean()) > 3 * float(lo.mean())
