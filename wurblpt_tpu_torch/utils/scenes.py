"""Benchmark scenes for the port (subset of ``wurblpt_tpu/utils/scenes.py``).

The Cornell-box vertex data lives in ``wurblpt_tpu/utils/cornell_data.py``,
which imports only numpy. It is loaded here by file path, so the JAX package's
``__init__`` (which imports jax) never runs. The mesh path's `terrain_city`
is built here with numpy alone, draw for draw as the JAX builder builds it.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

from ..core.transform import Transformation, from_lookat, quat_from_axis_angle
from ..render.envmap import EnvironmentMapEquiRect
from ..scene import generator as G
from ..scene.flatten import MeshSpec, flatten_meshes, material_table
from ..scene.ir import MaterialType

_CORNELL_DATA = (Path(__file__).resolve().parents[2]
                 / "wurblpt_tpu" / "utils" / "cornell_data.py")


def _cornell_data():
    spec = importlib.util.spec_from_file_location("_wurblpt_cornell_data", _CORNELL_DATA)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cornell_box_ref(device="cpu"):
    """The reference Cornell box (wurblpt-cornellbox.cpp:43-229 default config):
    the same arrays as ``wurblpt_tpu.utils.scenes.cornell_box_ref().build()``."""
    cd = _cornell_data()
    names = ("white", "red", "green")
    rows = [(MaterialType.LAMBERTIAN, cd.ALBEDO[n], None) for n in names]
    rows.append((MaterialType.LIGHT_DIFFUSE, cd.LIGHT_RADIANCE, None))
    mat_id = {"white": 0, "red": 1, "green": 2, "tall": 0, "short": 0, "light": 3}
    meshes = [MeshSpec(np.array(pos, np.float32), np.array(nrm, np.float32), cd.UV,
                       cd.IDX, mat_id[mat])
              for pos, nrm, mat in cd.QUADS]
    lpos, lnrm = cd.LIGHT_QUAD
    meshes.append(MeshSpec(np.array(lpos, np.float32), np.array(lnrm, np.float32),
                           cd.UV_LIGHT, cd.IDX, mat_id["light"], hot_spot=True))
    return flatten_meshes(meshes, material_table(rows), device)


def cornell_ref_camera(device="cpu"):
    """Reference viewpoint (wurblpt-cornellbox.cpp:252-256): (pose, vfov_deg)."""
    return from_lookat((0.0, 1.0, 3.2), (0.0, 1.0, -1.0), device=device), 50.0


def procedural_sky(height: int = 64, sun_dir=(0.4, 0.6, -0.5),
                   sun_radiance: float = 200.0) -> np.ndarray:
    """Small procedural HDR sky (gradient + sun disk) as an equirect image."""
    w = 2 * height
    y, x = np.mgrid[0:height, 0:w]
    theta = (0.5 - (y + 0.5) / height) * np.pi       # latitude
    phi = ((x + 0.5) / w * 2.0 - 1.0) * np.pi
    d = np.stack([np.cos(theta) * np.sin(phi), np.sin(theta),
                  -np.cos(theta) * np.cos(phi)], -1)
    sky_t = np.clip(d[..., 1] * 0.5 + 0.5, 0, 1)[..., None]
    img = (1 - sky_t) * np.array([0.9, 0.7, 0.5]) + sky_t * np.array([0.25, 0.45, 0.9])
    s = np.asarray(sun_dir, np.float64)
    s /= np.linalg.norm(s)
    cos_sun = np.clip((d * s).sum(-1), -1, 1)
    img = img + (cos_sun > np.cos(np.deg2rad(2.5)))[..., None] * sun_radiance
    return img.astype(np.float32)


def terrain_city(seed: int = 3, terrain_res: int = 192, n_buildings: int = 220,
                 sphere_slices: int = 24, device="cpu"):
    """The mesh path's scene (bench config bvh_100k at the defaults: 102098
    triangles): an fBm heightfield terrain, box buildings and tessellated GGX
    and mirror spheres under an importance-sampled sky, with the port's BVH.
    The same arrays as ``wurblpt_tpu.utils.scenes.terrain_city(...).build(use_bvh=True)``,
    random draws in the same order."""
    rs = np.random.RandomState(seed)
    rows = [(MaterialType.LAMBERTIAN, (0.35, 0.4, 0.3), None)]
    phases = [(rs.uniform(0, 2 * np.pi), rs.uniform(0, 2 * np.pi)) for _ in range(4)]

    def fbm(x, z):
        out = np.zeros_like(np.asarray(x, np.float32))
        for octave, (px, pz) in enumerate(phases):
            f = 0.15 * (2.0 ** octave)
            a = 1.2 * (0.5 ** octave)
            out = out + a * np.sin(f * x + px) * np.cos(f * z + pz)
        return out

    res = terrain_res
    xs = np.linspace(-20.0, 20.0, res, dtype=np.float32)
    zs = np.linspace(-20.0, 20.0, res, dtype=np.float32)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    pos = np.stack([xx, fbm(xx, zz), zz], -1).reshape(-1, 3)
    idx = []
    for i in range(res - 1):
        a0 = i * res + np.arange(res - 1)
        idx.append(np.stack([a0, a0 + 1, a0 + res], -1))
        idx.append(np.stack([a0 + 1, a0 + res + 1, a0 + res], -1))
    idx = np.concatenate(idx, 0).astype(np.int32)
    uv = np.stack([(xx + 20.0) / 40.0, (zz + 20.0) / 40.0], -1).reshape(-1, 2)
    meshes = [MeshSpec(pos.astype(np.float32), None, uv.astype(np.float32), idx, 0)]

    cube = G.generate_cube(0.5)
    for _ in range(n_buildings):
        bx, bz = rs.uniform(-18, 18, 2)
        bh = rs.uniform(0.5, 3.0)
        rows.append((MaterialType.LAMBERTIAN, tuple(0.3 + 0.5 * rs.rand(3)), None))
        tf = Transformation.make(
            translation=(bx, float(fbm(bx, bz)) + bh / 2, bz),
            rotation=quat_from_axis_angle((0, 1, 0), rs.uniform(0, np.pi)),
            scale=(rs.uniform(0.4, 1.5), bh, rs.uniform(0.4, 1.5)))
        meshes.append(cube._replace(material=len(rows) - 1, transformation=tf))

    for i in range(24):
        sx, sz = rs.uniform(-15, 15, 2)
        if i % 3:
            rows.append((MaterialType.GGX, (0.8, 0.7, 0.6), 0.1 + 0.2 * rs.rand()))
        else:
            rows.append((MaterialType.MIRROR, None, None))
        mesh = G.generate_sphere(1.0, slices=sphere_slices, stacks=sphere_slices)
        tf = Transformation.make(translation=(sx, 2.0 + rs.rand(), sz), scale=(0.8, 0.8, 0.8))
        meshes.append(mesh._replace(material=len(rows) - 1, transformation=tf))

    return flatten_meshes(meshes, material_table(rows), device, use_bvh=True,
                          envmap=EnvironmentMapEquiRect(procedural_sky(), importance_resolution=32))


def terrain_camera(device="cpu"):
    """The bvh_100k bench viewpoint (bench.py bench_bvh_large): (pose, vfov_deg)."""
    return from_lookat((14.0, 9.0, 14.0), (0.0, 0.5, 0.0), device=device), 45.0
