"""Benchmark scenes for the port (subset of ``wurblpt_tpu/utils/scenes.py``).

Each is built with numpy alone, draw for draw as the JAX builder builds it:
the Cornell box from the port's copy of the reference vertex data
(:mod:`.cornell_data`), the mesh path's `terrain_city`, the city path's
`city_night` with its OBJ/MTL round trip through :mod:`wurblpt_tpu_torch.io.obj`,
the sphere paths' `envmap_spheres` and `rtiow`, the ToF path's `tof_box`, the
animated Cornell box (`cornell_box_animated`) and the two brute-force scenes
past the K1 form's column count and near it (`sphere_field`,
`tri_sphere_field`). Scenes and cameras are built on the GPU unless the
caller names another device.
"""

from __future__ import annotations

import tempfile

import numpy as np

from ..core.transform import Transformation, from_lookat, quat_from_axis_angle
from ..render.envmap import EnvironmentMapConstant, EnvironmentMapCube, EnvironmentMapEquiRect
from ..scene import generator as G
from ..scene.flatten import (
    AnimationKeyframes,
    Glass,
    MeshSpec,
    ModPhong,
    SphereSpec,
    flatten_meshes,
    material_table,
)
from ..scene.ir import MaterialType
from . import cornell_data as cd


def cornell_box_ref(device="cuda"):
    """The reference Cornell box (wurblpt-cornellbox.cpp:43-229 default config):
    the same arrays as ``wurblpt_tpu.utils.scenes.cornell_box_ref().build()``."""
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


def cornell_ref_camera(device="cuda"):
    """Reference viewpoint (wurblpt-cornellbox.cpp:252-256): (pose, vfov_deg)."""
    return from_lookat((0.0, 1.0, 3.2), (0.0, 1.0, -1.0), device=device), 50.0


def cornell_animations():
    """The keyframes of the animated Cornell box, animation ids 1-3, keys at
    t = 0 and t = 1: the short box turns about the world's vertical axis, the
    tall box slides along +x, the ceiling light along +z, by the amounts of
    `kernel_check.ANIM_SHORT_TURN_DEG`, `ANIM_TALL_SLIDE_X` and
    `ANIM_LIGHT_SLIDE_Z`."""
    from .kernel_check import ANIM_LIGHT_SLIDE_Z, ANIM_SHORT_TURN_DEG, ANIM_TALL_SLIDE_X

    rest = Transformation.make()
    return (AnimationKeyframes((0.0, 1.0), (rest, Transformation.make(
                rotation=quat_from_axis_angle((0, 1, 0), np.deg2rad(ANIM_SHORT_TURN_DEG))))),
            AnimationKeyframes((0.0, 1.0), (rest, Transformation.make(
                translation=(ANIM_TALL_SLIDE_X, 0.0, 0.0)))),
            AnimationKeyframes((0.0, 1.0), (rest, Transformation.make(
                translation=(0.0, 0.0, ANIM_LIGHT_SLIDE_Z)))))


CORNELL_ANIM_ID = {"short": 1, "tall": 2, "light": 3}
# The spheres of cornell_box_animated(spheres=True): (centre, radius, animation id).
CORNELL_ANIM_SPHERES = (((0.3, 0.85, 0.4), 0.2, 1), ((-0.45, 0.25, 0.55), 0.25, 0))


def cornell_box_animated(device="cuda", spheres: bool = False):
    """The reference Cornell box with three keyframe animations
    (`cornell_animations`): 36 triangles and 4 animation rows, no BVH. The
    same arrays as the JAX builder makes of the same box
    (``jax_frame_reference.jax_cornell_animated``). With `spheres`, two
    white spheres join it, one riding the short box's turn and one static:
    the sphere branches of the animated casts and hit assembly."""
    names = ("white", "red", "green")
    rows = [(MaterialType.LAMBERTIAN, cd.ALBEDO[n], None) for n in names]
    rows.append((MaterialType.LIGHT_DIFFUSE, cd.LIGHT_RADIANCE, None))
    mat_id = {"white": 0, "red": 1, "green": 2, "tall": 0, "short": 0, "light": 3}
    meshes = [MeshSpec(np.array(pos, np.float32), np.array(nrm, np.float32), cd.UV,
                       cd.IDX, mat_id[mat], anim=CORNELL_ANIM_ID.get(mat, 0))
              for pos, nrm, mat in cd.QUADS]
    lpos, lnrm = cd.LIGHT_QUAD
    meshes.append(MeshSpec(np.array(lpos, np.float32), np.array(lnrm, np.float32),
                           cd.UV_LIGHT, cd.IDX, mat_id["light"], hot_spot=True,
                           anim=CORNELL_ANIM_ID["light"]))
    sph = [SphereSpec(c, r, 0, anim=a) for c, r, a in CORNELL_ANIM_SPHERES] if spheres else []
    return flatten_meshes(meshes, material_table(rows), device, spheres=sph,
                          animations=cornell_animations())


def field_spec(n_tris: int, n_spheres: int, seed: int):
    """numpy draws of a brute-force test field: `n_tris` small triangles
    ([n_tris, 3, 3] vertices) and `n_spheres` spheres (centres, radii) over
    a 20 x 20 ground patch, each with one of four material ids; the scene
    holds the triangles as one mesh per material, in material order."""
    rs = np.random.RandomState(seed)
    base = rs.uniform((-10.0, 0.0, -10.0), (10.0, 2.0, 10.0), (n_tris, 1, 3))
    tris = (base + rs.uniform(-0.35, 0.35, (n_tris, 3, 3))).astype(np.float32)
    centers = rs.uniform((-10.0, 0.2, -10.0), (10.0, 1.5, 10.0), (n_spheres, 3)).astype(np.float32)
    radii = rs.uniform(0.08, 0.3, n_spheres).astype(np.float32)
    return tris, centers, radii, rs.randint(0, 4, n_tris), rs.randint(0, 4, n_spheres)


FIELD_ALBEDO = ((0.7, 0.7, 0.7), (0.7, 0.2, 0.2), (0.2, 0.6, 0.2), (0.3, 0.3, 0.8))
FIELD_SKY = (0.8, 0.9, 1.0)


def _field(n_tris, n_spheres, seed, device):
    tris, centers, radii, tmat, smat = field_spec(n_tris, n_spheres, seed)
    rows = [(MaterialType.LAMBERTIAN, a, None) for a in FIELD_ALBEDO]
    meshes = [MeshSpec(tris[tmat == m].reshape(-1, 3), None, None,
                       np.arange(3 * int((tmat == m).sum()), dtype=np.int32).reshape(-1, 3), m)
              for m in range(len(FIELD_ALBEDO)) if (tmat == m).any()]
    sph = [SphereSpec(tuple(c), float(r), int(m)) for c, r, m in zip(centers, radii, smat)]
    return flatten_meshes(meshes, material_table(rows), device, spheres=sph,
                          envmap=EnvironmentMapConstant(FIELD_SKY))


def sphere_field(n: int = 3000, seed: int = 11, device="cuda"):
    """ROADMAP C.1's first example: `n` Lambertian spheres under a constant
    sky and no BVH. At 3000 spheres the JAX package casts it through its
    matrix form (6144 of 8192 columns): the port through K1."""
    return _field(0, n, seed, device)


def tri_sphere_field(n_tris: int = 2000, n_spheres: int = 40, seed: int = 12, device="cuda"):
    """ROADMAP C.1's second example: 2000 triangles and 40 spheres, no BVH,
    8448 columns: the JAX package sweeps its tiles, and so does the port
    (KS1/KS2)."""
    return _field(n_tris, n_spheres, seed, device)


def field_camera(device="cuda"):
    """A view over the field: (pose, vfov_deg)."""
    return from_lookat((0.0, 4.0, 14.0), (0.0, 0.5, 0.0), device=device), 45.0


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
                 sphere_slices: int = 24, device="cuda"):
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


def terrain_camera(device="cuda"):
    """The bvh_100k bench viewpoint (bench.py bench_bvh_large): (pose, vfov_deg)."""
    return from_lookat((14.0, 9.0, 14.0), (0.0, 0.5, 0.0), device=device), 45.0


def _smooth_positive(shape, seed, lo=0.05, hi=1.0):
    rs = np.random.RandomState(seed)
    a = rs.uniform(lo, hi, shape).astype(np.float32)
    for ax in range(a.ndim):
        a = 0.5 * a + 0.25 * (np.roll(a, 1, ax) + np.roll(a, -1, ax))
    return a.astype(np.float32)


def city_rgl_fields(seed: int = 7):
    """The city's measured material: P = 1, T = 4, a 16 x 16 vndf, 8 x 8
    luminance and rgb tables, smooth positive noise from `seed`."""
    T = 4
    return dict(
        phi_i=np.zeros((1,), np.float32),
        theta_i=np.linspace(0.0, np.pi / 2, T).astype(np.float32),
        ndf=_smooth_positive((16, 16), seed + 11),
        sigma=_smooth_positive((16, 16), seed + 12, 0.2, 0.4),
        vndf=_smooth_positive((1, T, 16, 16), seed + 13),
        luminance=_smooth_positive((1, T, 8, 8), seed + 14),
        rgb=_smooth_positive((1, T, 3, 8, 8), seed + 15),
    )


def city_night(seed: int = 7, terrain_res: int = 320, n_buildings: int = 320,
               n_windows: int = 96, sphere_slices: int = 32, device="cuda"):
    """The city path's scene (bench config city_many_lights at the defaults:
    249218 triangles, 192 light triangles): an fBm terrain, ModPhong box
    buildings, emissive window quads of powers over two decades, GGX and
    mirror spheres, all exported to OBJ/MTL and imported again; then a
    measured-RGL sphere and a dim equirect night sky, behind the port's BVH.

    The same arrays as ``wurblpt_tpu.utils.scenes.city_night(...).build(use_bvh=True)``,
    random draws in the same order. The round trip turns the windows into
    emissive ModPhong, the GGX spheres into Lambertian (Kd, no Ks) and the
    mirrors into ModPhong (Ks), as it does in the JAX package."""
    from ..io.obj import export_scene_to_obj, import_into_scene
    from ..materials.rgl import load_rgl_material

    rs = np.random.RandomState(seed)
    rows = [(MaterialType.LAMBERTIAN, (0.25, 0.28, 0.24), None)]
    phases = [(rs.uniform(0, 2 * np.pi), rs.uniform(0, 2 * np.pi)) for _ in range(4)]

    def fbm(x, z):
        out = np.zeros_like(np.asarray(x, np.float32))
        for octave, (px, pz) in enumerate(phases):
            f = 0.12 * (2.0 ** octave)
            a = 0.9 * (0.5 ** octave)
            out = out + a * np.sin(f * x + px) * np.cos(f * z + pz)
        return out

    res = terrain_res
    xs = np.linspace(-24.0, 24.0, res, dtype=np.float32)
    zs = np.linspace(-24.0, 24.0, res, dtype=np.float32)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    pos = np.stack([xx, fbm(xx, zz), zz], -1).reshape(-1, 3)
    idx = []
    for i in range(res - 1):
        a0 = i * res + np.arange(res - 1)
        idx.append(np.stack([a0, a0 + 1, a0 + res], -1))
        idx.append(np.stack([a0 + 1, a0 + res + 1, a0 + res], -1))
    idx = np.concatenate(idx, 0).astype(np.int32)
    uv = np.stack([(xx + 24.0) / 48.0, (zz + 24.0) / 48.0], -1).reshape(-1, 2)
    meshes = [MeshSpec(pos.astype(np.float32), None, uv.astype(np.float32), idx, 0)]

    cube = G.generate_cube(0.5)
    building_info = []
    for _ in range(n_buildings):
        bx, bz = rs.uniform(-22, 22, 2)
        bh = rs.uniform(0.8, 4.0)
        sx, sz = rs.uniform(0.5, 1.6), rs.uniform(0.5, 1.6)
        col = tuple(0.25 + 0.5 * rs.rand(3))
        rows.append((MaterialType.MODPHONG, col,
                     ModPhong(specular=tuple(0.1 + 0.2 * rs.rand(3)),
                              shininess=float(rs.uniform(20, 160)))))
        ty = float(fbm(bx, bz)) + bh / 2
        tf = Transformation.make(translation=(bx, ty, bz), scale=(sx, bh, sz))
        meshes.append(cube._replace(material=len(rows) - 1, transformation=tf))
        building_info.append((bx, ty, bz, sx, bh, sz))

    for wi in range(n_windows):
        bx, ty, bz, sx, bh, sz = building_info[wi % len(building_info)]
        warm = np.array([1.0, rs.uniform(0.5, 0.9), rs.uniform(0.2, 0.6)])
        rows.append((MaterialType.LIGHT_DIFFUSE, tuple(warm * rs.uniform(2.0, 120.0)), None))
        side = 1.0 if wi % 2 == 0 else -1.0
        wtf = Transformation.make(
            translation=(bx + side * (sx * 0.5 + 0.01), ty + rs.uniform(-0.3, 0.3) * bh, bz),
            rotation=quat_from_axis_angle((0, 1, 0), side * np.pi / 2),
            scale=(0.18, 0.12, 1.0))
        meshes.append(G.generate_quad(1.0, 1.0)._replace(material=len(rows) - 1,
                                                         transformation=wtf, hot_spot=True))

    for i in range(20):
        sx_, sz_ = rs.uniform(-18, 18, 2)
        if i % 3:
            rows.append((MaterialType.GGX, (0.8, 0.7, 0.6), 0.08 + 0.2 * rs.rand()))
        else:
            rows.append((MaterialType.MIRROR, None, None))
        tf = Transformation.make(translation=(sx_, float(fbm(sx_, sz_)) + 1.4, sz_),
                                 scale=(0.8, 0.8, 0.8))
        meshes.append(G.generate_sphere(1.0, slices=sphere_slices, stacks=sphere_slices)
                      ._replace(material=len(rows) - 1, transformation=tf))

    with tempfile.TemporaryDirectory(prefix="wurblpt_city_") as workdir:
        path = f"{workdir}/city_night.obj"
        export_scene_to_obj(meshes, rows, path)
        meshes, rows = import_into_scene(path)

    # After the round trip (MTL cannot hold them): the RGL sphere and the sky.
    rows.append((MaterialType.RGL, None, 0))
    meshes.append(G.generate_sphere(1.0, slices=sphere_slices, stacks=sphere_slices)._replace(
        material=len(rows) - 1,
        transformation=Transformation.make(translation=(0.0, float(fbm(0.0, 4.0)) + 1.6, 4.0),
                                           scale=(1.2, 1.2, 1.2))))
    night = procedural_sky(sun_radiance=2.0) * 0.08
    return flatten_meshes(meshes, material_table(rows), device, use_bvh=True,
                          envmap=EnvironmentMapEquiRect(night.astype(np.float32),
                                                        importance_resolution=32),
                          rgl_tables=[load_rgl_material(city_rgl_fields(seed))])


def city_camera(device="cuda"):
    """The city_many_lights bench viewpoint (bench.py bench_city_many_lights):
    (pose, vfov_deg); the camera is a 360-degree stereo one with eye distance
    0.065 (`utils.kernel_check.CITY_*`)."""
    return from_lookat((0.0, 3.5, 14.0), (0.0, 1.5, 0.0), device=device), 50.0


def _quad_to(translate, rotation_axis, rotation_angle, half=1.0):
    """A 2 half x 2 half quad, rotated about `rotation_axis` and moved to `translate`."""
    tf = Transformation.make(translation=translate,
                             rotation=quat_from_axis_angle(rotation_axis, rotation_angle))
    return G.generate_quad(half, half)._replace(transformation=tf)


def _equirect_to_cube_faces(img: np.ndarray, face_res: int):
    """Point-sample an equirect image into 6 cube faces (+x, -x, +y, -y, +z, -z)."""
    h, w = img.shape[:2]
    uv = (np.arange(face_res) + 0.5) / face_res * 2.0 - 1.0
    b, a = np.meshgrid(uv, uv)  # a = row (v), b = col (u)
    ones = np.ones_like(a)
    dirs = (np.stack([ones, -a, -b], -1), np.stack([-ones, -a, b], -1),
            np.stack([b, ones, a], -1), np.stack([b, -ones, -a], -1),
            np.stack([b, -a, ones], -1), np.stack([-b, -a, -ones], -1))
    faces = []
    for d in dirs:
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        theta = np.arcsin(np.clip(d[..., 1], -1, 1))
        phi = np.arctan2(d[..., 0], -d[..., 2])
        x = np.clip(((phi / np.pi + 1.0) * 0.5 * w).astype(int), 0, w - 1)
        y = np.clip(((0.5 - theta / np.pi) * h).astype(int), 0, h - 1)
        faces.append(img[y, x])
    return faces


def envmap_spheres(cube: bool = False, importance_resolution: int = 64, device="cuda"):
    """The envmap path's scene (bench config envmap_cube_is with cube=True):
    glass, mirror and GGX spheres over a 2-triangle ground under the
    procedural sky, as an equirect map or resampled to 32 x 32 cube faces,
    importance-sampled on an R x R grid (wurblpt-envmap.cpp:60-116). The same
    arrays as ``wurblpt_tpu.utils.scenes.envmap_spheres(cube, R).build()``."""
    rows = [(MaterialType.LAMBERTIAN, (0.4, 0.4, 0.4), None),
            (MaterialType.GLASS, None, Glass(ior=1.5)),
            (MaterialType.MIRROR, None, None),
            (MaterialType.GGX, (0.8, 0.6, 0.3), 0.15)]
    ground = _quad_to((0.0, -0.5, 0.0), (1.0, 0.0, 0.0), -np.pi / 2, half=20.0)
    spheres = [SphereSpec((-1.2, 0.0, 0.0), 0.5, 1), SphereSpec((0.0, 0.0, 0.0), 0.5, 2),
               SphereSpec((1.2, 0.0, 0.0), 0.5, 3)]
    sky = procedural_sky()
    env = (EnvironmentMapCube(_equirect_to_cube_faces(sky, 32), importance_resolution) if cube
           else EnvironmentMapEquiRect(sky, importance_resolution))
    return flatten_meshes([ground._replace(material=0)], material_table(rows), device,
                          envmap=env, spheres=spheres)


def envmap_camera(device="cuda"):
    """The envmap_cube_is bench viewpoint (bench.py bench_envmap_furnace): (pose, vfov_deg)."""
    return from_lookat((0.0, 0.6, 4.0), (0.0, 0.0, 0.0), device=device), 40.0


def rtiow(seed: int = 7, n: int = 6, device="cuda"):
    """The rtiow path's scene (bench config rtiow_distortion at the defaults:
    40 spheres, no triangle): a radius-1000 ground sphere, an n x n grid of
    random Lambertian, GGX and glass spheres and three large ones under a
    constant sky (wurblpt-rtiow.cpp:84-133). The same arrays as
    ``wurblpt_tpu.utils.scenes.rtiow(seed, n).build()``, random draws in the
    same order."""
    rs = np.random.RandomState(seed)
    rows = [(MaterialType.LAMBERTIAN, (0.5, 0.5, 0.5), None)]
    spheres = [SphereSpec((0, -1000, 0), 1000.0, 0)]
    for a in range(-n // 2, n // 2):
        for b in range(-n // 2, n // 2):
            center = (a + 0.9 * rs.rand(), 0.2, b + 0.9 * rs.rand())
            pick = rs.rand()
            if pick < 0.6:
                rows.append((MaterialType.LAMBERTIAN, tuple(rs.rand(3) * rs.rand(3)), None))
            elif pick < 0.85:
                col = 0.5 * (1 + rs.rand(3))
                rows.append((MaterialType.GGX, tuple(col), 0.1 + 0.3 * rs.rand()))
            else:
                rows.append((MaterialType.GLASS, None, Glass(ior=1.5)))
            spheres.append(SphereSpec(center, 0.2, len(rows) - 1))
    rows += [(MaterialType.GLASS, None, Glass(ior=1.5)),
             (MaterialType.LAMBERTIAN, (0.4, 0.2, 0.1), None),
             (MaterialType.GGX, (0.7, 0.6, 0.5), 0.05)]
    m = len(rows)
    spheres += [SphereSpec((0, 1, 0), 1.0, m - 3), SphereSpec((-4, 1, 0), 1.0, m - 2),
                SphereSpec((4, 1, 0), 1.0, m - 1)]
    return flatten_meshes([], material_table(rows), device, spheres=spheres,
                          envmap=EnvironmentMapConstant((0.7, 0.8, 1.0)))


def rtiow_camera(device="cuda"):
    """The rtiow_distortion bench viewpoint (bench.py bench_rtiow): (pose, vfov_deg);
    the camera has OpenCV lens distortion (`utils.kernel_check.RTIOW_*`)."""
    return from_lookat((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), device=device), 30.0


def tof_box(room_half: float = 1.2, device="cuda"):
    """The ToF path's scene (bench config tof_amcw; wurblpt-tof-hcibox.cpp:38-103):
    a closed white Lambertian room of half size `room_half` (5 quads), a small
    box on its floor, and the NIR ToF illumination unit, a 32-triangle disk of
    radius 0.02 at the camera position facing into the room (-z), W = 8 with
    a 40-degree half angle; 54 triangles, 32 lights (per-light MIS). The same
    arrays as ``wurblpt_tpu.utils.scenes.tof_box(room_half).build()``."""
    h = room_half
    rows = [(MaterialType.LAMBERTIAN, (0.7, 0.7, 0.7), None),
            (MaterialType.LIGHT_TOF, 8.0, np.deg2rad(40))]
    meshes = [_quad_to(tr, ax, ang, half=h) for tr, ax, ang in (
        ((0, 0, -h), (1, 0, 0), 0.0),               # back wall
        ((-h, 0, 0), (0, 1, 0), np.pi / 2),          # left
        ((h, 0, 0), (0, 1, 0), -np.pi / 2),          # right
        ((0, -h, 0), (1, 0, 0), -np.pi / 2),         # floor
        ((0, h, 0), (1, 0, 0), np.pi / 2),           # ceiling
    )]
    meshes.append(G.generate_cube(0.25)._replace(
        transformation=Transformation.make(translation=(0.3, -h + 0.25, -0.4))))
    # generate_disk's +z normal turned by pi about y: the light shines into the room.
    tf = Transformation.make(translation=(0.0, 0.0, h - 0.01),
                             rotation=quat_from_axis_angle((0, 1, 0), np.pi))
    meshes.append(G.generate_disk(0.02, material=1)._replace(transformation=tf, hot_spot=True))
    return flatten_meshes(meshes, material_table(rows), device)


def tof_camera(device="cuda"):
    """The tof_amcw bench viewpoint (bench.py bench_tof), at the light: (pose, vfov_deg)."""
    return from_lookat((0.0, 0.0, 1.19), (0.0, 0.0, 0.0), device=device), 60.0
