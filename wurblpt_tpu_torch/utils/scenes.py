"""Benchmark scenes for the port (subset of ``wurblpt_tpu/utils/scenes.py``).

Each is built with numpy alone, draw for draw as the JAX builder builds it:
the Cornell box from the port's copy of the reference vertex data
(:mod:`.cornell_data`), the mesh path's `terrain_city`, the city path's
`city_night` with its OBJ/MTL round trip through :mod:`wurblpt_tpu_torch.io.obj`,
the sphere paths' `envmap_spheres` and `rtiow`, the ToF path's `tof_box`, the
animated Cornell box (`cornell_box_animated`) and the two brute-force scenes
past the K1 form's column count and near it (`sphere_field`,
`tri_sphere_field`), and the example apps' scenes built through the port's
`Scene` as the apps build theirs (those with participating media among
them: `participating_media`, `stagelights`). Scenes and cameras are built on the GPU unless the
caller names another device.
"""

from __future__ import annotations

import tempfile

import numpy as np

from ..core.transform import Transformation, from_lookat, quat_from_axis_angle
from ..render.envmap import EnvironmentMapConstant, EnvironmentMapCube, EnvironmentMapEquiRect
from ..scene import builder as B
from ..scene import generator as G
from ..scene.builder import AnimationKeyframes, Glass
from ..scene.flatten import MeshSpec, SphereSpec, flatten_meshes, material_table
from ..scene.ir import MaterialType, TextureType
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


def cornell_box_animated(device="cuda", spheres: bool = False, use_bvh: bool = False,
                         t0: float = 0.5, t1: float = 0.5):
    """The reference Cornell box with three keyframe animations
    (`cornell_animations`): 36 triangles and 4 animation rows, no BVH unless
    `use_bvh` (its boxes swept over [t0, t1], the frame's instant by
    default). The same arrays as the JAX builder makes of the same box
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
    return flatten_meshes(meshes, material_table(rows), device, use_bvh, spheres=sph,
                          animations=cornell_animations(), t0=t0, t1=t1)


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
    return flatten_meshes(meshes, material_table(rows), device, use_bvh=False, spheres=sph,
                          envmap=EnvironmentMapConstant(FIELD_SKY))


def sphere_field(n: int = 3000, seed: int = 11, device="cuda"):
    """ROADMAP C.1's first example: `n` Lambertian spheres under a constant
    sky and no BVH (use_bvh=False, as its JAX build has it). At 3000 spheres the JAX package casts it through its
    matrix form (6144 of 8192 columns): the port through K1."""
    return _field(0, n, seed, device)


def tri_sphere_field(n_tris: int = 2000, n_spheres: int = 40, seed: int = 12, device="cuda"):
    """ROADMAP C.1's second example: 2000 triangles and 40 spheres, no BVH
    (use_bvh=False, as its JAX build has it), 8448 columns: the JAX package sweeps its tiles, and so does the port
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
        meshes.append(MeshSpec.of(cube, len(rows) - 1, transformation=tf))

    for i in range(24):
        sx, sz = rs.uniform(-15, 15, 2)
        if i % 3:
            rows.append((MaterialType.GGX, (0.8, 0.7, 0.6), 0.1 + 0.2 * rs.rand()))
        else:
            rows.append((MaterialType.MIRROR, None, None))
        mesh = G.generate_sphere(1.0, slices=sphere_slices, stacks=sphere_slices)
        tf = Transformation.make(translation=(sx, 2.0 + rs.rand(), sz), scale=(0.8, 0.8, 0.8))
        meshes.append(MeshSpec.of(mesh, len(rows) - 1, transformation=tf))

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
    mirror spheres, built as a builder Scene, exported to OBJ/MTL and
    imported again; then a measured-RGL sphere and a dim equirect night sky,
    behind the port's BVH.

    The same arrays as ``wurblpt_tpu.utils.scenes.city_night(...).build(use_bvh=True)``,
    random draws in the same order. The round trip turns the windows into
    emissive ModPhong, the GGX spheres into Lambertian (Kd, no Ks) and the
    mirrors into ModPhong (Ks), as it does in the JAX package."""
    from ..io.obj import export_scene_to_obj, import_into_scene

    rs = np.random.RandomState(seed)
    scene = B.Scene()
    ground = scene.take_material(B.Lambertian(albedo=(0.25, 0.28, 0.24)))
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
    scene.take_mesh_instance(B.MeshInstance(
        B.Mesh(pos, None, uv.astype(np.float32), indices=idx), ground))

    cube = G.generate_cube(0.5)
    building_info = []
    for _ in range(n_buildings):
        bx, bz = rs.uniform(-22, 22, 2)
        bh = rs.uniform(0.8, 4.0)
        sx, sz = rs.uniform(0.5, 1.6), rs.uniform(0.5, 1.6)
        col = tuple(0.25 + 0.5 * rs.rand(3))
        mat = scene.take_material(B.ModPhong(diffuse=col, specular=tuple(0.1 + 0.2 * rs.rand(3)),
                                             shininess=float(rs.uniform(20, 160))))
        ty = float(fbm(bx, bz)) + bh / 2
        tf = Transformation.make(translation=(bx, ty, bz), scale=(sx, bh, sz))
        scene.take_mesh_instance(B.MeshInstance(cube, mat, tf))
        building_info.append((bx, ty, bz, sx, bh, sz))

    for wi in range(n_windows):
        bx, ty, bz, sx, bh, sz = building_info[wi % len(building_info)]
        warm = np.array([1.0, rs.uniform(0.5, 0.9), rs.uniform(0.2, 0.6)])
        lm = scene.take_material(B.LightDiffuse(radiance=tuple(warm * rs.uniform(2.0, 120.0))))
        side = 1.0 if wi % 2 == 0 else -1.0
        wtf = Transformation.make(
            translation=(bx + side * (sx * 0.5 + 0.01), ty + rs.uniform(-0.3, 0.3) * bh, bz),
            rotation=quat_from_axis_angle((0, 1, 0), side * np.pi / 2),
            scale=(0.18, 0.12, 1.0))
        scene.take_mesh_instance(B.MeshInstance(G.generate_quad(1.0, 1.0), lm, wtf),
                                 hot_spot=True)

    for i in range(20):
        sx_, sz_ = rs.uniform(-18, 18, 2)
        mat = (scene.take_material(B.GGX(albedo=(0.8, 0.7, 0.6),
                                         roughness=0.08 + 0.2 * rs.rand()))
               if i % 3 else scene.take_material(B.Mirror()))
        tf = Transformation.make(translation=(sx_, float(fbm(sx_, sz_)) + 1.4, sz_),
                                 scale=(0.8, 0.8, 0.8))
        scene.take_mesh_instance(B.MeshInstance(
            G.generate_sphere(1.0, slices=sphere_slices, stacks=sphere_slices), mat, tf))

    with tempfile.TemporaryDirectory(prefix="wurblpt_city_") as workdir:
        path = f"{workdir}/city_night.obj"
        export_scene_to_obj(scene, path)
        scene = B.Scene()
        import_into_scene(scene, path)

    # After the round trip (MTL cannot hold them): the RGL sphere and the sky.
    scene.take_rgl_table("city_rgl", city_rgl_fields(seed))
    scene.take_mesh_instance(B.MeshInstance(
        G.generate_sphere(1.0, slices=sphere_slices, stacks=sphere_slices),
        scene.take_material(B.RGLMaterial(table_name="city_rgl")),
        Transformation.make(translation=(0.0, float(fbm(0.0, 4.0)) + 1.6, 4.0),
                            scale=(1.2, 1.2, 1.2))))
    night = procedural_sky(sun_radiance=2.0) * 0.08
    scene.set_environment_map(EnvironmentMapEquiRect(night.astype(np.float32),
                                                     importance_resolution=32))
    return scene.build(use_bvh=True, device=device)


def city_camera(device="cuda"):
    """The city_many_lights bench viewpoint (bench.py bench_city_many_lights):
    (pose, vfov_deg); the camera is a 360-degree stereo one with eye distance
    0.065 (`utils.kernel_check.CITY_*`)."""
    return from_lookat((0.0, 3.5, 14.0), (0.0, 1.5, 0.0), device=device), 50.0


def _quad_to(translate, rotation_axis, rotation_angle, half=1.0):
    """A 2 half x 2 half quad and the pose that turns it about `rotation_axis`
    and moves it to `translate`: (Mesh, Transformation)."""
    tf = Transformation.make(translation=translate,
                             rotation=quat_from_axis_angle(rotation_axis, rotation_angle))
    return G.generate_quad(half, half), tf


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
    gm, gtf = _quad_to((0.0, -0.5, 0.0), (1.0, 0.0, 0.0), -np.pi / 2, half=20.0)
    spheres = [SphereSpec((-1.2, 0.0, 0.0), 0.5, 1), SphereSpec((0.0, 0.0, 0.0), 0.5, 2),
               SphereSpec((1.2, 0.0, 0.0), 0.5, 3)]
    sky = procedural_sky()
    env = (EnvironmentMapCube(_equirect_to_cube_faces(sky, 32), importance_resolution) if cube
           else EnvironmentMapEquiRect(sky, importance_resolution))
    return flatten_meshes([MeshSpec.of(gm, 0, transformation=gtf)], material_table(rows), device,
                          envmap=env, spheres=spheres)


def envmap_camera(device="cuda"):
    """The envmap_cube_is bench viewpoint (bench.py bench_envmap_furnace): (pose, vfov_deg)."""
    return from_lookat((0.0, 0.6, 4.0), (0.0, 0.0, 0.0), device=device), 40.0


def rtiow(seed: int = 7, n: int = 6, device="cuda", use_bvh: bool = False):
    """The rtiow path's scene (bench config rtiow_distortion at the defaults:
    40 spheres, no triangle): a radius-1000 ground sphere, an n x n grid of
    random Lambertian, GGX and glass spheres and three large ones under a
    constant sky (wurblpt-rtiow.cpp:84-133). The same arrays as
    ``wurblpt_tpu.utils.scenes.rtiow(seed, n).build(use_bvh=use_bvh)``,
    random draws in the same order. n = 22 is the reference's own field
    (Shirley's a, b in [-11, 11): 488 spheres), the rtiow_bvh path's with
    `use_bvh`."""
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
    return flatten_meshes([], material_table(rows), device, use_bvh, spheres=spheres,
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
    meshes = []
    for tr, ax, ang in (((0, 0, -h), (1, 0, 0), 0.0),               # back wall
                        ((-h, 0, 0), (0, 1, 0), np.pi / 2),          # left
                        ((h, 0, 0), (0, 1, 0), -np.pi / 2),          # right
                        ((0, -h, 0), (1, 0, 0), -np.pi / 2),         # floor
                        ((0, h, 0), (1, 0, 0), np.pi / 2)):          # ceiling
        wall, tf = _quad_to(tr, ax, ang, half=h)
        meshes.append(MeshSpec.of(wall, transformation=tf))
    meshes.append(MeshSpec.of(G.generate_cube(0.25),
                              transformation=Transformation.make(translation=(0.3, -h + 0.25,
                                                                              -0.4))))
    # generate_disk's +z normal turned by pi about y: the light shines into the room.
    tf = Transformation.make(translation=(0.0, 0.0, h - 0.01),
                             rotation=quat_from_axis_angle((0, 1, 0), np.pi))
    meshes.append(MeshSpec.of(G.generate_disk(0.02), 1, transformation=tf, hot_spot=True))
    return flatten_meshes(meshes, material_table(rows), device)


def tof_camera(device="cuda"):
    """The tof_amcw bench viewpoint (bench.py bench_tof), at the light: (pose, vfov_deg)."""
    return from_lookat((0.0, 0.0, 1.19), (0.0, 0.0, 0.0), device=device), 60.0


def sphere_lit_floor(device="cuda"):
    """An edge-free view for geometry gradients: a 100 x 100 Lambertian floor
    quad at y = 0 under a diffuse sphere light of radius 1 at (0, 6, 0),
    radiance 30 (the JAX package's tests/test_gradients.py:113-150)."""
    rows = [(MaterialType.LAMBERTIAN, (0.6, 0.5, 0.4), None),
            (MaterialType.LIGHT_DIFFUSE, (30.0, 30.0, 30.0), None)]
    fm, ftf = _quad_to((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), -np.pi / 2, half=50.0)
    floor = MeshSpec.of(fm, transformation=ftf)
    return flatten_meshes([floor], material_table(rows), device,
                          spheres=[SphereSpec((0.0, 6.0, 0.0), 1.0, 1, hot_spot=True)])


def sphere_lit_floor_camera(device="cuda"):
    """The floor's camera, 2 above it looking straight down (vfov 50)."""
    return from_lookat((0.0, 2.0, 0.01), (0.0, 0.0, 0.0), device=device), 50.0


def lit_quad(albedo=(0.3, 0.6, 0.4), device="cuda"):
    """A 3 x 3 Lambertian quad in the xy plane under a diffuse sphere light
    of radius 0.3 at (0.6, 1.0, 2.4), radiance 16: the scene whose albedo
    and camera the JAX package's tests/test_inverse.py:18-26 recover."""
    rows = [(MaterialType.LAMBERTIAN, albedo, None),
            (MaterialType.LIGHT_DIFFUSE, (16.0, 16.0, 16.0), None)]
    return flatten_meshes([MeshSpec.of(G.generate_quad(1.5, 1.5))], material_table(rows), device,
                          spheres=[SphereSpec((0.6, 1.0, 2.4), 0.3, 1, hot_spot=True)])


def lit_quad_camera(device="cuda"):
    """The quad's camera, 2.4 in front of it (vfov 45)."""
    return from_lookat((0.0, 0.0, 2.4), (0.0, 0.0, 0.0), device=device), 45.0


# ---------------------------------------------------------------------------
# The example apps' scenes, built through the port's Scene (examples/*.py)
# ---------------------------------------------------------------------------

def noise_textures(device="cuda"):
    """The noise-texture gallery (examples/noise_textures.py; reference app
    wurblpt-noise-textures.cpp): one Lambertian sphere per noise type
    (value, gradient, Worley, signed Perlin remapped to [0, 1], Perlin
    turbulence) on a 24 x 24 checkered floor, a sphere light and a constant
    sky. The same arrays as the JAX app's scene."""
    scene = B.Scene()
    floor = scene.take_material(B.Lambertian(
        albedo=B.CheckerTexture(color1=(0.25,) * 3, color2=(0.6,) * 3, squares=(24, 24))))
    fm, ftf = _quad_to((0.0, -0.5, 0.0), (1.0, 0.0, 0.0), -np.pi / 2, half=12.0)
    scene.take_mesh_instance(B.MeshInstance(fm, floor, ftf))
    kinds = [
        B.NoiseTexture(kind=TextureType.VALUE_NOISE, octaves=4, frequency=6.0),
        B.NoiseTexture(kind=TextureType.GRADIENT_NOISE, octaves=4, frequency=6.0),
        B.NoiseTexture(kind=TextureType.WORLEY_NOISE, frequency=8.0),
        B.NoiseTexture(kind=TextureType.PERLIN_NOISE, frequency=8.0, turbulence=False,
                       val_scale=(0.7, 0.7, 0.7, 1.0), val_offset=(0.5, 0.5, 0.5, 0.0)),
        B.NoiseTexture(kind=TextureType.PERLIN_NOISE, octaves=7, frequency=6.0, gain=0.5,
                       turbulence=True),
    ]
    for i, tex in enumerate(kinds):
        scene.take_sphere(B.SphereObject((-3.0 + 1.5 * i, 0.1, 0.0), 0.6,
                                         B.Lambertian(albedo=tex)))
    light = scene.take_material(B.LightDiffuse(radiance=(26.0, 24.0, 22.0)))
    scene.take_sphere(B.SphereObject((0.0, 5.0, 3.0), 0.8, light), hot_spot=True)
    scene.set_environment_map(EnvironmentMapConstant(radiance=(0.25, 0.28, 0.35)))
    return scene.build(device=device)


def noise_textures_camera(device="cuda"):
    """The noise gallery's viewpoint: (pose, vfov_deg)."""
    return from_lookat((0.0, 1.3, 5.2), (0.0, 0.0, 0.0), device=device), 32.0


def brick_normal_map(h=256, w=256, scale=2.5):
    """Tangent-space normal map of bevelled bricks [h, w, 3] in [0, 1]
    (examples/normalmap.py)."""
    ys, xs = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    bricks_y = (ys * 4.0) % 1.0
    row = np.floor(ys * 4.0).astype(int)
    bricks_x = (xs * 4.0 + np.where(row % 2 == 0, 0.0, 0.5)) % 1.0

    def roll(v, width=0.08):   # 1 inside a brick, rolling off near the mortar lines
        return np.clip(np.minimum(v, 1.0 - v) / width, 0.0, 1.0)

    hgt = np.minimum(roll(bricks_x), roll(bricks_y))
    dhx = np.roll(hgt, -1, 1) - np.roll(hgt, 1, 1)
    dhy = np.roll(hgt, -1, 0) - np.roll(hgt, 1, 0)
    n = np.stack([-scale * dhx, -scale * dhy, np.full_like(hgt, 2.0 / w)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return ((n + 1.0) * 0.5).astype(np.float32)


def normalmap(map_size: int = 256, device="cuda"):
    """The normal-mapping demo (examples/normalmap.py; reference app
    wurblpt-normalmap.cpp): a Lambertian quad with a `map_size`^2 brick
    normal map (linear texels), lit by a sphere light."""
    scene = B.Scene()
    nmap = B.ImageTexture(image=brick_normal_map(map_size, map_size), srgb=False)
    scene.take_mesh_instance(B.MeshInstance(
        G.generate_quad(1.0, 1.0), B.Lambertian(albedo=(0.7, 0.45, 0.3), normal_map=nmap)))
    light = scene.take_material(B.LightDiffuse(radiance=(20.0,) * 3))
    scene.take_sphere(B.SphereObject((1.6, 1.2, 2.2), 0.25, light), hot_spot=True)
    return scene.build(device=device)


def normalmap_camera(device="cuda"):
    """The normal-map demo's viewpoint: (pose, vfov_deg)."""
    return from_lookat((0.0, -0.4, 2.4), (0.0, 0.0, 0.0), device=device), 42.0


def synthetic_rgl_fields(seed: int = 0):
    """A small synthetic RGL dataset (examples/material_comparison.py
    `_synthetic_rgl`): P = 1, T = 4, smooth positive tables from `seed`."""
    T = 4
    return dict(
        phi_i=np.zeros((1,), np.float32),
        theta_i=np.linspace(0.0, np.pi / 2, T).astype(np.float32),
        ndf=_smooth_positive((16, 16), seed + 1),
        sigma=_smooth_positive((16, 16), seed + 2, 0.2, 0.4),
        vndf=_smooth_positive((1, T, 16, 16), seed + 3),
        luminance=_smooth_positive((1, T, 8, 8), seed + 4),
        rgb=_smooth_positive((1, T, 3, 8, 8), seed + 5),
    )


def material_comparison(device="cuda"):
    """The material grid (examples/material_comparison.py; reference apps
    wurblpt-material-comparison / -playground): one sphere per model
    (Lambertian, rough and smooth GGX, anisotropic GGX, dispersive glass,
    mirror, ModPhong, a measured RGL table) on a 32 x 32 checkered floor,
    a sphere light and a constant sky."""
    scene = B.Scene()
    floor = scene.take_material(B.Lambertian(
        albedo=B.CheckerTexture(color1=(0.3,) * 3, color2=(0.55,) * 3, squares=(32, 32))))
    fm, ftf = _quad_to((0.0, -0.5, 0.0), (1.0, 0.0, 0.0), -np.pi / 2, half=14.0)
    scene.take_mesh_instance(B.MeshInstance(fm, floor, ftf))
    scene.take_rgl_table("measured", synthetic_rgl_fields())
    mats = [
        B.Lambertian(albedo=(0.7, 0.3, 0.25)),
        B.GGX(albedo=(0.9, 0.7, 0.3), roughness=0.25),
        B.GGX(albedo=(0.9, 0.9, 0.95), roughness=0.03),
        B.GGX(albedo=(0.8, 0.8, 0.9), roughness=(0.02, 0.3)),   # anisotropic
        B.Glass(ior=(1.50, 1.52, 1.54, 1.52)),                   # dispersive
        B.Mirror(),
        B.ModPhong(diffuse=(0.2, 0.35, 0.6), specular=(0.4,) * 3, shininess=90.0),
        B.RGLMaterial(table_name="measured"),
    ]
    for i, m in enumerate(mats):
        scene.take_sphere(B.SphereObject((-5.25 + 1.5 * i, 0.1, 0.0), 0.6, m))
    light = scene.take_material(B.LightDiffuse(radiance=(30.0,) * 3))
    scene.take_sphere(B.SphereObject((0.0, 6.0, 4.0), 1.0, light), hot_spot=True)
    scene.set_environment_map(EnvironmentMapConstant(radiance=(0.35, 0.4, 0.5)))
    return scene.build(device=device)


def material_comparison_camera(device="cuda"):
    """The material grid's viewpoint: (pose, vfov_deg)."""
    return from_lookat((0.0, 1.6, 9.0), (0.0, 0.0, 0.0), device=device), 16.0


# ---------------------------------------------------------------------------
# Motion blur, animated cameras and depth of field (examples/rolling_marbles.py,
# examples/animations.py, examples/rtiow.py)
# ---------------------------------------------------------------------------

def rolling_marbles(frames: int = 4, fps: float = 24.0, device="cuda"):
    """The rolling-marbles video's scene (examples/rolling_marbles.py; reference
    app wurblpt-rolling-marbles): five Perlin-turbulence textured spheres
    of radius 0.3 rolling across a checkered floor, each a keyframe
    animation from x = -3 to 3 (alternate rows the other way) with the
    rotation about z that rolls it, over the video's duration frames /
    fps, under a sphere light; built over [0, duration]. The same arrays as
    the JAX app's scene. A frame f renders over the 180-degree shutter
    [f / fps, f / fps + 1 / (2 fps)]."""
    duration = frames / fps
    scene = B.Scene()
    floor = scene.take_material(B.Lambertian(
        albedo=B.CheckerTexture(color1=(0.5, 0.45, 0.4), color2=(0.25, 0.25, 0.3),
                                squares=(20, 20))))
    fm, ftf = _quad_to((0, -0.5, 0), (1, 0, 0), -np.pi / 2, half=8.0)
    scene.take_mesh_instance(B.MeshInstance(fm, floor, ftf))
    light = scene.take_material(B.LightDiffuse(radiance=(18.0,) * 3))
    scene.take_sphere(B.SphereObject((0, 4.0, 2.0), 0.6, light), hot_spot=True)
    rng = np.random.default_rng(5)
    for i in range(5):
        r = 0.3
        z = -1.2 + 0.6 * i
        x0, x1 = -3.0, 3.0
        sign = 1.0 if i % 2 == 0 else -1.0
        roll = sign * (x1 - x0) / r
        aid = scene.take_animation(AnimationKeyframes(
            times=[0.0, duration],
            transformations=[
                Transformation.make(translation=(x0 * sign, -0.5 + r, z)),
                Transformation.make(translation=(x1 * sign, -0.5 + r, z),
                                    rotation=quat_from_axis_angle((0, 0, 1), -roll))]))
        tex = B.NoiseTexture(kind=TextureType.PERLIN_NOISE, frequency=8.0, octaves=5,
                             turbulence=True, seed=i,
                             val_scale=tuple(0.6 * rng.random(3) + 0.2) + (1.0,))
        scene.take_sphere(B.SphereObject((0.0, 0.0, 0.0), r, B.Lambertian(albedo=tex),
                                         animation=aid))
    return scene.build(t0=0.0, t1=duration, device=device)


def rolling_marbles_camera(device="cuda"):
    """The rolling-marbles viewpoint: (pose, vfov_deg)."""
    return from_lookat((0, 1.8, 5.5), (0, 0, 0), device=device), 38.0


def animations(t0: float = 0.0, t1: float = 0.02, fps: float = 25.0, frames: int = 4,
               device="cuda"):
    """The keyframe-animation video's scene (examples/animations.py; reference
    app wurblpt-animations): a red Lambertian sphere keyframed from x = -1.5
    to 1.5 over the video's duration frames / fps, on a grey floor under a
    sphere light; built over the frame's shutter [t0, t1] (frame 0 of the
    app at its half shutter: [0, 0.5 / 25]). The same arrays as the JAX
    app's scene."""
    duration = frames / fps
    scene = B.Scene()
    floor = scene.take_material(B.Lambertian(albedo=(0.45, 0.45, 0.45)))
    fm, ftf = _quad_to((0, -0.5, 0), (1, 0, 0), -np.pi / 2, half=8.0)
    scene.take_mesh_instance(B.MeshInstance(fm, floor, ftf))
    light = scene.take_material(B.LightDiffuse(radiance=(10.0,) * 3))
    scene.take_sphere(B.SphereObject((0, 2.5, 0), 0.5, light), hot_spot=True)
    aid = scene.take_animation(AnimationKeyframes(
        times=[0.0, duration],
        transformations=[Transformation.make(translation=(-1.5, 0.0, 0.0)),
                         Transformation.make(translation=(1.5, 0.0, 0.0))]))
    red = scene.take_material(B.Lambertian(albedo=(0.8, 0.2, 0.15)))
    scene.take_sphere(B.SphereObject((0, 0, 0), 0.5, red, animation=aid))
    return scene.build(t0=t0, t1=t1, device=device)


def animations_camera(device="cuda"):
    """The keyframe-animation viewpoint: (pose, vfov_deg)."""
    return from_lookat((0, 1.0, 4.0), (0, 0, 0), device=device), 40.0


def participating_media(density: float = 1.5, device="cuda"):
    """examples/participating_media.py's scene (reference app
    wurblpt-participating-media.cpp): a floor quad, a sphere hot spot, a red
    sphere and a fog sphere of density `density` with an isotropic phase
    function (albedo 0.9), the boundary's own material 0 as the app gives it."""
    scene = B.Scene()
    floor = scene.take_material(B.Lambertian(albedo=(0.4, 0.4, 0.45)))
    fm, ftf = _quad_to((0, -1.0, 0), (1, 0, 0), -np.pi / 2, half=10.0)
    scene.take_mesh_instance(B.MeshInstance(fm, floor, ftf))
    light = scene.take_material(B.LightDiffuse(radiance=(14.0, 12.0, 10.0)))
    scene.take_sphere(B.SphereObject((0.0, 1.6, -2.0), 0.35, light), hot_spot=True)
    red = scene.take_material(B.Lambertian(albedo=(0.7, 0.2, 0.2)))
    scene.take_sphere(B.SphereObject((-0.8, -0.6, -0.4), 0.4, red))
    scene.take_medium(B.MediumObject(boundary=B.SphereObject((0.4, 0.0, -0.8), 1.0, 0),
                                     density=density, phase=B.PhaseIso(albedo=(0.9, 0.9, 0.9))))
    return scene.build(device=device)


def participating_media_camera(device="cuda"):
    """The participating-media demo's viewpoint: (pose, vfov_deg)."""
    return from_lookat((0, 0.4, 3.2), (0, 0, -0.8), device=device), 45.0


def bumpy_normal_map(size: int = 256, base: int = 16, scale: float = 1.0,
                     seed: int = 31415926):
    """examples/stagelights.py's tangent-space normal map, baked on the host
    from smooth value noise (the port's copy of the app's function)."""
    rng = np.random.default_rng(seed)
    coarse = rng.random((base, base)).astype(np.float32)
    ys = np.linspace(0, base, size, endpoint=False)
    xs = np.linspace(0, base, size, endpoint=False)
    y0 = np.floor(ys).astype(int) % base
    x0 = np.floor(xs).astype(int) % base
    fy = (ys - np.floor(ys))[:, None]
    fx = (xs - np.floor(xs))[None, :]
    sy = fy * fy * (3 - 2 * fy)
    sx = fx * fx * (3 - 2 * fx)
    c00 = coarse[np.ix_(y0, x0)]
    c01 = coarse[np.ix_(y0, (x0 + 1) % base)]
    c10 = coarse[np.ix_((y0 + 1) % base, x0)]
    c11 = coarse[np.ix_((y0 + 1) % base, (x0 + 1) % base)]
    h = (c00 * (1 - sx) + c01 * sx) * (1 - sy) + (c10 * (1 - sx) + c11 * sx) * sy
    dhx = np.roll(h, -1, 1) - np.roll(h, 1, 1)
    dhy = np.roll(h, -1, 0) - np.roll(h, 1, 0)
    n = np.stack([-scale * dhx, -scale * dhy, np.full_like(h, 2.0 / size * base)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return ((n + 1.0) * 0.5).astype(np.float32)


STAGE_SPOT_COLORS = ((73.0, 118.0, 139.0), (243.0, 108.0, 100.0), (191.0, 197.0, 85.0),
                     (165.0, 69.0, 179.0))


def stagelights(device="cuda"):
    """examples/stagelights.py's scene (reference app wurblpt-stagelights.cpp:
    30-204): a closed room of six quads, a ModPhong torus, fog (density 2.5)
    inside an octahedron that a glass shell of the same octahedron bounds, a
    glass sphere with the baked bumpy normal map, an anisotropic GGX
    icosahedron and four coloured spot lights (quads, hot spots)."""
    scene = B.Scene()
    white = scene.take_material(B.Lambertian(albedo=(0.8, 0.8, 0.8)))

    def wall(translate, axis, deg):
        tf = Transformation.make(translation=translate,
                                 rotation=quat_from_axis_angle(np.asarray(axis, np.float32),
                                                               np.deg2rad(deg)),
                                 scale=(5.0, 5.0, 5.0))
        scene.take_mesh_instance(B.MeshInstance(G.generate_quad(1.0, 1.0), white, tf))

    wall((-2.6, 0.0, 0.0), (0, 1, 0), +90)
    wall((+2.6, 0.0, 0.0), (0, 1, 0), -90)
    wall((0.0, 0.0, +5.0), (0, 1, 0), 180)
    wall((0.0, 0.0, -4.6), (0, 1, 0), 0)
    wall((0.0, -2.499, 0.0), (1, 0, 0), +90)
    wall((0.0, -5.0, 0.0), (1, 0, 0), -90)
    modphong = B.ModPhong(diffuse=(0.5, 0.5, 0.5), specular=(0.5, 0.5, 0.5), shininess=120.0)
    tra0 = Transformation.make(translation=(-1.5, -4.7, -4.0),
                               rotation=quat_from_axis_angle((0, 1, 0), np.deg2rad(30.0)),
                               scale=(0.3,) * 3)
    scene.take_mesh_instance(B.MeshInstance(G.generate_torus(1.0, 0.4, 64, 48), modphong, tra0))
    tra1 = Transformation.make(translation=(-0.5, -4.7, -4.0),
                               rotation=quat_from_axis_angle((0, 1, 0), np.deg2rad(160.0)),
                               scale=(0.3,) * 3)
    scene.take_mesh_instance(B.MeshInstance(G.generate_octahedron(), B.Glass(ior=1.5), tra1))
    scene.take_medium(B.MediumObject(boundary=B.MeshInstance(G.generate_octahedron(), 0, tra1),
                                     density=2.5, phase=B.PhaseIso(albedo=(1.0, 1.0, 1.0))))
    nmap = B.ImageTexture(image=bumpy_normal_map(), srgb=False)
    scene.take_sphere(B.SphereObject((0.5, -4.7, -4.0), 0.3, B.Glass(ior=1.5, normal_map=nmap)))
    ggx = B.GGX(albedo=(1.0, 1.0, 1.0), roughness=(0.01, 0.1))
    tra3 = Transformation.make(translation=(1.5, -4.7, -4.0), scale=(0.3,) * 3)
    scene.take_mesh_instance(B.MeshInstance(G.generate_icosahedron(), ggx, tra3))
    lrot = quat_from_axis_angle((1, 0, 0), np.deg2rad(90.0))
    for i, col in enumerate(STAGE_SPOT_COLORS):
        lm = scene.take_material(B.LightSpot(radiance=col, half_angle=np.deg2rad(20.0)))
        lt = Transformation.make(translation=(-1.5 + i, -2.5, -4.0), rotation=lrot,
                                 scale=(0.3,) * 3)
        scene.take_mesh_instance(B.MeshInstance(G.generate_quad(1.0, 1.0), lm, lt),
                                 hot_spot=True)
    return scene.build(device=device)


def stagelights_camera(device="cuda"):
    """The stage-lights demo's viewpoint: (pose, vfov_deg)."""
    return Transformation.make(translation=(0.0, -4.5, -1.2)).to(device), 50.0


def rtiow_dof_camera(width: int, height: int, aperture: float = 0.08,
                     focus_distance: float = 10.0, device="cuda"):
    """examples/rtiow.py's camera over `rtiow()`: (CameraParams, CameraConfig)
    looking from (13, 2, 3) at the origin, 25 degrees vertical, with the
    thin lens of diameter `aperture` focused at `focus_distance` (depth of
    field where aperture > 0)."""
    from ..render.camera import CameraConfig, make_camera

    pose = from_lookat((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), device=device)
    cam = make_camera(pose, 25.0, width, height, focus_distance=focus_distance,
                      aperture_diameter=aperture, device=device)
    return cam, CameraConfig(dof=aperture > 0.0)
