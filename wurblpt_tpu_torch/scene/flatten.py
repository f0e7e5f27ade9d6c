"""Flatten static triangle meshes into :class:`SceneArrays` (a jax-free subset
of ``wurblpt_tpu/scene/flatten.py`` and ``scene/geometryproc.py``).

Everything is computed with numpy exactly as the JAX package's flattener does
it, so a scene built here equals the JAX build field by field, bits included.
Covered: indexed meshes with or without texcoords and per-vertex normals
(missing normals are computed, and tangents wherever there are texcoords),
static instance transforms baked into world space; analytic spheres, hot
spots among them; scenes of spheres alone; constant Lambertian, GGX, mirror, glass,
ModPhong, RGL, diffuse-, spot- and ToF-light materials; hot-spot triangles and spheres, the
power-proportional light pick with its alias table and the per-prim pick and
1 / area rows of per-light MIS; the port's BVH, an equirect, cube or
constant environment map and the RGL tables; keyframe animations (the
tables of flatten.py `_flatten_animations` and each primitive's animation id:
the instance pose stays baked into the vertices and the keyframes apply on
top at ray time).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core.transform import Transformation
from .ir import (
    AnimTable,
    MaterialFlags,
    MaterialTable,
    MaterialType,
    SceneArrays,
    Spheres,
    Triangles,
)

_f32 = np.float32
_i32 = np.int32


class MeshSpec(NamedTuple):
    positions: np.ndarray            # [V, 3] object space
    normals: Optional[np.ndarray]    # [V, 3]; None: area-weighted smooth normals
    texcoords: Optional[np.ndarray]  # [V, 2]; None: no texcoords, no tangents
    indices: np.ndarray              # [F, 3]
    material: int
    hot_spot: bool = False
    transformation: Optional[Transformation] = None   # static pose, baked at flatten
    anim: int = 0                    # animation id: 0 static, k the (k-1)-th of `animations`


class SphereSpec(NamedTuple):
    center: tuple                    # object space
    radius: float
    material: int
    transformation: Optional[Transformation] = None   # static pose, baked at flatten
    anim: int = 0                    # animation id, as MeshSpec.anim
    hot_spot: bool = False           # sampled by NEE as a light


class AnimationKeyframes(NamedTuple):
    """Sorted (time, Transformation) keyframes (builder.AnimationKeyframes,
    animation_keyframes.hpp:51-216)."""

    times: tuple
    transformations: tuple


def flatten_animations(animations, device) -> Optional[AnimTable]:
    """The AnimTable of row 0 (the static identity) and `animations` (rows
    1..), padded to the largest key count (flatten.py `_flatten_animations`);
    None for a scene without animation."""
    if not animations:
        return None
    anims = [None] + list(animations)
    n, kmax = len(anims), max(len(a.times) for a in animations)
    times = np.full((n, kmax), np.inf, _f32)
    trans = np.zeros((n, kmax, 3), _f32)
    rot = np.zeros((n, kmax, 4), _f32)
    rot[..., 3] = 1.0
    scale = np.ones((n, kmax, 3), _f32)
    nkeys = np.ones((n,), _i32)
    times[:, 0] = 0.0
    for i, a in enumerate(anims[1:], 1):
        k = len(a.times)
        nkeys[i] = k
        times[i, :k] = np.asarray(a.times, _f32)
        for j, tf in enumerate(a.transformations):
            trans[i, j], rot[i, j], scale[i, j] = (np.asarray(x.detach().cpu().numpy(), _f32)
                                                   for x in tf)
        trans[i, k:] = trans[i, k - 1]     # the last key held, so clamping works
        rot[i, k:] = rot[i, k - 1]
        scale[i, k:] = scale[i, k - 1]
    return AnimTable(*(torch.as_tensor(x, device=device) for x in (times, trans, rot, scale,
                                                                   nkeys)))


def vec4(c) -> np.ndarray:
    """A color as RGB + NIR, NIR = mean(RGB) (builder._vec4)."""
    c = np.asarray(c, _f32).reshape(-1)
    if c.size == 4:
        return c
    if c.size == 1:
        c = np.repeat(c, 3)
    return np.array([c[0], c[1], c[2], float(np.mean(c[:3]))], _f32)


def compute_normals(positions, indices) -> np.ndarray:
    """Area-weighted smooth vertex normals (geometryproc.hpp:58)."""
    positions = np.asarray(positions, _f32)
    indices = np.asarray(indices, np.int64)
    v0, v1, v2 = (positions[indices[:, k]] for k in range(3))
    fn = np.cross(v1 - v0, v2 - v0)  # length = 2 * area: area weighting for free
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, indices[:, k], fn)
    ln = np.linalg.norm(normals, axis=-1, keepdims=True)
    normals = np.where(ln > 1e-20, normals / np.maximum(ln, 1e-20), np.array([0.0, 0.0, 1.0], _f32))
    return normals.astype(_f32)


def compute_tangents(positions, normals, texcoords, indices) -> np.ndarray:
    """Per-vertex tangents from uv gradients (geometryproc.hpp:181)."""
    positions = np.asarray(positions, _f32)
    texcoords = np.asarray(texcoords, _f32)
    indices = np.asarray(indices, np.int64)
    v0, v1, v2 = (positions[indices[:, k]] for k in range(3))
    w0, w1, w2 = (texcoords[indices[:, k]] for k in range(3))
    e1, e2 = v1 - v0, v2 - v0
    x1, x2 = w1 - w0, w2 - w0
    det = x1[:, 0] * x2[:, 1] - x2[:, 0] * x1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(np.abs(det) == 0, 1.0, det), 0.0)
    tan = (e1 * x2[:, 1:2] - e2 * x1[:, 1:2]) * r[:, None]
    tangents = np.zeros_like(positions)
    for k in range(3):
        np.add.at(tangents, indices[:, k], tan)
    normals = np.asarray(normals, _f32)
    tangents -= normals * np.sum(tangents * normals, axis=-1, keepdims=True)
    ln = np.linalg.norm(tangents, axis=-1, keepdims=True)
    alt = np.cross(normals, np.where(np.abs(normals[:, 0:1]) < 0.9,
                                     np.array([1.0, 0, 0], _f32), np.array([0, 1.0, 0], _f32)))
    alt /= np.maximum(np.linalg.norm(alt, axis=-1, keepdims=True), 1e-20)
    tangents = np.where(ln > 1e-8, tangents / np.maximum(ln, 1e-20), alt)
    return tangents.astype(_f32)


def bake_transform(tf: Optional[Transformation], pos, nrm, tan):
    """Object-space positions, normals and tangents (each may be None) to
    world space (scale, rotate, translate; normals by the inverse scale), in
    float32 numpy."""
    if tf is None:
        return pos, nrm, tan
    t, q, s = (np.asarray(x.detach().cpu().numpy(), _f32) for x in tf)

    def rot(v):
        u, w = q[:3], q[3]
        tq = 2.0 * np.cross(u, v)
        return v + w * tq + np.cross(u, tq)

    pos = rot(pos * s) + t
    if nrm is not None:
        nn = rot(nrm / s)
        nrm = nn / np.maximum(np.linalg.norm(nn, axis=-1, keepdims=True), 1e-20)
    if tan is not None:
        tn = rot(tan * s)
        tan = tn / np.maximum(np.linalg.norm(tn, axis=-1, keepdims=True), 1e-20)
    return pos, nrm, tan


def build_alias_table(weights: np.ndarray):
    """Vose alias table (O(L)); returns (prob, alias, normalized weights)."""
    w = np.asarray(weights, np.float64)
    L = w.shape[0]
    total = w.sum()
    if not np.isfinite(total) or total <= 0.0:
        w = np.ones((L,), np.float64)
        total = float(L)
    w = w / total
    scaled = w * L
    prob = np.ones((L,), np.float64)
    alias = np.arange(L, dtype=np.int64)
    small = [i for i in range(L) if scaled[i] < 1.0]
    large = [i for i in range(L) if scaled[i] >= 1.0]
    scaled = scaled.copy()
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    for i in large + small:
        prob[i] = 1.0
    return prob.astype(_f32), alias.astype(_i32), w.astype(_f32)


def light_power_weights(light_ids, tri_e1, tri_e2, tri_mat, mat_typ, mat_emissive, mat_p0,
                        sph_r=None, sph_mat=None):
    """Emitted power of each hot spot: area x luminance x cone fraction. A
    spot or ToF light emits only inside its cone, so its power scales with
    the cone's solid-angle share 0.5 (1 - cos half angle); a sphere's area
    is 4 pi r^2 (flatten.py _light_power_weights, light_spot.hpp:32-75).
    Ids from the triangle count on are spheres."""
    ids = np.asarray(light_ids, np.int64)
    n_tri = len(tri_mat)
    is_tri = ids < n_tri
    area = np.empty(ids.shape, np.float64)
    mat = np.empty(ids.shape, np.int64)
    ti = ids[is_tri]
    area[is_tri] = 0.5 * np.linalg.norm(np.cross(tri_e1[ti], tri_e2[ti]), axis=-1)
    mat[is_tri] = tri_mat[ti]
    if np.any(~is_tri):
        si = ids[~is_tri] - n_tri
        area[~is_tri] = 4.0 * np.pi * np.asarray(sph_r)[si] ** 2
        mat[~is_tri] = np.asarray(sph_mat)[si]
    lum = np.maximum(mat_emissive[mat, :3].max(axis=-1), mat_emissive[mat, 3])
    is_cone = (mat_typ[mat] == MaterialType.LIGHT_SPOT) | (mat_typ[mat] == MaterialType.LIGHT_TOF)
    cone_frac = np.where(is_cone, 0.5 * (1.0 - mat_p0[mat, 0]), 1.0)
    return area * lum * np.maximum(cone_frac, 0.0)


def flatten_meshes(meshes: List[MeshSpec], materials: MaterialTable, device, use_bvh=None,
                   envmap=None, rgl_tables=None, spheres=(), animations=(), t0: float = 0.0,
                   t1: float = 0.0) -> SceneArrays:
    """Static triangle meshes and spheres + a material table -> SceneArrays on `device`.

    `materials` holds numpy arrays; the light pick is power-proportional, as
    ``flatten_scene(light_sampling="power")`` builds it. `use_bvh` builds the
    port's BVH (:func:`wurblpt_tpu_torch.accel.build.build_bvh`) over the
    triangles and spheres; None builds it for 512 primitives or more, the JAX
    flattener's rule (flatten.py:625-626); an animated primitive's box is
    swept over the render interval [t0, t1]. `envmap` is an
    ``EnvironmentMap{EquiRect,Cube,Constant}`` of :mod:`wurblpt_tpu_torch.render.envmap`;
    `rgl_tables` the table dicts of the RGL materials, in `rgl_id` order.
    `spheres` are :class:`SphereSpec`, flattened as flatten.py:550-576 does
    (centre by scale, rotation, translation; radius by the mean scale);
    sphere j has prim id T + j. `animations` are :class:`AnimationKeyframes`,
    animation ids 1, 2, ... in order; a mesh or sphere names its own by `anim`."""
    cols = {k: [] for k in ("p0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                            "tan0", "tan1", "tan2", "mat", "flags", "v1", "v2", "anim")}
    light_prims = []
    n = 0
    for mesh in meshes:
        pos = np.asarray(mesh.positions, _f32)
        f = np.asarray(mesh.indices, _i32)
        nrm = compute_normals(pos, f) if mesh.normals is None else np.asarray(mesh.normals, _f32)
        has_uv = mesh.texcoords is not None
        uv = np.asarray(mesh.texcoords, _f32) if has_uv else np.zeros((len(pos), 2), _f32)
        tan = compute_tangents(pos, nrm, uv, f) if has_uv else None
        pos, nrm, tan = bake_transform(mesh.transformation, pos, nrm, tan)
        if tan is None:
            tan = np.zeros_like(pos)
        v0, v1, v2 = pos[f[:, 0]], pos[f[:, 1]], pos[f[:, 2]]
        cols["p0"].append(v0)
        cols["v1"].append(v1)
        cols["v2"].append(v2)
        cols["e1"].append(v1 - v0)
        cols["e2"].append(v2 - v0)
        for k in range(3):
            cols[f"n{k}"].append(nrm[f[:, k]])
            cols[f"uv{k}"].append(uv[f[:, k]])
            cols[f"tan{k}"].append(tan[f[:, k]])
        cols["mat"].append(np.full((len(f),), mesh.material, _i32))
        cols["flags"].append(np.full((len(f),), 3 if has_uv else 0, _i32))  # texcoords, tangents
        cols["anim"].append(np.full((len(f),), mesh.anim, _i32))
        if mesh.hot_spot:
            light_prims.extend(range(n, n + len(f)))
        n += len(f)
    ints = ("mat", "flags", "anim")
    empty = {"mat": (0,), "flags": (0,), "anim": (0,), "uv0": (0, 2), "uv1": (0, 2),
             "uv2": (0, 2)}
    arr = {k: (np.concatenate(v) if v else np.zeros(empty.get(k, (0, 3)),
                                                     _i32 if k in ints else _f32))
           for k, v in cols.items()}
    arr = {k: (v if k in ints else v.astype(_f32)) for k, v in arr.items()}

    def dev(x):
        return torch.as_tensor(x, device=device)

    centers, radii = [], []
    for sph in spheres:
        center, radius = np.asarray(sph.center, _f32), float(sph.radius)
        if sph.transformation is not None:
            t, q, scale = (np.asarray(x.detach().cpu().numpy(), _f32) for x in sph.transformation)
            center = center * scale
            tq = 2.0 * np.cross(q[:3], center)
            center = center + q[3] * tq + np.cross(q[:3], tq) + t
            radius *= float(np.mean(scale))
        if sph.hot_spot:
            light_prims.append(n + len(centers))
        centers.append(center)
        radii.append(radius)
    light_ids = np.asarray(sorted(set(light_prims)), _i32)
    sph_mat = np.asarray([s.material for s in spheres], _i32)
    prim_anim = np.concatenate([arr["anim"], np.asarray([s.anim for s in spheres], _i32)])
    picks = {}
    if light_ids.size:
        powers = light_power_weights(light_ids, arr["e1"], arr["e2"], arr["mat"],
                                     np.asarray(materials.typ), np.asarray(materials.emissive),
                                     np.asarray(materials.p0), np.asarray(radii, _f32), sph_mat)
        prob, alias, w = build_alias_table(powers)
        picks = dict(light_weights=dev(w), light_alias_prob=dev(prob), light_alias_idx=dev(alias))
        # Per prim, spheres included: pick probability and 1 / area (zero for
        # non-lights and for sphere lights, whose pdf is their cone's), for
        # per-light MIS; only for static lights, whose areas are the
        # flattener's.
        if not np.any(prim_anim[light_ids] != 0):
            pick = np.zeros((n + len(radii),), _f32)
            inv_area = np.zeros((n + len(radii),), _f32)
            pick[light_ids] = w
            tri_lights = light_ids[light_ids < n]
            area = 0.5 * np.linalg.norm(np.cross(arr["e1"][tri_lights], arr["e2"][tri_lights]),
                                        axis=-1)
            inv_area[tri_lights] = 1.0 / np.maximum(area, 1e-20)
            picks.update(prim_light_pick=dev(pick), prim_inv_area=dev(inv_area))

    tris = Triangles(**{k: dev(v) for k, v in arr.items()})
    sph = Spheres(dev(np.asarray(centers, _f32).reshape(-1, 3)), dev(np.asarray(radii, _f32)),
                  dev(sph_mat),
                  dev(np.asarray([s.anim for s in spheres], _i32)))
    anims = flatten_animations(animations, device)
    if use_bvh is None:
        use_bvh = n + len(radii) >= 512
    bvh = None
    if use_bvh and n + len(radii) > 0:
        from ..accel.build import build_bvh

        bvh = build_bvh(tris, sph, anims, t0, t1)
    env = None
    if envmap is not None:
        from ..render.envmap import build_envmap_arrays

        env = build_envmap_arrays(envmap, device)
    rgl = None
    if rgl_tables:
        from ..materials.rgl import stack_rgl_tables

        rgl = stack_rgl_tables(rgl_tables, device)
    return SceneArrays(
        tris=tris,
        spheres=sph,
        materials=MaterialTable(*(dev(np.asarray(x)) for x in materials)),
        light_prims=dev(light_ids),
        anims=anims,
        bvh=bvh,
        envmap=env,
        rgl=rgl,
        **picks,
    )


def material_table(rows) -> MaterialTable:
    """numpy MaterialTable from [(MaterialType, colour, parameter), ...].

    The colour is the albedo of LAMBERTIAN, the F0 of GGX, the tint of MIRROR
    (None: white), the diffuse colour of MODPHONG, the radiance of
    LIGHT_DIFFUSE and LIGHT_SPOT and the radiant power W (a scalar) of
    LIGHT_TOF. The parameter is GGX's roughness (a scalar or (x, y)),
    GLASS's :class:`Glass`, MODPHONG's :class:`ModPhong`, RGL's table index
    and the cone's half angle (radians) of LIGHT_SPOT and LIGHT_TOF; None
    otherwise."""
    m = len(rows)
    typ = np.array([r[0] for r in rows], _i32)
    albedo, emissive, p0, p1, p2 = (np.zeros((m, 4), _f32) for _ in range(5))
    flags = np.zeros((m,), _i32)
    rgl_id = np.full((m,), -1, _i32)
    for i, (t, c, param) in enumerate(rows):
        if t == MaterialType.LAMBERTIAN:
            albedo[i] = vec4(c)
        elif t == MaterialType.GGX:
            albedo[i] = vec4(c)
            r = (param, param) if np.isscalar(param) else param
            p0[i, 0:2] = np.maximum(np.asarray(r, _f32), 1e-4)
        elif t == MaterialType.MIRROR:
            albedo[i] = vec4((1, 1, 1) if c is None else c)
        elif t == MaterialType.GLASS:
            # p0 = per-channel IOR (a scalar repeated, RGB padded with B),
            # p1 = absorption (RGB + NIR 0), albedo 1 (flatten.py:182-191).
            ior = np.asarray(param.ior, _f32).reshape(-1)
            p0[i] = (np.repeat(ior, 4) if ior.size == 1
                     else np.concatenate([ior, ior[-1:]]) if ior.size == 3 else ior)
            ab = np.asarray(param.absorption, _f32).reshape(-1)
            p1[i] = ab if ab.size == 4 else np.append(vec4(ab)[:3], _f32(0.0))
            albedo[i] = 1.0
        elif t == MaterialType.MODPHONG:
            # p0 = (shininess, opacity, specular-lobe probability, ior),
            # p1 = ks, p2 = transmissive (flatten.py _flatten_materials).
            albedo[i] = vec4(c)
            p1[i] = vec4(param.specular)
            kd, ks = float(np.max(albedo[i][:3])), float(np.max(p1[i][:3]))
            p0[i] = (param.shininess, float(param.opacity), ks / (kd + ks) if kd + ks > 0 else 0.0,
                     max(float(param.ior), 1.0))
            p2[i] = vec4(param.transmissive)
            emissive[i] = vec4(param.emissive)
        elif t == MaterialType.RGL:
            rgl_id[i] = param
        elif t == MaterialType.LIGHT_DIFFUSE:
            emissive[i] = vec4(c)
        elif t == MaterialType.LIGHT_SPOT:
            emissive[i] = vec4(c)
            p0[i, 0] = np.cos(param)
        elif t == MaterialType.LIGHT_TOF:
            # NIR only (light_tof.hpp:37-89); flagged as the ToF light.
            flags[i] |= MaterialFlags.TOF_LIGHT
            emissive[i] = (0.0, 0.0, 0.0, c)
            p0[i, 0] = np.cos(param)
        else:
            raise NotImplementedError(f"material type {t} is outside the ported slice")
    return MaterialTable(typ=typ, flags=flags, albedo=albedo,
                         emissive=emissive, p0=p0, p1=p1, p2=p2, rgl_id=rgl_id)


class Glass(NamedTuple):
    """The glass parameters of a material_table row (builder.Glass)."""

    ior: object = 1.5                        # a scalar, RGB, or RGB + NIR
    absorption: tuple = (0.0, 0.0, 0.0, 0.0)


class ModPhong(NamedTuple):
    """The ModPhong parameters of a material_table row (builder.ModPhong,
    constant colours only)."""

    specular: tuple = (0.0, 0.0, 0.0)
    shininess: float = 0.0
    opacity: float = 1.0
    emissive: tuple = (0.0, 0.0, 0.0)
    ior: float = 1.0
    transmissive: tuple = (0.0, 0.0, 0.0)
