"""Flatten a scene into :class:`SceneArrays` (the jax-free port of
``wurblpt_tpu/scene/flatten.py``).

Everything is computed with numpy exactly as the JAX package's flattener does
it, so a scene built here equals the JAX build field by field, bits included.
Two entry points share one lowering:

* `flatten_scene` flattens a builder :class:`~wurblpt_tpu_torch.scene.builder.Scene`
  (what `Scene.build` calls): its materials through `flatten_materials`
  (textures into one :class:`TextureCollector`), its instances and spheres
  as :class:`MeshSpec` and :class:`SphereSpec`, its animations, environment
  map and RGL tables, into `flatten_meshes`;
* `flatten_meshes` takes mesh and sphere specs and a numpy material table,
  e.g. `material_table`'s of (type, colour, parameter) rows, which the bench
  builders of :mod:`wurblpt_tpu_torch.utils.scenes` use.

Covered: indexed meshes with or without texcoords, normals and tangents
(missing normals are computed, and tangents wherever there are texcoords),
static instance transforms baked into world space; analytic spheres; every
material of the builder; constant, checker, image
and noise textures with the float16 image stack; hot-spot triangles and
spheres, the power-proportional or uniform light pick and the per-prim
pick and 1 / area rows of per-light MIS; the port's BVH, an equirect, cube
or constant environment map and the RGL tables; keyframe animations (the
instance pose stays baked into the vertices and the keyframes apply on top
at ray time); participating media (`flatten_media`: sphere and mesh
boundaries, density, phase function).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core import color as colorlib
from ..core.color import vec4
from ..core.transform import Transformation
from . import builder as B
from .builder import AnimationKeyframes, Glass, ModPhong  # noqa: F401  (material_table's rows)
from .geometryproc import compute_normals, compute_tangents
from .ir import (
    AnimTable,
    MaterialFlags,
    MaterialTable,
    MaterialType,
    MediumArrays,
    SceneArrays,
    Spheres,
    TextureTable,
    TextureType,
    Triangles,
    medium_arrays,
)

_f32 = np.float32
_i32 = np.int32


class MeshSpec(NamedTuple):
    positions: np.ndarray            # [V, 3] object space
    normals: Optional[np.ndarray]    # [V, 3]; None: area-weighted smooth normals
    texcoords: Optional[np.ndarray]  # [V, 2]; None: no texcoords
    indices: np.ndarray              # [F, 3]
    material: int = 0
    hot_spot: bool = False
    transformation: Optional[Transformation] = None   # static pose, baked at flatten
    anim: int = 0                    # animation id: 0 static, k the (k-1)-th of `animations`
    tangents: Optional[np.ndarray] = None   # [V, 3]; None: from the uv gradients, if texcoords

    @staticmethod
    def of(mesh: "B.Mesh", material: int = 0, **kw) -> "MeshSpec":
        """The spec of a builder Mesh with material row `material` (and any
        other MeshSpec field by keyword)."""
        return MeshSpec(mesh.positions, mesh.normals, mesh.texcoords, mesh.indices, material,
                        tangents=mesh.tangents, **kw)


class SphereSpec(NamedTuple):
    center: tuple                    # object space
    radius: float
    material: int
    transformation: Optional[Transformation] = None   # static pose, baked at flatten
    anim: int = 0                    # animation id, as MeshSpec.anim
    hot_spot: bool = False           # sampled by NEE as a light


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
            trans[i, j], rot[i, j], scale[i, j] = (_np32(x) for x in tf)
        trans[i, k:] = trans[i, k - 1]     # the last key held, so clamping works
        rot[i, k:] = rot[i, k - 1]
        scale[i, k:] = scale[i, k - 1]
    return AnimTable(*(torch.as_tensor(x, device=device) for x in (times, trans, rot, scale,
                                                                   nkeys)))


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, _f32)


def bake_transform(tf: Optional[Transformation], pos, nrm, tan):
    """Object-space positions, normals and tangents (each may be None) to
    world space (scale, rotate, translate; normals by the inverse scale), in
    float32 numpy."""
    if tf is None:
        return pos, nrm, tan
    t, q, s = (_np32(x) for x in tf)

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
    is 4 pi r^2 (flatten.py _light_power_weights, light_spot.hpp:32-75). A
    textured emitter (emissive constant 1) weighs by its area alone. Ids
    from the triangle count on are spheres."""
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


# ---------------------------------------------------------------------------
# Textures and materials (flatten.py:38-257)
# ---------------------------------------------------------------------------

class TextureCollector:
    """Texture descriptors in the order the materials name them, and the
    image stack (flatten.py `_TextureCollector`)."""

    def __init__(self):
        self.descs: List[B.Texture] = []
        self.images: List[np.ndarray] = []

    def add(self, tex) -> int:
        if tex is None:
            return -1
        if not isinstance(tex, B.Texture):
            raise TypeError(f"not a texture: {tex!r}")
        self.descs.append(tex)
        return len(self.descs) - 1

    def add_image(self, img: np.ndarray, srgb: bool) -> int:
        """An image as linear RGB + NIR float16 texels (uint8 sRGB-decoded
        unless `srgb` is False; grey, grey + alpha, RGB and RGBA inputs)."""
        img = np.asarray(img)
        if img.dtype == np.uint8:
            imgf = img.astype(_f32) / 255.0
            if srgb:
                imgf = colorlib.srgb_to_rgb(imgf)
        else:
            imgf = img.astype(_f32)
        if imgf.ndim == 2:
            imgf = imgf[..., None]
        c = imgf.shape[-1]
        if c == 1:
            imgf = np.concatenate([imgf] * 3 + [np.mean(imgf, -1, keepdims=True)], -1)
        elif c == 2:     # grey + alpha: grey replicated, alpha in the NIR slot
            imgf = np.concatenate([imgf[..., :1]] * 3 + [imgf[..., 1:2]], -1)
        elif c == 3:
            imgf = np.concatenate([imgf, np.mean(imgf, -1, keepdims=True)], -1)
        self.images.append(imgf.astype(np.float16))
        return len(self.images) - 1

    def build(self, device) -> TextureTable:
        nt = len(self.descs)
        typ = np.zeros((nt,), _i32)
        params = np.zeros((nt, 8), _f32)
        uv_scale = np.ones((nt, 2), _f32)
        uv_offset = np.zeros((nt, 2), _f32)
        val_scale = np.ones((nt, 4), _f32)
        val_offset = np.zeros((nt, 4), _f32)
        image_id = np.full((nt,), -1, _i32)
        for i, t in enumerate(self.descs):
            uv_scale[i], uv_offset[i] = t.uv_scale, t.uv_offset
            val_scale[i], val_offset[i] = t.val_scale, t.val_offset
            if isinstance(t, B.ConstantTexture):
                typ[i] = TextureType.CONSTANT
                params[i, 0:4] = vec4(t.color)
            elif isinstance(t, B.CheckerTexture):
                typ[i] = TextureType.CHECKER
                params[i, 0:4] = vec4(t.color1)
                params[i, 4:8] = vec4(t.color2)
                uv_scale[i] = (t.squares[0], t.squares[1])
            elif isinstance(t, B.ImageTexture):
                typ[i] = TextureType.IMAGE
                image_id[i] = self.add_image(t.image, t.srgb)
                params[i, 0] = 1.0 if t.linear_filtering else 0.0
            elif isinstance(t, B.NoiseTexture):
                typ[i] = t.kind
                params[i, 0:5] = (float(t.octaves), t.frequency, t.gain, float(t.seed),
                                  1.0 if t.turbulence else 0.0)
            else:
                raise TypeError(f"unknown texture type {t!r}")
        if self.images:
            hmax = max(im.shape[0] for im in self.images)
            wmax = max(im.shape[1] for im in self.images)
            stack = np.zeros((len(self.images), hmax, wmax, 4), np.float16)
            hw = np.zeros((len(self.images), 2), _i32)
            for i, im in enumerate(self.images):
                stack[i, :im.shape[0], :im.shape[1]] = im
                hw[i] = im.shape[:2]
        else:
            stack = np.zeros((0, 1, 1, 4), np.float16)
            hw = np.zeros((0, 2), _i32)
        return TextureTable(*(torch.as_tensor(x, device=device) for x in (
            typ, params, uv_scale, uv_offset, val_scale, val_offset, image_id, stack, hw)))


def _tex_or_color(val, textures: TextureCollector, default=(0.0, 0.0, 0.0)):
    """(constant RGB + NIR, texture id): a texture's constant is 1, its id its row."""
    if val is None:
        return vec4(default), -1
    if isinstance(val, B.Texture):
        return np.ones(4, _f32), textures.add(val)
    return vec4(val), -1


def flatten_materials(materials, textures: TextureCollector, rgl_names) -> MaterialTable:
    """numpy MaterialTable of builder materials, their textures added to
    `textures` in the JAX flattener's order (flatten.py `_flatten_materials`);
    `rgl_names` maps an RGLMaterial's table name (or index) to its row of
    the RGL stack. A scene without materials gets one row of type NONE."""
    m = max(len(materials), 1)
    typ = np.zeros((m,), _i32)
    flags = np.zeros((m,), _i32)
    albedo, emissive, p0, p1, p2 = (np.zeros((m, 4), _f32) for _ in range(5))
    albedo_tex, emissive_tex, normal_tex, opacity_tex, spec_tex, rgl_id = (
        np.full((m,), -1, _i32) for _ in range(6))
    for i, mat in enumerate(materials):
        if mat.two_sided:
            flags[i] |= MaterialFlags.TWO_SIDED
        if mat.normal_map is not None:
            normal_tex[i] = textures.add(mat.normal_map)
        if isinstance(mat, B.Lambertian):
            typ[i] = MaterialType.LAMBERTIAN
            albedo[i], albedo_tex[i] = _tex_or_color(mat.albedo, textures)
        elif isinstance(mat, B.GGX):
            typ[i] = MaterialType.GGX
            albedo[i], albedo_tex[i] = _tex_or_color(mat.albedo, textures)
            r = (mat.roughness, mat.roughness) if np.isscalar(mat.roughness) else mat.roughness
            p0[i, 0:2] = np.maximum(np.asarray(r, _f32), 1e-4)
        elif isinstance(mat, B.Glass):
            # p0 = per-channel IOR (a scalar repeated, RGB padded with B),
            # p1 = absorption (RGB + NIR 0), albedo 1
            typ[i] = MaterialType.GLASS
            ior = np.asarray(mat.ior, _f32).reshape(-1)
            p0[i] = (np.repeat(ior, 4) if ior.size == 1
                     else np.concatenate([ior, ior[-1:]]) if ior.size == 3 else ior)
            ab = np.asarray(mat.absorption, _f32)
            p1[i] = ab if ab.size == 4 else vec4(ab, nir=0.0)
            albedo[i] = 1.0
        elif isinstance(mat, B.Mirror):
            typ[i] = MaterialType.MIRROR
            albedo[i], albedo_tex[i] = _tex_or_color(mat.color, textures, default=(1, 1, 1))
        elif isinstance(mat, B.ModPhong):
            # p0 = (shininess, opacity, specular-lobe probability, ior),
            # p1 = ks (map_Ks: its texture, sampled at shade time), p2 =
            # transmissive; a textured opacity (map_d) keeps p0.y = 1.
            typ[i] = MaterialType.MODPHONG
            albedo[i], albedo_tex[i] = _tex_or_color(mat.diffuse, textures)
            p1[i], spec_tex[i] = _tex_or_color(mat.specular, textures)
            p0[i, 0] = mat.shininess
            if isinstance(mat.opacity, B.Texture):
                opacity_tex[i] = textures.add(mat.opacity)
                p0[i, 1] = 1.0
            else:
                p0[i, 1] = float(mat.opacity)
            p0[i, 3] = max(float(mat.ior), 1.0)
            p2[i] = vec4(mat.transmissive)
            kd, ks = float(np.max(albedo[i][:3])), float(np.max(p1[i][:3]))
            p0[i, 2] = ks / (kd + ks) if (kd + ks) > 0 else 0.0
            emissive[i], emissive_tex[i] = _tex_or_color(mat.emissive, textures)
        elif isinstance(mat, B.PhaseIso):
            typ[i] = MaterialType.PHASE_ISO
            albedo[i], albedo_tex[i] = _tex_or_color(mat.albedo, textures, default=(1, 1, 1))
        elif isinstance(mat, B.LightDiffuse):
            typ[i] = MaterialType.LIGHT_DIFFUSE
            emissive[i], emissive_tex[i] = _tex_or_color(mat.radiance, textures)
        elif isinstance(mat, B.LightSpot):
            typ[i] = MaterialType.LIGHT_SPOT
            emissive[i], emissive_tex[i] = _tex_or_color(mat.radiance, textures)
            p0[i, 0] = np.cos(mat.half_angle)
        elif isinstance(mat, B.LightTof):
            # NIR only (light_tof.hpp:37-89); flagged as the ToF light.
            typ[i] = MaterialType.LIGHT_TOF
            flags[i] |= MaterialFlags.TOF_LIGHT
            emissive[i] = (0.0, 0.0, 0.0, mat.radiance_w)
            p0[i, 0] = np.cos(mat.half_angle)
        elif isinstance(mat, B.RGLMaterial):
            typ[i] = MaterialType.RGL
            rgl_id[i] = rgl_names.get(mat.table_name, -1)
        else:
            raise TypeError(f"unknown material {mat!r}")
    return MaterialTable(typ=typ, flags=flags, albedo=albedo, emissive=emissive, p0=p0, p1=p1,
                         p2=p2, rgl_id=rgl_id, albedo_tex=albedo_tex, emissive_tex=emissive_tex,
                         normal_tex=normal_tex, opacity_tex=opacity_tex, spec_tex=spec_tex)


def _row_material(row) -> B.Material:
    """The builder material of a `material_table` row."""
    t, c, param = row
    if t == MaterialType.LAMBERTIAN:
        return B.Lambertian(albedo=c)
    if t == MaterialType.GGX:
        return B.GGX(albedo=c, roughness=param)
    if t == MaterialType.MIRROR:
        return B.Mirror(color=(1, 1, 1) if c is None else c)
    if t == MaterialType.GLASS:
        return param
    if t == MaterialType.MODPHONG:
        return B.ModPhong(diffuse=c, specular=param.specular, shininess=param.shininess,
                          opacity=param.opacity, emissive=param.emissive, ior=param.ior,
                          transmissive=param.transmissive)
    if t == MaterialType.RGL:
        return B.RGLMaterial(table_name=param)
    if t == MaterialType.LIGHT_DIFFUSE:
        return B.LightDiffuse(radiance=c)
    if t == MaterialType.LIGHT_SPOT:
        return B.LightSpot(radiance=c, half_angle=param)
    if t == MaterialType.LIGHT_TOF:
        return B.LightTof(radiance_w=c, half_angle=param)
    raise NotImplementedError(f"material type {t} is outside the ported slice")


def material_table(rows) -> MaterialTable:
    """numpy MaterialTable from [(MaterialType, colour, parameter), ...]
    (constant colours only), through `flatten_materials`.

    The colour is the albedo of LAMBERTIAN, the F0 of GGX, the tint of MIRROR
    (None: white), the diffuse colour of MODPHONG, the radiance of
    LIGHT_DIFFUSE and LIGHT_SPOT and the radiant power W (a scalar) of
    LIGHT_TOF. The parameter is GGX's roughness (a scalar or (x, y)),
    GLASS's builder :class:`Glass`, MODPHONG's builder :class:`ModPhong`
    (all but its diffuse colour), RGL's table index and the cone's half
    angle (radians) of LIGHT_SPOT and LIGHT_TOF; None otherwise."""
    mats = [_row_material(r) for r in rows]
    rgl = {r[2]: r[2] for r in rows if r[0] == MaterialType.RGL}
    return flatten_materials(mats, TextureCollector(), rgl)


# ---------------------------------------------------------------------------
# Meshes, spheres, lights, acceleration (flatten.py:444-718)
# ---------------------------------------------------------------------------

def flatten_meshes(meshes: List[MeshSpec], materials: MaterialTable, device, use_bvh=None,
                   envmap=None, rgl_tables=None, spheres=(), animations=(), t0: float = 0.0,
                   t1: float = 0.0, textures: Optional[TextureCollector] = None,
                   light_sampling: str = "power",
                   media: Optional[MediumArrays] = None) -> SceneArrays:
    """Meshes and spheres + a numpy material table -> SceneArrays on `device`.

    `textures` holds the texture descriptors the table's texture ids name
    (None: none). `light_sampling` "power" attaches the power-proportional
    light pick with its alias table, "uniform" keeps the reference's
    uniform pick. `use_bvh` builds the port's BVH
    (:func:`wurblpt_tpu_torch.accel.build.build_bvh`) over the triangles and
    spheres; None builds it for 512 primitives or more, the JAX flattener's
    rule (flatten.py:625-626); an animated primitive's box is swept over the
    render interval [t0, t1]. `envmap` is an ``EnvironmentMap{EquiRect,Cube,Constant}``
    of :mod:`wurblpt_tpu_torch.render.envmap`; `rgl_tables` the table dicts of
    the RGL materials, in `rgl_id` order. `spheres` are :class:`SphereSpec`,
    flattened as flatten.py:550-576 does (centre by scale, rotation,
    translation; radius by the mean scale); sphere j has prim id T + j.
    `animations` are builder :class:`AnimationKeyframes`, animation ids 1,
    2, ... in order; a mesh or sphere names its own by `anim`. `media`
    (`flatten_media`) go into the scene as they are."""
    if light_sampling not in ("power", "uniform"):
        raise ValueError(f"light_sampling must be 'power' or 'uniform', got {light_sampling!r}")
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
        tan = mesh.tangents
        if tan is None and has_uv:
            tan = compute_tangents(pos, nrm, uv, f)
        has_tan = tan is not None
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
        # bit 0: texcoords, bit 1: tangents
        cols["flags"].append(np.full((len(f),), int(has_uv) | 2 * int(has_tan), _i32))
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
            t, q, scale = (_np32(x) for x in sph.transformation)
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
        if light_sampling == "power":
            powers = light_power_weights(light_ids, arr["e1"], arr["e2"], arr["mat"],
                                         np.asarray(materials.typ),
                                         np.asarray(materials.emissive), np.asarray(materials.p0),
                                         np.asarray(radii, _f32), sph_mat)
            prob, alias, w = build_alias_table(powers)
            picks = dict(light_weights=dev(w), light_alias_prob=dev(prob),
                         light_alias_idx=dev(alias))
        else:
            w = np.full((light_ids.size,), 1.0 / light_ids.size, _f32)
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
        materials=MaterialTable(*(None if x is None else dev(np.asarray(x)) for x in materials)),
        light_prims=dev(light_ids),
        textures=(textures or TextureCollector()).build(device),
        anims=anims,
        media=media,
        bvh=bvh,
        envmap=env,
        rgl=rgl,
        **picks,
    )


def flatten_media(scene: "B.Scene", device) -> Optional[MediumArrays]:
    """The scene's media as MediumArrays (flatten.py:578-615), None without
    one: a sphere boundary takes its transformation's translation and its
    largest scale, a mesh boundary its triangles baked to world space; the
    phase function is resolved through the material table."""
    if not scene._media:
        return None
    tri, sph = ([], [], [], []), ([], [], [])
    density, phase = [], []
    for mi, med in enumerate(scene._media):
        density.append(float(med.density))
        phase.append(scene._resolve_material(med.phase))
        b = med.boundary
        if isinstance(b, B.SphereObject):
            center, radius = np.asarray(b.center, _f32), float(b.radius)
            if b.transformation is not None:
                t, _, scale = (_np32(x) for x in b.transformation)
                center = center + t
                radius *= float(np.max(scale))
            for col, x in zip(sph, (center, radius, mi)):
                col.append(x)
        else:
            pos, _, _ = bake_transform(b.transformation, b.mesh.positions, None, None)
            f = b.mesh.indices
            v0, v1, v2 = pos[f[:, 0]], pos[f[:, 1]], pos[f[:, 2]]
            for col, x in zip(tri, (v0, v1 - v0, v2 - v0, np.full((len(f),), mi, _i32))):
                col.append(x)
    cat = lambda xs, shape, dt: np.concatenate(xs) if xs else np.zeros(shape, dt)  # noqa: E731
    return medium_arrays(*(cat(x, (0, 3), _f32) for x in tri[:3]), cat(tri[3], (0,), _i32),
                         np.asarray(sph[0], _f32).reshape(-1, 3),
                         np.asarray(sph[1], _f32).reshape(-1), np.asarray(sph[2], _i32),
                         np.asarray(density, _f32), np.asarray(phase, _i32), device)


def flatten_scene(scene: "B.Scene", max_image_dim: int = 2048, use_bvh=None, t0: float = 0.0,
                  t1: float = 0.0, light_sampling: str = "power", device="cuda") -> SceneArrays:
    """A builder Scene as SceneArrays on `device` (flatten.py `flatten_scene`):
    materials resolved (inline ones registered first, as the JAX flattener
    does), flattened with their textures, the instances and spheres as specs
    through `flatten_meshes`, the media through `flatten_media`."""
    rgl_names = {name: i for i, name in enumerate(scene._rgl_tables)}
    inst_mats = [scene._resolve_material(inst.material) for inst, _ in scene._instances]
    sph_mats = [scene._resolve_material(s.material) for s, _ in scene._spheres]
    for med in scene._media:   # an inline phase function joins the table first
        scene._resolve_material(med.phase)
    textures = TextureCollector()
    materials = flatten_materials(scene._materials, textures, rgl_names)
    meshes = [MeshSpec.of(inst.mesh, m, hot_spot=hot, transformation=inst.transformation,
                          anim=inst.animation or 0)
              for (inst, hot), m in zip(scene._instances, inst_mats)]
    spheres = [SphereSpec(s.center, s.radius, m, s.transformation, s.animation or 0, hot)
               for (s, hot), m in zip(scene._spheres, sph_mats)]
    return flatten_meshes(meshes, materials, device, use_bvh, envmap=scene._envmap,
                          rgl_tables=list(scene._rgl_tables.values()), spheres=spheres,
                          animations=scene._animations[1:], t0=t0, t1=t1, textures=textures,
                          light_sampling=light_sampling, media=flatten_media(scene, device))
