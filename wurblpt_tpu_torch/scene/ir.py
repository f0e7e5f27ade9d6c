"""Scene intermediate representation: structure-of-arrays tensors.

Port of ``wurblpt_tpu/scene/ir.py``, holding the fields the ported slice
reads. Integer columns stay int32 tensors (the JAX package float-encodes some
of them to dodge TPU gather costs; nothing here needs that). The keyframe
tables (`AnimTable`), each primitive's animation id, the texture table
(`TextureTable`, its float16 image stack as the JAX package keeps it) and the
materials' texture ids come across whole, and so do the media
(`MediumArrays`: their boundaries, densities and phase materials).
The BVH is the port's own layout (:mod:`wurblpt_tpu_torch.accel.build`), not
the JAX package's W-wide rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..materials.rgl import RGLTables, rgl_tables_from_numpy


class MaterialType:
    NONE = 0
    LAMBERTIAN = 1
    GGX = 2
    GLASS = 3
    MIRROR = 4
    MODPHONG = 5
    PHASE_ISO = 6
    LIGHT_DIFFUSE = 7
    LIGHT_SPOT = 8
    LIGHT_TOF = 9
    RGL = 10
    COUNT = 11


class MaterialFlags:
    TWO_SIDED = 1 << 0
    TOF_LIGHT = 1 << 1


class TextureType:
    CONSTANT = 0
    CHECKER = 1
    IMAGE = 2
    VALUE_NOISE = 3
    GRADIENT_NOISE = 4
    WORLEY_NOISE = 5
    PERLIN_NOISE = 6


class Triangles(NamedTuple):
    """One record per triangle: world space, with any static instance pose
    baked in; an animated triangle's keyframes apply on top at ray time."""

    p0: torch.Tensor        # [T, 3] vertex 0
    e1: torch.Tensor        # [T, 3] v1 - v0
    e2: torch.Tensor        # [T, 3] v2 - v0
    n0: torch.Tensor        # [T, 3] shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor       # [T, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    tan0: torch.Tensor      # [T, 3] shading tangents (zeros if absent)
    tan1: torch.Tensor
    tan2: torch.Tensor
    mat: torch.Tensor       # [T] int32 material index
    flags: torch.Tensor     # [T] int32: bit0 has_texcoords, bit1 has_tangents
    # Absolute vertices for the watertight test: shared vertices must be
    # bit-identical across neighbours, which p0 + e1 (rounded) is not.
    v1: torch.Tensor        # [T, 3]
    v2: torch.Tensor        # [T, 3]
    anim: Optional[torch.Tensor] = None   # [T] int32 animation id (0: static; None: all 0)

    @property
    def count(self):
        return self.p0.shape[0]


class Spheres(NamedTuple):
    center: torch.Tensor    # [S, 3]
    radius: torch.Tensor    # [S]
    mat: torch.Tensor       # [S] int32
    anim: Optional[torch.Tensor] = None   # [S] int32 animation id (0: static; None: all 0)

    @property
    def count(self):
        return self.center.shape[0]


class MaterialTable(NamedTuple):
    """Per-material parameters; `typ` selects the BSDF model per lane."""

    typ: torch.Tensor       # [M] int32 MaterialType
    flags: torch.Tensor     # [M] int32 MaterialFlags
    albedo: torch.Tensor    # [M, 4] RGB + NIR
    emissive: torch.Tensor  # [M, 4]
    p0: torch.Tensor        # [M, 4] type-specific parameters (ModPhong: shininess,
                            #   opacity, specular-lobe probability, ior)
    p1: torch.Tensor        # [M, 4] (ModPhong: specular colour ks)
    p2: torch.Tensor        # [M, 4] (ModPhong: transmissive colour)
    rgl_id: torch.Tensor    # [M] int32 row of SceneArrays.rgl (-1: not RGL)
    # Texture ids, rows of SceneArrays.textures (-1: none; None: no column)
    albedo_tex: Optional[torch.Tensor] = None    # [M] int32 (ModPhong: its diffuse)
    emissive_tex: Optional[torch.Tensor] = None  # [M] int32
    normal_tex: Optional[torch.Tensor] = None    # [M] int32 tangent-space normal map
    opacity_tex: Optional[torch.Tensor] = None   # [M] int32 ModPhong opacity (.r, map_d)
    spec_tex: Optional[torch.Tensor] = None      # [M] int32 ModPhong specular (map_Ks)

    @property
    def count(self):
        return self.typ.shape[0]

    @property
    def tex_ids(self):
        """The five texture-id columns in the order `render.bsdf.pack_texture_ids` packs them."""
        return (self.albedo_tex, self.emissive_tex, self.normal_tex, self.opacity_tex,
                self.spec_tex)


class TextureTable(NamedTuple):
    """Flattened texture descriptors + one padded image stack
    (ir.TextureTable): per-texture type, parameters and uv / value affines,
    the image stack's texels as float16 (widened to float32 at lookup),
    padded to the largest image, and each image's own (h, w)."""

    typ: torch.Tensor         # [NT] int32 TextureType
    params: torch.Tensor      # [NT, 8] f32 (CONSTANT colour; CHECKER colours; noise settings)
    uv_scale: torch.Tensor    # [NT, 2]
    uv_offset: torch.Tensor   # [NT, 2]
    val_scale: torch.Tensor   # [NT, 4]
    val_offset: torch.Tensor  # [NT, 4]
    image_id: torch.Tensor    # [NT] int32 (-1: none)
    img_data: torch.Tensor    # [NI, H, W, 4] float16 linear texels
    img_hw: torch.Tensor      # [NI, 2] int32 each image's (h, w)

    @property
    def count(self):
        return self.typ.shape[0]


def anim_ids(prims) -> torch.Tensor:
    """[count] int32 animation ids of a Triangles or Spheres table (zeros
    where it carries none)."""
    if prims.anim is not None:
        return prims.anim
    return torch.zeros((prims.count,), dtype=torch.int32, device=prims[0].device)


class AnimTable(NamedTuple):
    """Keyframed TRS animation tables (ir.AnimTable, animation_keyframes.hpp:51-216).

    Row 0 is the static identity. Keyframe arrays are padded to the largest
    key count: `times` with +inf, the poses with the last key."""

    times: torch.Tensor   # [A, K] f32, sorted, padded +inf
    trans: torch.Tensor   # [A, K, 3]
    rot: torch.Tensor     # [A, K, 4] quaternions
    scale: torch.Tensor   # [A, K, 3]
    nkeys: torch.Tensor   # [A] int32

    @property
    def count(self):
        return self.times.shape[0]


class BVHArrays(NamedTuple):
    """Binary BVH in the layout of the K5/K6 kernels (accel/build.py).

    Node row, 16 floats = 4 x float4: child 0 box (min xyz, max xyz), child 1
    box, then the two child links as int32 bit patterns and two pad words.
    A link >= 0 is an inner node; -1 is an empty child; any other negative
    link is a leaf, ``-1 - link = start * 16 + count``: rows
    [start, start + count) of `prim_v`. Node 0 is the root. Leaf row, 12
    floats = 48 bytes = 3 x float4, in the global prim order's ids (a prim
    id >= `n_tris` is a sphere): a triangle's v0 xyz, the prim id (int32
    bits), v1 xyz, the animation id (int32 bits), v2 xyz, 0 (absolute
    vertices); a sphere's centre xyz, the prim id, the radius, 0, 0, the
    animation id, then 0 x 4. An animated primitive's row holds its
    object-space geometry and its child box the world box swept over the
    build interval; a static triangle scene's rows have zero pads."""

    nodes: torch.Tensor     # [M, 16] f32 (links bit-cast)
    prim_v: torch.Tensor    # [P, 12] f32, in leaf order (prim and animation ids bit-cast)
    depth: int              # inner nodes on the longest root-to-leaf path
    n_tris: int             # prim ids below it are triangles, the others spheres
    n_spheres: int
    n_anims: int            # 1 + the largest animation id of a row (1: a static tree)

    @property
    def links(self):
        """[M, 2] int32 child links."""
        return self.nodes.view(torch.int32)[:, 12:14]

    @property
    def prim_id(self):
        """[P] int32 global prim id of each leaf row."""
        return self.prim_v.view(torch.int32)[:, 3]

    @property
    def anim_id(self):
        """[P] int32 animation id of each leaf row (0: static)."""
        return self.prim_v.view(torch.int32)[:, 7]


class EnvMapArrays(NamedTuple):
    """Environment map raster + importance tables (ir.EnvMapArrays).

    `kind`: 1 equirect, 2 cube, 3 constant (a scene without a map has
    none). The importance tables live on the R x R equal-area grid; the
    constant map has none."""

    kind: int
    image: torch.Tensor       # equirect [H, W, 4] f32; cube [6, F, F, 4]; constant [1, 1, 4]
    pdf_table: torch.Tensor   # [R, R] f32 solid-angle pdf per cell (R = 0: none)
    alias_prob: torch.Tensor  # [R * R] f32
    alias_idx: torch.Tensor   # [R * R] int32
    rotation: torch.Tensor    # [4] f32 quaternion world-from-map
    const_radiance: torch.Tensor  # [4] f32 radiance of the constant map (zeros otherwise)

    @property
    def importance(self) -> bool:
        return self.alias_prob.shape[0] > 0

    def to(self, device) -> "EnvMapArrays":
        return EnvMapArrays(self.kind, *(x.to(device).contiguous() for x in self[1:]))


class MediumArrays(NamedTuple):
    """Homogeneous participating media (ir.MediumArrays,
    hitable_medium.hpp:38-99, medium.hpp:37-57).

    The boundaries live outside the solid primitives: a medium never
    occludes for certain; each traced segment samples a free path against
    its density (render/media.py). The boundary rows are ordered by medium,
    the JAX package's order kept within a medium, so medium m's triangles
    are rows [tri_off[m], tri_off[m + 1]) and its spheres rows
    [sph_off[m], sph_off[m + 1])."""

    tri_p0: torch.Tensor      # [MT, 3]
    tri_e1: torch.Tensor      # [MT, 3]
    tri_e2: torch.Tensor      # [MT, 3]
    tri_med: torch.Tensor     # [MT] int32 medium id
    sph_center: torch.Tensor  # [MS, 3]
    sph_radius: torch.Tensor  # [MS]
    sph_med: torch.Tensor     # [MS] int32 medium id
    density: torch.Tensor     # [M] f32 (rho; mean free path 1 / rho)
    phase_mat: torch.Tensor   # [M] int32 material id of the phase function
    tri_off: torch.Tensor     # [M + 1] int32 row offsets of each medium's triangles
    sph_off: torch.Tensor     # [M + 1] int32 row offsets of each medium's spheres

    @property
    def count(self):
        return self.density.shape[0]


def medium_arrays(tri_p0, tri_e1, tri_e2, tri_med, sph_center, sph_radius, sph_med, density,
                  phase_mat, device) -> MediumArrays:
    """MediumArrays on `device` from numpy-like columns: the boundary rows
    stably sorted by medium id, and each medium's row offsets."""
    n_med = int(np.shape(density)[0])
    cols = {}
    for kind, med, rows in (("tri", tri_med, (tri_p0, tri_e1, tri_e2)),
                            ("sph", sph_med, (sph_center, sph_radius))):
        med = np.asarray(med, np.int32).reshape(-1)
        order = np.argsort(med, kind="stable")
        cols[kind] = [np.asarray(r, np.float32)[order] for r in rows] + [med[order]]
        cols[kind + "_off"] = np.searchsorted(med[order], np.arange(n_med + 1), "left")
    (p0, e1, e2, tm), (sc, sr, sm) = cols["tri"], cols["sph"]
    return MediumArrays(
        tri_p0=_f32(p0.reshape(-1, 3), device), tri_e1=_f32(e1.reshape(-1, 3), device),
        tri_e2=_f32(e2.reshape(-1, 3), device), tri_med=_i32(tm, device),
        sph_center=_f32(sc.reshape(-1, 3), device), sph_radius=_f32(sr.reshape(-1), device),
        sph_med=_i32(sm, device), density=_f32(np.reshape(density, (-1,)), device),
        phase_mat=_i32(np.reshape(phase_mat, (-1,)), device),
        tri_off=_i32(cols["tri_off"], device), sph_off=_i32(cols["sph_off"], device))


class SceneArrays(NamedTuple):
    """Everything the render kernels read, on one device."""

    tris: Triangles
    spheres: Spheres
    materials: MaterialTable
    light_prims: torch.Tensor                  # [L] int32 global prim ids (tri i, sphere T + j)
    light_weights: Optional[torch.Tensor] = None     # [L] f32 pick probabilities
    light_alias_prob: Optional[torch.Tensor] = None  # [L] f32
    light_alias_idx: Optional[torch.Tensor] = None   # [L] int32
    textures: Optional[TextureTable] = None    # None or empty: no texture
    anims: Optional[AnimTable] = None          # keyframe tables (None: static scene)
    media: Optional[MediumArrays] = None       # participating media (None: none)
    bvh: Optional[BVHArrays] = None
    envmap: Optional[EnvMapArrays] = None
    rgl: Optional[RGLTables] = None                 # measured materials (None: no RGL)
    # Per-prim pick probability and 1 / area for the per-light MIS weight
    # (render/lights.lights_pdf_at_hit); zero for prims that are not lights.
    prim_light_pick: Optional[torch.Tensor] = None  # [P] f32
    prim_inv_area: Optional[torch.Tensor] = None    # [P] f32

    @property
    def has_bvh(self) -> bool:
        return self.bvh is not None

    @property
    def env_kind(self) -> int:
        return 0 if self.envmap is None else self.envmap.kind

    @property
    def n_media(self) -> int:
        return 0 if self.media is None else self.media.count

    @property
    def n_textures(self) -> int:
        return 0 if self.textures is None else self.textures.count

    @property
    def n_anims(self) -> int:
        """Animation table rows; row 0 is the static identity."""
        return 1 if self.anims is None else self.anims.count

    @property
    def n_tris(self):
        return self.tris.count

    @property
    def n_spheres(self):
        return self.spheres.count

    @property
    def n_lights(self):
        return self.light_prims.shape[0]

    @property
    def device(self):
        return self.tris.p0.device


def _f32(x, device):
    return torch.as_tensor(np.array(x, np.float32), device=device)


def _i32(x, device):
    return torch.as_tensor(np.array(x, np.int32), device=device)


def scene_from_numpy(a, device, t0: float = 0.0, t1: float = 0.0) -> SceneArrays:
    """The JAX package's flattened scene, with numpy leaves, as a SceneArrays on `device`.

    `a` is ``wurblpt_tpu.scene.ir.SceneArrays`` after
    ``jax.tree_util.tree_map(np.asarray, ...)``; it is read by attribute only.
    Where the JAX scene has a BVH, the port builds its own from the triangles
    and spheres with their animation ids, the animated ones boxed over the
    JAX build's interval [t0, t1] (the JAX tree keeps no per-prim box to
    copy). The keyframe tables come across where the scene has an animation
    beyond row 0.
    The RGL tables come across where a material is RGL (the JAX scene always
    carries a placeholder table); the texture table and the materials'
    texture ids always, and the media where the scene has one.
    """
    t, s, m = a.tris, a.spheres, a.materials
    tris = Triangles(*(_f32(getattr(t, f), device) for f in Triangles._fields[:12]),
                     mat=_i32(t.mat, device), flags=_i32(t.flags, device),
                     v1=_f32(t.v1, device), v2=_f32(t.v2, device), anim=_i32(t.anim, device))
    spheres = Spheres(_f32(np.reshape(s.center, (-1, 3)), device),
                      _f32(np.reshape(s.radius, (-1,)), device), _i32(s.mat, device),
                      _i32(np.reshape(s.anim, (-1,)), device))
    an = a.anims
    anims = None
    if int(np.shape(an.times)[0]) > 1:
        anims = AnimTable(_f32(an.times, device), _f32(an.trans, device), _f32(an.rot, device),
                          _f32(an.scale, device), _i32(an.nkeys, device))
    opt = lambda x, conv: None if x is None else conv(x, device)  # noqa: E731
    materials = MaterialTable(_i32(m.typ, device), _i32(m.flags, device),
                              _f32(m.albedo, device), _f32(m.emissive, device),
                              _f32(m.p0, device), _f32(m.p1, device), _f32(m.p2, device),
                              _i32(m.rgl_id, device), *(opt(getattr(m, k), _i32) for k in (
                                  "albedo_tex", "emissive_tex", "normal_tex", "opacity_tex",
                                  "spec_tex")))
    tt = a.textures
    textures = TextureTable(*(
        torch.as_tensor(np.array(getattr(tt, k), np.float16), device=device) if k == "img_data"
        else _i32(getattr(tt, k), device) if k in ("typ", "image_id", "img_hw")
        else _f32(getattr(tt, k), device) for k in TextureTable._fields))
    e = a.envmap
    envmap = None
    if int(np.asarray(e.kind)) != 0:
        envmap = EnvMapArrays(int(np.asarray(e.kind)), _f32(e.image, device),
                              _f32(e.pdf_table, device), _f32(e.alias_prob, device),
                              _i32(e.alias_idx, device), _f32(e.rotation, device),
                              _f32(e.const_radiance, device))
    bvh = None
    if a.bvh is not None:
        from ..accel.build import build_bvh

        bvh = build_bvh(tris, spheres, anims, t0, t1)
    return SceneArrays(
        tris=tris, spheres=spheres, materials=materials,
        light_prims=_i32(a.light_prims, device),
        light_weights=opt(a.light_weights, _f32),
        light_alias_prob=opt(a.light_alias_prob, _f32),
        light_alias_idx=opt(a.light_alias_idx, _i32),
        textures=textures,
        anims=anims,
        media=(medium_arrays(*(getattr(a.media, f) for f in MediumArrays._fields[:9]), device)
               if int(np.shape(a.media.density)[0]) else None),
        bvh=bvh,
        envmap=envmap,
        rgl=(rgl_tables_from_numpy(a.rgl, device)
             if bool(np.any(np.asarray(m.typ) == MaterialType.RGL)) else None),
        prim_light_pick=opt(a.prim_light_pick, _f32),
        prim_inv_area=opt(a.prim_inv_area, _f32),
    )
