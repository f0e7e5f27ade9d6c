"""Scene intermediate representation: structure-of-arrays tensors.

Port of ``wurblpt_tpu/scene/ir.py``, holding the fields the ported slice
reads. Integer columns stay int32 tensors (the JAX package float-encodes some
of them to dodge TPU gather costs; nothing here needs that). The keyframe
tables (`AnimTable`) and each primitive's animation id come across whole.
Features outside the slice are recorded only by their size (`n_textures`,
`n_media`), so that :class:`wurblpt_tpu_torch.render.bsdf.SceneStatic` can
refuse such a scene. The BVH is the port's own layout
(:mod:`wurblpt_tpu_torch.accel.build`), not the JAX package's W-wide rows.
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
    [start, start + count) of `tri_v`. Node 0 is the root. Leaf triangle
    row, 12 floats = 48 bytes = 3 x float4: v0 xyz, the prim id (int32
    bits), v1 xyz, 0, v2 xyz, 0 (absolute vertices)."""

    nodes: torch.Tensor     # [M, 16] f32 (links bit-cast)
    tri_v: torch.Tensor     # [T, 12] f32, in leaf order (prim ids bit-cast)
    depth: int              # inner nodes on the longest root-to-leaf path

    @property
    def links(self):
        """[M, 2] int32 child links."""
        return self.nodes.view(torch.int32)[:, 12:14]

    @property
    def tri_id(self):
        """[T] int32 global prim id of each leaf row."""
        return self.tri_v.view(torch.int32)[:, 3]


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


class SceneArrays(NamedTuple):
    """Everything the render kernels read, on one device."""

    tris: Triangles
    spheres: Spheres
    materials: MaterialTable
    light_prims: torch.Tensor                  # [L] int32 global prim ids (tri i, sphere T + j)
    light_weights: Optional[torch.Tensor] = None     # [L] f32 pick probabilities
    light_alias_prob: Optional[torch.Tensor] = None  # [L] f32
    light_alias_idx: Optional[torch.Tensor] = None   # [L] int32
    n_textures: int = 0
    anims: Optional[AnimTable] = None          # keyframe tables (None: static scene)
    n_media: int = 0
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


def scene_from_numpy(a, device) -> SceneArrays:
    """The JAX package's flattened scene, with numpy leaves, as a SceneArrays on `device`.

    `a` is ``wurblpt_tpu.scene.ir.SceneArrays`` after
    ``jax.tree_util.tree_map(np.asarray, ...)``; it is read by attribute only.
    Where the JAX scene has a BVH, the port builds its own from the triangles
    (a static tree: the port refuses animation in a BVH scene). The keyframe
    tables come across where the scene has an animation beyond row 0.
    The RGL tables come across where a material is RGL (the JAX scene always
    carries a placeholder table).
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
    materials = MaterialTable(_i32(m.typ, device), _i32(m.flags, device),
                              _f32(m.albedo, device), _f32(m.emissive, device),
                              _f32(m.p0, device), _f32(m.p1, device), _f32(m.p2, device),
                              _i32(m.rgl_id, device))
    opt = lambda x, conv: None if x is None else conv(x, device)  # noqa: E731
    n_textures = int(np.shape(a.textures.typ)[0])
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

        bvh = build_bvh(tris)
    return SceneArrays(
        tris=tris, spheres=spheres, materials=materials,
        light_prims=_i32(a.light_prims, device),
        light_weights=opt(a.light_weights, _f32),
        light_alias_prob=opt(a.light_alias_prob, _f32),
        light_alias_idx=opt(a.light_alias_idx, _i32),
        n_textures=n_textures,
        anims=anims,
        n_media=int(np.shape(a.media.density)[0]),
        bvh=bvh,
        envmap=envmap,
        rgl=(rgl_tables_from_numpy(a.rgl, device)
             if bool(np.any(np.asarray(m.typ) == MaterialType.RGL)) else None),
        prim_light_pick=opt(a.prim_light_pick, _f32),
        prim_inv_area=opt(a.prim_inv_area, _f32),
    )
