"""OBJ/MTL scene import and export (port of ``wurblpt_tpu/io/obj.py``).

Import mirrors the reference's ``importIntoScene`` (import.hpp:206-508) into
a builder :class:`~wurblpt_tpu_torch.scene.builder.Scene`: per MTL material
the heuristics that pick Lambertian, glass (with the import flag) or
ModPhong, the transmittance and opacity fixups (with the JAX package's
deliberate divergence), the texture maps (map_Kd, map_Ks, map_Ke, map_d,
a map_bump turned into a normal map by `bump_to_normal_map`, norm), one
merged mesh per material with (v, vn, vt) tuple dedup, emissive materials as
hot spots. Export writes a Scene as the JAX package writes it: the same MTL
records (with the explicit ``Tf 1 1 1`` of opaque materials), the same
``%g`` text for every number, textures as PNG files beside the MTL.

Parsing goes through the port's copy of the JAX package's native parser
(``csrc/host/obj_parser.cpp``, strtof), which is what the JAX package uses
wherever a C++ compiler exists, so both read the same floats from the same
text. Image files are read and written with PIL, imported only inside
`import_texture` and `_texture_to_png`: the rest of the port runs without it.
"""

from __future__ import annotations

import ctypes
import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .. import native
from ..scene import builder as B
from ..scene.flatten import bake_transform
from ..scene.geometryproc import compute_normals


class ImportBits:
    """Import flags (import.hpp ImportBit*)."""

    NONE = 0
    INVERTED_TF = 1 << 0          # transmittance stored inverted
    WITH_GLASS = 1 << 1           # allow the glass heuristic
    TWO_SIDED_MATERIALS = 1 << 2  # wrap everything two-sided
    DISABLE_LIGHT_SOURCES = 1 << 3
    DISABLE_HOT_SPOTS = 1 << 4


@dataclass
class RawObj:
    """Raw parse result: attribute arrays and per-corner index tuples."""

    v: np.ndarray       # [NV, 3]
    vn: np.ndarray      # [NN, 3]
    vt: np.ndarray      # [NT, 2]
    fv: np.ndarray      # [F, 3] int32 vertex index per corner
    fn: np.ndarray      # [F, 3] int32 (-1 = absent)
    ft: np.ndarray      # [F, 3] int32 (-1 = absent)
    fmat: np.ndarray    # [F] int32 material id (-1 = none)
    materials: List[dict]


def load_obj_raw(path: str) -> RawObj:
    """Parse an OBJ file and the MTL libraries it names (native parser)."""
    lib = native.load_obj_parser()
    h = lib.wobj_parse(path.encode(), os.path.dirname(os.path.abspath(path)).encode())
    if not h:
        raise OSError(f"cannot read {path}")
    try:
        counts = (ctypes.c_longlong * 5)()
        lib.wobj_counts(h, counts)
        nv, nn, nt, nf, nm = (int(c) for c in counts)
        v = np.zeros((max(nv, 1), 3), np.float32)
        vn = np.zeros((max(nn, 1), 3), np.float32)
        vt = np.zeros((max(nt, 1), 2), np.float32)
        lib.wobj_vertices(h, v.ctypes.data, vn.ctypes.data, vt.ctypes.data)
        fv, fn, ft = (np.zeros((max(nf, 1), 3), np.int32) for _ in range(3))
        fm = np.zeros((max(nf, 1),), np.int32)
        lib.wobj_faces(h, fv.ctypes.data, fn.ctypes.data, ft.ctypes.data, fm.ctypes.data)
        mats = []
        for i in range(nm):
            need = lib.wobj_material_json(h, i, None, 0)
            buf = ctypes.create_string_buffer(need + 1)
            lib.wobj_material_json(h, i, buf, need + 1)
            mats.append(json.loads(buf.value.decode("utf-8", "replace")))
        return RawObj(v[:nv], vn[:nn], vt[:nt], fv[:nf], fn[:nf], ft[:nf], fm[:nf], mats)
    finally:
        lib.wobj_free(h)


# ---------------------------------------------------------------------------
# Textures (importTexture, import.hpp:64-204)
# ---------------------------------------------------------------------------

def bump_to_normal_map(bump: np.ndarray, bump_scaling: float = 8.0) -> np.ndarray:
    """Height map [H, W] in [0, 1] -> tangent-space normal map [H, W, 3] in
    [0, 1] (import.hpp:64-92 toNormalMap)."""
    h = np.asarray(bump, np.float32)
    if h.ndim == 3:
        h = h[..., 0]
    right = h[:, np.minimum(np.arange(h.shape[1]) + 1, h.shape[1] - 1)]
    left = h[:, np.maximum(np.arange(h.shape[1]) - 1, 0)]
    top = h[np.minimum(np.arange(h.shape[0]) + 1, h.shape[0] - 1), :]
    bottom = h[np.maximum(np.arange(h.shape[0]) - 1, 0), :]
    tx = np.stack([np.full_like(h, 2.0), np.zeros_like(h), bump_scaling * (right - left)], -1)
    ty = np.stack([np.zeros_like(h), np.full_like(h, 2.0), bump_scaling * (top - bottom)], -1)
    n = np.cross(tx, ty)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return (0.5 * (n + 1.0)).astype(np.float32)


def import_texture(path: str, srgb: bool = True, to_normal_map: bool = False,
                   bump_multiplier: float = 1.0, cache: Optional[dict] = None):
    """An image file as an ImageTexture (PIL: png, jpg, tga, bmp, ...), or
    None where the file is missing or unreadable."""
    key = (os.path.abspath(path), srgb, to_normal_map, bump_multiplier)
    if cache is not None and key in cache:
        return cache[key]
    tex = None
    try:
        from PIL import Image

        arr = np.asarray(Image.open(path))
        if arr.dtype == np.uint8:
            arr_f = arr.astype(np.float32) / 255.0
        elif arr.dtype == np.uint16:
            arr_f = arr.astype(np.float32) / 65535.0
        else:
            arr_f = arr.astype(np.float32)
        if arr_f.ndim == 2:
            arr_f = arr_f[..., None]
        if to_normal_map:
            tex = B.ImageTexture(image=bump_to_normal_map(arr_f, 8.0 * bump_multiplier),
                                 srgb=False)
        else:
            tex = B.ImageTexture(image=arr_f, srgb=srgb)
    except Exception:
        tex = None
    if cache is not None:
        cache[key] = tex
    return tex


# ---------------------------------------------------------------------------
# Import into a Scene (import.hpp:206-508)
# ---------------------------------------------------------------------------

def _material_from_mtl(m: dict, base: str, import_bits: int, tex_cache: dict):
    """The reference's material heuristics (import.hpp:288-387): (the
    builder material, whether it emits)."""
    dif = np.asarray(m["kd"], np.float32)
    spc = np.asarray(m["ks"], np.float32)
    emi = np.asarray(m["ke"], np.float32)
    tra = np.asarray(m["tr"], np.float32)
    shi, opa, ior = float(m["ns"]), float(m["d"]), float(m["ni"])
    if import_bits & ImportBits.INVERTED_TF:
        tra = 1.0 - tra
    # Transmittance fixups (import.hpp:300-308), with the JAX package's
    # deliberate divergence: a material without Tf (tinyobj reads 0 0 0)
    # stays opaque; the reference would read it as fully transparent.
    if opa >= 1.0 and tra.max() < 1.0 and tra.max() > 0.0:
        opa = float(tra.mean())
        tra = 1.0 - tra
    if opa < 1.0 and tra.max() <= 0.0:
        tra = (1.0 - opa) * dif

    def tex_of(rec, srgb=True, to_nm=False):
        name = rec["name"]
        if not name:
            return None
        p = name if os.path.isabs(name) else os.path.join(base, name)
        return import_texture(p, srgb=srgb, to_normal_map=to_nm,
                              bump_multiplier=rec.get("bm", 1.0), cache=tex_cache)

    normal_map = tex_of(m["map_norm"], srgb=False)
    if normal_map is None:
        normal_map = tex_of(m["map_bump"], srgb=False, to_nm=True)
    dif_tex = tex_of(m["map_kd"])
    dif_tex_alpha = dif_tex is not None and dif_tex.image.shape[-1] in (2, 4)
    no_lights = bool(import_bits & ImportBits.DISABLE_LIGHT_SOURCES)
    has_emission = (emi.max() > 0.0 or m["map_ke"]["name"]) and not no_lights
    if (not dif_tex_alpha and spc.max() <= 0.0 and not m["map_ks"]["name"]
            and not has_emission and opa >= 1.0 and not m["map_d"]["name"]):
        # Lambertian, the cheapest (import.hpp:329-338)
        return B.Lambertian(albedo=dif_tex if dif_tex is not None else tuple(dif),
                            normal_map=normal_map), False
    if ((import_bits & ImportBits.WITH_GLASS) and dif_tex is None
            and not m["map_ks"]["name"] and emi.max() <= 0.0
            and not m["map_ke"]["name"] and opa < 1.0 and not m["map_d"]["name"]):
        return B.Glass(ior=ior, absorption=B.Glass.absorption_from_transparent_color(tuple(dif)),
                       normal_map=normal_map), False
    emissive, emissive_tex = (0.0, 0.0, 0.0), None
    if not no_lights:
        emissive, emissive_tex = tuple(emi), tex_of(m["map_ke"])
    # Opacity source (material_modphong.hpp:136-146): the map_d texture, else
    # the diffuse map's alpha channel, else the scalar dissolve.
    opa_src = tex_of(m["map_d"], srgb=False)
    if opa_src is None and dif_tex_alpha:
        alpha = np.asarray(dif_tex.image)[..., -1].astype(np.float32)
        opa_src = B.ImageTexture(image=np.repeat(alpha[..., None], 3, -1), srgb=False)
    mat = B.ModPhong(
        diffuse=dif_tex if dif_tex is not None else tuple(dif),
        specular=tex_of(m["map_ks"]) or tuple(spc),
        shininess=shi,
        opacity=opa_src if opa_src is not None else opa,
        emissive=emissive_tex if emissive_tex is not None else emissive,
        normal_map=normal_map,
        ior=ior,
        transmissive=tuple(np.clip(tra, 0.0, 1.0)),
    )
    is_light = (float(np.dot(emi, emi)) > 0.0 or emissive_tex is not None) and not no_lights
    return mat, is_light


def _dedup_mesh(raw: RawObj, sel: np.ndarray) -> Optional[B.Mesh]:
    """Merge the selected faces into one Mesh with (v, vn, vt) tuple dedup
    (import.hpp:415-479)."""
    if not np.any(sel):
        return None
    fv, fn, ft = raw.fv[sel], raw.fn[sel], raw.ft[sel]
    have_n = bool(np.all(fn >= 0)) and raw.vn.shape[0] > 0
    have_t = bool(np.all(ft >= 0)) and raw.vt.shape[0] > 0
    tuples = np.stack([fv, fn if have_n else np.zeros_like(fv),
                       ft if have_t else np.zeros_like(fv)], axis=-1)
    uniq, inv = np.unique(tuples.reshape(-1, 3), axis=0, return_inverse=True)
    indices = inv.reshape(-1, 3).astype(np.int32)
    normals = None
    if have_n:
        normals = raw.vn[uniq[:, 1]]
        ln = np.linalg.norm(normals, axis=-1, keepdims=True)
        if np.isfinite(normals).all() and ln.min() > 1e-6:
            normals = normals / ln
        else:
            normals = None   # invalid normals happen (e.g. Bistro); recompute
    texcoords = raw.vt[uniq[:, 2]] if have_t else None
    return B.Mesh(positions=raw.v[uniq[:, 0]], normals=normals, texcoords=texcoords,
                  indices=indices)


def import_into_scene(scene: B.Scene, path: str, transformation=None,
                      import_bits: int = ImportBits.NONE) -> int:
    """Import an OBJ/MTL file into `scene`: one merged MeshInstance per
    material, in material order, named materials, emissive materials' meshes
    as hot spots; returns the number of instances."""
    raw = load_obj_raw(path)
    base = os.path.dirname(os.path.abspath(path))
    tex_cache: dict = {}
    n_instances = 0
    for mid in range(-1, len(raw.materials)):
        mesh = _dedup_mesh(raw, raw.fmat == mid)
        if mesh is None:
            continue
        if mid < 0:
            mat, is_light, name = B.Lambertian(albedo=(0.5, 0.5, 0.5)), False, None
        else:
            mat, is_light = _material_from_mtl(raw.materials[mid], base, import_bits, tex_cache)
            name = raw.materials[mid]["name"]
        if import_bits & ImportBits.TWO_SIDED_MATERIALS:
            mat.two_sided = True
        scene.take_mesh_instance(
            B.MeshInstance(mesh=mesh, material=scene.take_material(mat, name=name),
                           transformation=transformation),
            hot_spot=is_light and not import_bits & ImportBits.DISABLE_HOT_SPOTS)
        n_instances += 1
    return n_instances


# ---------------------------------------------------------------------------
# Export (scene.hpp:215-240 exportToObj)
# ---------------------------------------------------------------------------

def _texture_to_png(tex, path_base: str) -> Optional[str]:
    """Rasterize an image, constant or checker texture to `path_base`.png
    (PIL); the file name, or None (PIL absent, or a noise texture)."""
    try:
        from PIL import Image
    except Exception:
        return None
    if isinstance(tex, B.ImageTexture):
        img = np.asarray(tex.image, np.float32)
    elif isinstance(tex, B.ConstantTexture):
        img = np.tile(np.asarray(tex.color, np.float32)[None, None, :3], (4, 4, 1))
    elif isinstance(tex, B.CheckerTexture):
        sx, sy = tex.squares
        yy, xx = np.mgrid[0:64, 0:64]
        c = (((xx * sx // 64) + (yy * sy // 64)) % 2).astype(np.float32)
        c1 = np.asarray(tex.color1, np.float32)[:3]
        c2 = np.asarray(tex.color2, np.float32)[:3]
        img = c1[None, None] * (1 - c[..., None]) + c2[None, None] * c[..., None]
    else:
        return None
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    out = path_base + ".png"
    Image.fromarray((np.clip(img[..., :3], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)).save(out)
    return os.path.basename(out)


def _mtl_record(mat, name: str, dirname: str) -> str:
    """The MTL lines of one material, as the JAX package writes them.

    Opaque materials write "Tf 1 1 1": tinyobj reads a missing Tf as 0 0 0,
    which the reference's transmittance fixup takes for full transparency."""
    out = []

    def color(key, val, tex_key):
        fn = None
        if isinstance(val, B.Texture):
            fn = _texture_to_png(val, os.path.join(dirname, f"{name}_{key}"))
            val = (1.0, 1.0, 1.0)
        c = np.asarray(val, np.float32).reshape(-1)[:3]
        out.append(f"{key} {c[0]:g} {c[1]:g} {c[2]:g}\n")
        if fn:
            out.append(f"{tex_key} {fn}\n")

    if isinstance(mat, B.Lambertian):
        color("Kd", mat.albedo, "map_Kd")
        out.append("Tf 1 1 1\n")
    elif isinstance(mat, B.ModPhong):
        color("Kd", mat.diffuse, "map_Kd")
        color("Ks", mat.specular, "map_Ks")
        color("Ke", mat.emissive, "map_Ke")
        out.append(f"Ns {mat.shininess:g}\nd {mat.opacity:g}\n")
        opa = (1.0 if isinstance(mat.opacity, B.Texture)
               else float(np.asarray(mat.opacity, np.float32).reshape(-1)[0]))
        tra = np.asarray(mat.transmissive, np.float32).reshape(-1)[:3]
        out.append(f"Tf {tra[0]:g} {tra[1]:g} {tra[2]:g}\n" if opa < 1.0 and tra.max() > 0.0
                   else "Tf 1 1 1\n")
    elif isinstance(mat, B.Glass):
        # The reference's known fault, kept: no Kd (ROADMAP C.2).
        out.append(f"Ni {float(np.asarray(mat.ior, np.float32).reshape(-1)[0]):g}\nd 0.1\n"
                   "illum 7\n")
    elif isinstance(mat, B.Mirror):
        color("Ks", mat.color, "map_Ks")
        out.append("illum 5\nTf 1 1 1\n")
    elif isinstance(mat, (B.LightDiffuse, B.LightSpot)):
        color("Ke", mat.radiance, "map_Ke")
        out.append("Tf 1 1 1\n")
    elif isinstance(mat, B.GGX):
        color("Kd", mat.albedo, "map_Kd")
        r = np.mean(np.asarray(mat.roughness, np.float32))
        out.append(f"Ns {max(2.0 / max(r * r, 1e-4) - 2.0, 0.0):g}\nTf 1 1 1\n")
    else:
        out.append("Kd 0.8 0.8 0.8\nTf 1 1 1\n")
    if mat.normal_map is not None:
        fn = _texture_to_png(mat.normal_map, os.path.join(dirname, f"{name}_norm"))
        if fn:
            out.append(f"norm {fn}\n")
    return "".join(out)


def export_scene_to_obj(scene: B.Scene, path: str) -> None:
    """Write the scene's mesh instances (each pose baked) and spheres (as
    40 x 20 tessellated meshes, sphere.hpp:64-85) to OBJ, their materials to
    MTL beside it and the materials' textures to PNG files; meshes without
    normals get computed ones. Media have no surface and are skipped."""
    from ..scene.generator import generate_sphere, transform_mesh

    base, _ = os.path.splitext(path)
    mtl_path = base + ".mtl"
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    mat_of_instance = [scene._resolve_material(inst.material) for inst, _ in scene._instances]
    mat_of_sphere = [scene._resolve_material(s.material) for s, _ in scene._spheres]
    names = {}
    with open(mtl_path, "w") as mf:
        for i, mat in enumerate(scene._materials):
            name = f"material_{i}"
            for k, v in scene._material_names.items():
                if v == i:
                    name = k.replace(" ", "_")
            names[i] = name
            mf.write(f"newmtl {name}\n{_mtl_record(mat, name, dirname)}\n")
    parts = [(inst.mesh, m, inst.transformation, f"instance_{i}")
             for i, ((inst, _), m) in enumerate(zip(scene._instances, mat_of_instance))]
    parts += [(transform_mesh(generate_sphere(radius=float(s.radius), slices=40, stacks=20),
                              translate=tuple(np.asarray(s.center, np.float32))),
               m, s.transformation, f"sphere_{i}")
              for i, ((s, _), m) in enumerate(zip(scene._spheres, mat_of_sphere))]
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl_path)}\n")
        v_off = n_off = t_off = 1
        for mesh, mat_id, tf, tag in parts:
            pos, nrm, uv = mesh.positions, mesh.normals, mesh.texcoords
            pos, nrm, _ = bake_transform(tf, pos, nrm, None)
            if nrm is None:
                nrm = compute_normals(pos, mesh.indices)
            lines = [f"o {tag}\nusemtl {names[mat_id]}\n"]
            lines += [f"v {a:g} {b:g} {c:g}\n" for a, b, c in np.asarray(pos, np.float32).tolist()]
            lines += [f"vn {a:g} {b:g} {c:g}\n" for a, b, c in np.asarray(nrm, np.float32).tolist()]
            tri = np.asarray(mesh.indices, np.int64)
            if uv is not None:
                lines += [f"vt {a:g} {b:g}\n" for a, b in np.asarray(uv, np.float32).tolist()]
                lines += [f"f {a + v_off}/{a + t_off}/{a + n_off} {b + v_off}/{b + t_off}/{b + n_off} "
                          f"{c + v_off}/{c + t_off}/{c + n_off}\n" for a, b, c in tri.tolist()]
                t_off += len(uv)
            else:
                lines += [f"f {a + v_off}//{a + n_off} {b + v_off}//{b + n_off} "
                          f"{c + v_off}//{c + n_off}\n" for a, b, c in tri.tolist()]
            f.write("".join(lines))
            v_off += len(pos)
            n_off += len(nrm)
