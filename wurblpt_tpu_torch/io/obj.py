"""OBJ/MTL export and import of static scenes (port of ``wurblpt_tpu/io/obj.py``,
the part the city path uses).

A host scene here is a list of :class:`~wurblpt_tpu_torch.scene.flatten.MeshSpec`
and the `material_table` rows they index. `export_scene_to_obj` writes it as
the JAX package writes a Scene: the same MTL records (with the explicit
``Tf 1 1 1`` of opaque materials) and the same ``%g`` text for every number.
`import_into_scene` reads it back as the reference's importIntoScene does
(import.hpp:206-508): the material heuristics (Lambertian or ModPhong; the
Tf fixup with the JAX package's deliberate divergence), one merged mesh per
material with (v, vn, vt) tuple dedup, emissive materials as hot spots.

Parsing goes through the port's copy of the JAX package's native parser
(``csrc/host/obj_parser.cpp``, strtof), which is what the JAX package uses
wherever a C++ compiler exists, so both read the same floats from the same
text. Texture maps, glass and the import flags are not ported: a material
that names a map raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
import json
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .. import native
from ..scene.flatten import MeshSpec, ModPhong, bake_transform, compute_normals
from ..scene.ir import MaterialType

# The maps the reference's importer reads (it ignores map_Ns).
_MAPS = ("map_kd", "map_ks", "map_ke", "map_d", "map_bump", "map_norm")


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
# Import (import.hpp:206-508)
# ---------------------------------------------------------------------------

def _material_from_mtl(m: dict) -> Tuple[tuple, bool]:
    """The reference's material heuristics (import.hpp:288-387) for constant
    materials: a `material_table` row and whether it emits."""
    maps = [k for k in _MAPS if m[k]["name"]]
    if maps:
        raise NotImplementedError(f"material {m['name']!r}: texture maps {maps} are not ported")
    dif = np.asarray(m["kd"], np.float32)
    spc = np.asarray(m["ks"], np.float32)
    emi = np.asarray(m["ke"], np.float32)
    tra = np.asarray(m["tr"], np.float32)
    shi, opa, ior = float(m["ns"]), float(m["d"]), float(m["ni"])
    # Transmittance fixups (import.hpp:300-308), with the JAX package's
    # deliberate divergence: a material without Tf (tinyobj reads 0 0 0)
    # stays opaque; the reference would read it as fully transparent.
    if opa >= 1.0 and tra.max() < 1.0 and tra.max() > 0.0:
        opa = float(tra.mean())
        tra = 1.0 - tra
    if opa < 1.0 and tra.max() <= 0.0:
        tra = (1.0 - opa) * dif
    if spc.max() <= 0.0 and not emi.max() > 0.0 and opa >= 1.0:
        return (MaterialType.LAMBERTIAN, tuple(dif), None), False
    row = (MaterialType.MODPHONG, tuple(dif),
           ModPhong(specular=tuple(spc), shininess=shi, opacity=opa, emissive=tuple(emi),
                    ior=ior, transmissive=tuple(np.clip(tra, 0.0, 1.0))))
    return row, float(np.dot(emi, emi)) > 0.0


def _dedup_mesh(raw: RawObj, sel: np.ndarray) -> Optional[MeshSpec]:
    """Merge the selected faces into one mesh with (v, vn, vt) tuple dedup
    (import.hpp:415-479); material 0, to be set by the caller."""
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
            normals = (normals / ln).astype(np.float32)
        else:
            normals = None   # invalid normals happen (e.g. Bistro); recompute
    texcoords = raw.vt[uniq[:, 2]].astype(np.float32) if have_t else None
    return MeshSpec(raw.v[uniq[:, 0]].astype(np.float32), normals, texcoords, indices, 0)


def import_into_scene(path: str) -> Tuple[List[MeshSpec], list]:
    """Import an OBJ/MTL file: (meshes, material rows), one merged mesh per
    material in material order, emissive materials' meshes as hot spots."""
    raw = load_obj_raw(path)
    meshes, rows = [], []
    for mid in range(-1, len(raw.materials)):
        mesh = _dedup_mesh(raw, raw.fmat == mid)
        if mesh is None:
            continue
        if mid < 0:
            row, is_light = (MaterialType.LAMBERTIAN, (0.5, 0.5, 0.5), None), False
        else:
            row, is_light = _material_from_mtl(raw.materials[mid])
        rows.append(row)
        meshes.append(mesh._replace(material=len(rows) - 1, hot_spot=is_light))
    return meshes, rows


# ---------------------------------------------------------------------------
# Export (scene.hpp:215-240 exportToObj)
# ---------------------------------------------------------------------------

def _g3(key: str, val) -> str:
    c = np.asarray(val, np.float32).reshape(-1)[:3]
    return f"{key} {c[0]:g} {c[1]:g} {c[2]:g}\n"


def _mtl_record(row) -> str:
    """The MTL lines of one material row, as the JAX package writes them.

    Opaque materials write "Tf 1 1 1": tinyobj reads a missing Tf as 0 0 0,
    which the reference's transmittance fixup takes for full transparency."""
    t, c, param = row
    if t == MaterialType.LAMBERTIAN:
        return _g3("Kd", c) + "Tf 1 1 1\n"
    if t == MaterialType.MODPHONG:
        out = (_g3("Kd", c) + _g3("Ks", param.specular) + _g3("Ke", param.emissive)
               + f"Ns {param.shininess:g}\nd {param.opacity:g}\n")
        tra = np.asarray(param.transmissive, np.float32).reshape(-1)[:3]
        if float(param.opacity) < 1.0 and tra.max() > 0.0:
            return out + f"Tf {tra[0]:g} {tra[1]:g} {tra[2]:g}\n"
        return out + "Tf 1 1 1\n"
    if t == MaterialType.MIRROR:
        return _g3("Ks", (1.0, 1.0, 1.0) if c is None else c) + "illum 5\nTf 1 1 1\n"
    if t == MaterialType.LIGHT_DIFFUSE:
        return _g3("Ke", c) + "Tf 1 1 1\n"
    if t == MaterialType.GGX:
        r = np.mean(np.asarray(param, np.float32))
        return _g3("Kd", c) + f"Ns {max(2.0 / max(r * r, 1e-4) - 2.0, 0.0):g}\nTf 1 1 1\n"
    raise NotImplementedError(f"material type {t}: no MTL export in the port")


def export_scene_to_obj(meshes: List[MeshSpec], rows: list, path: str) -> None:
    """Write the meshes to OBJ and their materials to MTL beside it, baking each
    mesh's transformation; meshes without normals get computed ones."""
    base, _ = os.path.splitext(path)
    mtl_path = base + ".mtl"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(mtl_path, "w") as mf:
        for i, row in enumerate(rows):
            mf.write(f"newmtl material_{i}\n{_mtl_record(row)}\n")
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl_path)}\n")
        v_off = n_off = t_off = 1
        for i, mesh in enumerate(meshes):
            pos = np.asarray(mesh.positions, np.float32)
            nrm = None if mesh.normals is None else np.asarray(mesh.normals, np.float32)
            uv = mesh.texcoords
            pos, nrm, _ = bake_transform(mesh.transformation, pos, nrm, None)
            if nrm is None:
                nrm = compute_normals(pos, mesh.indices)
            lines = [f"o instance_{i}\nusemtl material_{mesh.material}\n"]
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
