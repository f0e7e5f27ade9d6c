"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The kernels are compiled at first use with ``nvcc`` into one shared library
with a plain C interface and loaded with ctypes: no PyTorch headers are
compiled, so the build takes seconds. Each source compiles in its own nvcc
process, all started together, and one more links them. The library lands in
``_build/<hash of sources and flags>/``, so a changed source rebuilds and an
unchanged one is reused. Nothing is built or loaded at import time.

No ``--use_fast_math`` (K3 needs IEEE atan2/asin, the casts IEEE division and
sqrt) and ``-fmad=false``: each kernel then rounds every operation as the
PyTorch op of its plain version does, so the two can be compared bit for bit.

`LAUNCHES` counts kernel launches per kernel; each wrapper adds one where it
launches its kernel and nowhere else.

Two host libraries, plain C++ with a C interface in ``csrc/host/``, are
compiled with g++ into ``_build/host-<hash>/``: the SAH BVH builder
(`load_bvh_builder`) and the OBJ/MTL parser (`load_obj_parser`). They are the
port's own copies of the JAX package's host sources, byte for byte but for
one comment line of the builder's header (it cites the reference renderer's
source by a path relative to that project), so both packages build the same
tree and read the same floats from the same files.
``-ffp-contract=off`` and no ``-march=native``, so every machine builds the
same tree from the same triangles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("closest_hit.cu", "any_hit.cu", "assemble_hit.cu", "bvh_closest.cu", "bvh_any.cu",
           "envmap.cu", "rgl.cu", "row_gather.cu", "wavefront.cu", "sweep_closest.cu",
           "sweep_any.cu")
HEADERS = ("brute_common.cuh", "bvh_common.cuh", "envmap_common.cuh", "rgl_common.cuh",
           "sweep_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")
LIB_NAME = "libwpt_kernels.so"

BVH_BUILDER_SRC = SRC_DIR / "host" / "bvh_builder.cpp"
OBJ_PARSER_SRC = SRC_DIR / "host" / "obj_parser.cpp"
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fno-exceptions", "-ffp-contract=off")

LAUNCHES = {"closest_hit": 0, "any_hit": 0, "assemble_hit": 0, "assemble_hit_anim": 0,
            "sweep_closest": 0, "sweep_any": 0, "bvh_closest_hit": 0,
            "bvh_any_hit": 0, "env_radiance": 0, "env_sample": 0, "env_pdf": 0, "rgl_eval": 0,
            "rgl_sample": 0, "row_gather": 0, "regen_pinhole": 0, "regen_surround": 0,
            "shade_diffuse": 0, "shade_env": 0, "shade_lit": 0, "nee_resolve": 0}

_lock = threading.Lock()
_lib = None
_bvh_builder = None
_obj_parser = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "wpt_closest_hit": [_P, _P, _P, _P, _I, _P, _I, _P, _I, _F, _F, _F, _P, _P, _P, _P, _P],
    "wpt_any_hit": [_P, _P, _P, _P, _I, _P, _I, _P, _I, _F, _F, _F, _P, _P],
    "wpt_assemble_hit": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I,
                         _P, _P, _P, _P, _P, _P, _P, _P],
    "wpt_assemble_hit_anim": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P,
                              _P, _P, _P, _P, _P, _P, _P, _P],
    "wpt_sweep_closest": [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "wpt_sweep_any": [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P],
    "wpt_bvh_closest_hit": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "wpt_bvh_closest_threads": [],
    "wpt_bvh_any_hit": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P],
    "wpt_bvh_any_threads": [],
    "wpt_env_radiance": [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P],
    "wpt_env_sample": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P],
    "wpt_env_pdf": [_P, _I, _P, _I, _P, _P, _P],
    "wpt_rgl_eval": [_P, _P, _P, _P, _I, _P, _P, _P],
    "wpt_rgl_sample": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "wpt_row_gather": [_P, _I, _I, _P, _I, _P, _P],
    "wpt_regen_pinhole": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _L, _I, _I, _L, _L, _I, _I,
                          _I, _I, _P],
    "wpt_regen_surround": [_P, _P, _I, _P, _P, _P, _P, _F, _F, _F, _I, _L, _I, _I, _L, _L, _I, _I,
                           _I, _I, _P],
    "wpt_shade_diffuse": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P,
                          _P, _P, _P, _I, _I, _I, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P],
    "wpt_shade_env": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I,
                      _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _F, _P, _P, _P, _P],
    "wpt_shade_lit": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P,
                      _P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _F, _F,
                      _F, _P, _P, _P, _P, _P, _P],
    "wpt_nee_resolve": [_P, _P, _P, _I, _P, _P, _I, _I, _L, _I, _L, _L, _P, _P, _P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> Path:
    """Compile the kernels unless a build of the same sources exists; return the library.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``build.log``."""
    out_dir = BUILD_DIR / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(SRC_DIR / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs, failed = [], []
    for src, p in zip(SOURCES, procs):
        out = p.communicate()[0]
        logs.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(f"{src} ({p.returncode}):\n{out[-3000:]}")
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                               "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-3000:]}")
    (out_dir / "build.log").write_text("\n".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)
    return lib


def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and dlopen the kernel library, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_kernels()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _compile_host(src: Path, name: str) -> Path:
    """Compile one host C++ source into a shared library under `_build`, once per content."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(src.read_bytes())
    out_dir = BUILD_DIR / f"host-{h.hexdigest()[:16]}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found (set CXX or put g++ on PATH)")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load_bvh_builder():
    """The C function ``wurblpt_build_bvh`` of bvh_builder.cpp, built at first use."""
    global _bvh_builder
    with _lock:
        if _bvh_builder is None:
            lib = ctypes.CDLL(str(_compile_host(BVH_BUILDER_SRC, "wpt_bvh_builder")))
            fn = lib.wurblpt_build_bvh
            fn.restype = ctypes.c_int
            fn.argtypes = [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P]
            _bvh_builder = fn
        return _bvh_builder


def load_obj_parser() -> ctypes.CDLL:
    """The OBJ/MTL parser of obj_parser.cpp (``wobj_*``), built at first use."""
    global _obj_parser
    with _lock:
        if _obj_parser is None:
            lib = ctypes.CDLL(str(_compile_host(OBJ_PARSER_SRC, "wpt_obj_parser")))
            lib.wobj_parse.restype = ctypes.c_void_p
            lib.wobj_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.wobj_counts.argtypes = [_P, ctypes.POINTER(ctypes.c_longlong)]
            lib.wobj_vertices.argtypes = [_P, _P, _P, _P]
            lib.wobj_faces.argtypes = [_P, _P, _P, _P, _P]
            lib.wobj_material_json.restype = ctypes.c_int
            lib.wobj_material_json.argtypes = [_P, _I, ctypes.c_char_p, _I]
            lib.wobj_free.argtypes = [_P]
            _obj_parser = lib
        return _obj_parser


def check(code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (the C side returns cudaGetLastError())."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
