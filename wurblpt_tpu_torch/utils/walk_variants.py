"""K5/K6's walk against variants of itself, on the casts of the BVH frames.

    python -m wurblpt_tpu_torch.utils.walk_variants [--variants a,b,...]
        [--frames rtiow_bvh,cornell_animated_bvh,mesh,city] [--parent DIR] [--out DIR]

Builds `csrc/bvh_closest.cu` and `csrc/bvh_any.cu` once as they are and
once per variant: a copy of the sources with the variant's text
replacements (PATCHES, checked to apply), in a temporary directory, each
into a library of its own with the port's nvcc flags, and prints each
library's ptxas lines. With `--parent DIR` (the package directory of an
older tree, e.g. unpacked by `git archive`), that tree's walk is built too
(`parent`, its C interface as before the staged branch), and so are its
own variants (PARENT_PATCHES, named `parent:<name>`). Then, per frame: one
render records every K5/K6 cast (`cast_steps.record_casts`); each exact
variant (EXACT) is held bit for bit against the first library (the parent
where given) on every cast; the dead-lane floor (every lane's t_max 0) of
the first and of this tree's library; and every library timed on every
cast by `kernel_check.device_ms` in turns (the libraries in order, then in
reverse), printed as the mean per launch of each turn and per cast.
Variants that change results (the leaf tests stubbed, the object ray forced
to the world ray) separate the walk's parts; they are timed, not held.
Needs a CUDA device and nvcc."""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from .. import native
from ..accel import traverse
from . import cast_steps, scenes
from . import kernel_check as kc

SOURCES = ("bvh_closest.cu", "bvh_any.cu", "bvh_common.cuh", "sweep_common.cuh")

# this tree's walk -----------------------------------------------------------
_OWN_CHUNK = """                int base = own;
                if (own < 0) {
                    if (wave >= rays.n) {
                        drained = true;
                        break;
                    }
                    base = 0;
                    if (lane == 0) base = wave + atomicAdd(counter, 32);
                    base = __shfl_sync(FULL, base, 0);
                }
                own = -1;
"""


def _grab(chunks: int) -> str:
    """The lane fetch taking `chunks` chunks of 32 lanes per atomic past the
    warp's own chunk (the launch's wave is a multiple of 128 lanes)."""
    return _OWN_CHUNK.replace("atomicAdd(counter, 32)", f"atomicAdd(counter, {32 * chunks})").replace(
        "                own = -1;\n",
        "                own = base + 32;\n"
        f"                if (base < wave || ((own - wave) & {32 * chunks - 1}) == 0) own = -1;\n")


_COUNTER_ONLY = """                int base = 0;
                if (lane == 0) base = atomicAdd(counter, 32);
                base = __shfl_sync(FULL, base, 0);
"""
_ROUND_ROBIN = """                const int base = own;
                own += wave;
"""
_MEMSET_WAVE = "        if (n > grid * BLOCK) cudaMemsetAsync(counter, 0, sizeof(int), s);\n"
_MEMSET_ALWAYS = "        cudaMemsetAsync(counter, 0, sizeof(int), s);\n"
_QUOTIENT_AFTER = """    if (mixed || det == 0.f || !in_range) return false;
    const float inv_det = 1.f / det;
    t = tn * inv_det;
    u = ve * inv_det;
    v = we * inv_det;
    return true;"""
_QUOTIENT_ALWAYS = """    const float inv_det = 1.f / (det == 0.f ? 1.f : det);
    t = tn * inv_det;
    u = ve * inv_det;
    v = we * inv_det;
    return !mixed && det != 0.f && in_range;"""
_LEAF_START = "    const int start = code >> 4, count = code & 15;\n"
_MIN_BLOCKS = "constexpr int MIN_BLOCKS = 4;"

# The warp's leaves tested together (every row of every leaf the warp's
# threads reached one task, 32 at a time): measured slower in PR 18.
_ROW_TEST_OLD = """template <bool ANY, bool SPHERES, bool STAGED, class W>
__device__ __forceinline__ bool test_row(W& w, const Ray& r, const float4* row, float4 a,
                                         float4 b, float bound, int n_tris) {
    float t, u, v;
    bool hit;
    if (SPHERES && __float_as_int(a.w) >= n_tris) {
        hit = wpt_sweep::sphere_test<true>(v3(r.o), v3(r.d), make_float4(a.x, a.y, a.z, b.x),
                                           w.tmin, bound, t);
        u = v = 0.f;
    } else {
        hit = watertight(r, a, b, ld4<STAGED>(row + 2), w.tmin, bound, t, u, v);
    }
    if (!hit) return false;"""
_ROW_TEST_NEW = """template <bool SPHERES, bool STAGED>
__device__ __forceinline__ bool row_test(const Ray& r, const float4* row, float4 a, float4 b,
                                         float tmin, float bound, int n_tris, float& t, float& u,
                                         float& v) {
    if (SPHERES && __float_as_int(a.w) >= n_tris) {
        u = v = 0.f;
        return wpt_sweep::sphere_test<true>(v3(r.o), v3(r.d), make_float4(a.x, a.y, a.z, b.x),
                                            tmin, bound, t);
    }
    return watertight(r, a, b, ld4<STAGED>(row + 2), tmin, bound, t, u, v);
}

template <bool ANY, bool SPHERES, bool STAGED, class W>
__device__ __forceinline__ bool test_row(W& w, const Ray& r, const float4* row, float4 a,
                                         float4 b, float bound, int n_tris) {
    float t, u, v;
    if (!row_test<SPHERES, STAGED>(r, row, a, b, w.tmin, bound, n_tris, t, u, v)) return false;"""
_CACHE_LOAD = """    // r = the ray in animation `id`'s object space (id > 0), computed from
    // its frame row f once per ray."""
_CACHE_RAY_OF = """    __device__ __forceinline__ void ray_of(int dt, int id, const float* __restrict__ f,
                                           Ray& r) const {
        const float* e = slot + dt + ((id - 1) & mask) * SLOT_WORDS * BLOCK;
        if (__float_as_int(e[7 * BLOCK]) == id) {
            r.o = make_float3(e[0], e[BLOCK], e[2 * BLOCK]);
            r.d = make_float3(e[3 * BLOCK], e[4 * BLOCK], e[5 * BLOCK]);
            shear_with(r, e[6 * BLOCK]);
            return;
        }
        const float* wo = world + dt;
        wpt_sweep::V3 oa, da;
        wpt_sweep::object_ray(f, {wo[0], wo[BLOCK], wo[2 * BLOCK]},
                              {wo[3 * BLOCK], wo[4 * BLOCK], wo[5 * BLOCK]}, oa, da);
        r.o = f3(oa);
        r.d = f3(da);
        set_shear(r);
    }

""" + _CACHE_LOAD
_SMEM_DECL = "// The dynamic shared memory of a launch (its size: Layout::bytes). The"
_WARP_LEAVES = """__device__ __forceinline__ float shfl(float x, int src) {
    return __int_as_float(__shfl_sync(FULL, __float_as_int(x), src));
}

__device__ __forceinline__ unsigned long long hit_key(float t, int k) {
    const unsigned b = static_cast<unsigned>(__float_as_int(t));
    const unsigned ordered = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    return (static_cast<unsigned long long>(ordered) << 32) | static_cast<unsigned>(k);
}

template <bool ANY, bool SPHERES, bool ANIMATED>
__device__ __forceinline__ bool warp_leaves(Walk<ANIMATED>& w, bool leaf,
                                            const float4* __restrict__ rows, int stride, int n_tris,
                                            const float* __restrict__ frames,
                                            const Cache& cache, unsigned long long* keys) {
    const int lane = threadIdx.x & 31;
    const int code = leaf ? -1 - w.cur : 0;
    const int cnt = code & 15, start = code >> 4;
    int off = cnt;
    for (int s = 1; s < 32; s <<= 1) {
        const int v = __shfl_up_sync(FULL, off, s);
        if (lane >= s) off += v;
    }
    const int total = __shfl_sync(FULL, off, 31);
    off -= cnt;
    if (total == 0) return false;
    const float bound = fminf(w.tmax, w.best_t);
    if constexpr (ANIMATED) {
        for (int k = 0; k < cnt; ++k) {
            const int id = __float_as_int(ld4<true>(rows + stride * (start + k) + 1).w);
            if (id != 0) {
                Ray obj;
                cache.load(id, frames + id * STAGED_FRAME, obj);
            }
        }
    }
    keys[lane] = ~0ull;
    __syncwarp();
    const int kpack = w.r.kx | (w.r.ky << 2) | (w.r.kz << 4);
    for (int base = 0; base < total; base += 32) {
        const int j = base + lane;
        int owner = 0;
        for (int step = 16; step > 0; step >>= 1) {
            const int v = __shfl_sync(FULL, off, (owner + step) & 31);
            if (owner + step < 32 && v <= j) owner += step;
        }
        const int k = j - __shfl_sync(FULL, off, owner);
        const int first = __shfl_sync(FULL, start, owner);
        Ray r;
        r.o = make_float3(shfl(w.r.o.x, owner), shfl(w.r.o.y, owner), shfl(w.r.o.z, owner));
        r.d = make_float3(shfl(w.r.d.x, owner), shfl(w.r.d.y, owner), shfl(w.r.d.z, owner));
        const int kp = __shfl_sync(FULL, kpack, owner);
        r.kx = kp & 3;
        r.ky = (kp >> 2) & 3;
        r.kz = kp >> 4;
        r.sx = shfl(w.r.sx, owner);
        r.sy = shfl(w.r.sy, owner);
        r.sz = shfl(w.r.sz, owner);
        const float tmin = shfl(w.tmin, owner), bnd = shfl(bound, owner);
        if (j < total) {
            const float4* row = rows + stride * (first + k);
            const float4 a = ld4<true>(row + 0), b = ld4<true>(row + 1);
            if constexpr (ANIMATED) {
                const int id = __float_as_int(b.w);
                if (id != 0) cache.ray_of(owner - lane, id, frames + id * STAGED_FRAME, r);
            }
            float t, u, v;
            if (row_test<SPHERES, true>(r, row, a, b, tmin, bnd, n_tris, t, u, v)) {
                if (ANY)
                    keys[owner] = 0ull;
                else
                    atomicMin(keys + owner, hit_key(t, k));
            }
        }
    }
    __syncwarp();
    const unsigned long long key = keys[lane];
    __syncwarp();
    if (!leaf || key == ~0ull) return false;
    if (ANY) return true;
    const int k = static_cast<int>(key & 15u);
    const float4* row = rows + stride * (start + k);
    const float4 a = ld4<true>(row + 0), b = ld4<true>(row + 1);
    const int id = __float_as_int(b.w);
    test_row<false, SPHERES, true>(w, w.leaf.get(w.r, cache, frames + id * STAGED_FRAME, id), row,
                                   a, b, bound, n_tris);
    return false;
}

""" + _SMEM_DECL
_LOOP_OLD = """        if (__all_sync(FULL, w.ray < 0)) return;   // drained, and every ray done
        if (w.ray < 0) continue;
        bool done = false;
        // inner nodes until a leaf, or the end of the walk
        while (w.cur >= 0) {"""
_LOOP_NEW = """        if (__all_sync(FULL, w.ray < 0)) return;
        if (!STAGED && w.ray < 0) continue;
        bool done = w.ray < 0;
        while (!done && w.cur >= 0) {"""
_LEAF_OLD = """        // one leaf, then the next entry of the stack
        if (!done) {"""
_LEAF_NEW = """        if constexpr (STAGED) {
            if (warp_leaves<ANY, SPHERES, ANIMATED>(w, !done, rows, row_stride, tree.n_tris,
                                                    frames, cache, keys)) {
                w.occluded = true;
                done = true;
            } else if (!done && !stk.pop(fminf(w.tmax, w.best_t), w.cur)) {
                done = true;
            }
            if (w.ray < 0) continue;
        } else if (!done) {"""
_LAYOUT_OLD = "    int cache, world, nodes, rows, frames, bytes;\n"
_LAYOUT_NEW = "    int keys, cache, world, nodes, rows, frames, bytes;\n"
_STACK_OLD = "    int at = staged ? depth * BLOCK * 8 : 0;\n"
_STACK_NEW = _STACK_OLD + "    l.keys = at;\n    at += staged ? BLOCK * 8 : 0;\n"
_KEYS_OLD = "    const int lane = threadIdx.x & 31;\n    const unsigned below = (1u << lane) - 1u;\n"
_KEYS_NEW = ("    unsigned long long* keys =\n"
             "        reinterpret_cast<unsigned long long*>(dyn + lay.keys) + (threadIdx.x & ~31u);\n"
             + _KEYS_OLD)
_WALK_OLD = "    Walk<ANIMATED> w;\n    w.ray = -1;\n"
_WALK_NEW = _WALK_OLD + "    w.tmin = w.tmax = w.best_t = 0.f;\n"

PATCHES = {
    # the lanes
    "counter_only": [("bvh_common.cuh", _OWN_CHUNK, _COUNTER_ONLY),
                     ("bvh_closest.cu", _MEMSET_WAVE, _MEMSET_ALWAYS),
                     ("bvh_any.cu", _MEMSET_WAVE, _MEMSET_ALWAYS)],
    "round_robin": [("bvh_common.cuh", _OWN_CHUNK, _ROUND_ROBIN)],
    "grab2": [("bvh_common.cuh", _OWN_CHUNK, _grab(2))],
    "grab4": [("bvh_common.cuh", _OWN_CHUNK, _grab(4))],
    # the triangle test's quotients on every row
    "quotients_always": [("bvh_common.cuh", _QUOTIENT_AFTER, _QUOTIENT_ALWAYS)],
    # the leaf tests stubbed out
    "stub_leaf": [("bvh_common.cuh", _LEAF_START, "    return false;\n" + _LEAF_START)],
    # register caps
    "blocks7": [("bvh_common.cuh", _MIN_BLOCKS, "constexpr int MIN_BLOCKS = 7;")],
    "blocks8": [("bvh_common.cuh", _MIN_BLOCKS, "constexpr int MIN_BLOCKS = 8;")],
    # the staged walk's leaves, a warp's together
    "warp_leaves": [("bvh_common.cuh", _ROW_TEST_OLD, _ROW_TEST_NEW),
                    ("bvh_common.cuh", _CACHE_LOAD, _CACHE_RAY_OF),
                    ("bvh_common.cuh", _SMEM_DECL, _WARP_LEAVES),
                    ("bvh_common.cuh", _LOOP_OLD, _LOOP_NEW),
                    ("bvh_common.cuh", _LEAF_OLD, _LEAF_NEW),
                    ("bvh_common.cuh", _LAYOUT_OLD, _LAYOUT_NEW),
                    ("bvh_common.cuh", _STACK_OLD, _STACK_NEW),
                    ("bvh_common.cuh", _KEYS_OLD, _KEYS_NEW),
                    ("bvh_common.cuh", _WALK_OLD, _WALK_NEW)],
}

# the PR 17 walk (--parent) -------------------------------------------------
PARENT_PATCHES = {
    "stub_leaf": [("bvh_common.cuh", _LEAF_START, "    return false;\n" + _LEAF_START)],
    "world_obj": [("bvh_common.cuh", "        if (id != aid) {\n            wpt_sweep::V3 oa, da;",
                   "        if (false) {\n            wpt_sweep::V3 oa, da;")],
    "no_counter": [("bvh_common.cuh", """                if (lane == 0) base = atomicAdd(counter, 32);
                base = __shfl_sync(FULL, base, 0);""", """                base = stat;
                stat += static_cast<int>(gridDim.x) * BLOCK;"""),
                   ("bvh_common.cuh", "    bool drained = false; // the counter has passed n\n",
                    "    bool drained = false; // the counter has passed n\n    int stat = "
                    "static_cast<int>(blockIdx.x) * BLOCK + static_cast<int>(threadIdx.x & ~31u);\n")],
    "pretests": [("bvh_common.cuh", _QUOTIENT_ALWAYS, _QUOTIENT_AFTER),
                 ("sweep_common.cuh", """        disc = fmaf(half_b, half_b, -(a * c));
    } else {""", """        disc = fmaf(half_b, half_b, -(a * c));
        if (!(disc > 0.f)) return false;
    } else {""")],
}

# variants whose results are the walk's, bit for bit
EXACT = ("counter_only", "round_robin", "grab2", "grab4", "quotients_always", "blocks7", "blocks8",
         "warp_leaves",
         "parent:no_counter", "parent:pretests")

FRAMES = {
    "rtiow_bvh": (lambda dev: scenes.rtiow(n=kc.RTIOW_BVH_N, device=dev, use_bvh=True),
                  kc.rtiow_bvh_frame),
    "cornell_animated_bvh": (lambda dev: scenes.cornell_box_animated(dev, spheres=True,
                                                                     use_bvh=True),
                             kc.cornell_animated_bvh_frame),
    "mesh": (lambda dev: scenes.terrain_city(seed=3, device=dev), kc.mesh_frame),
    "city": (lambda dev: scenes.city_night(seed=7, device=dev), kc.city_frame),
}

_I, _P = ctypes.c_int, ctypes.c_void_p
_PARENT_SIGNATURES = {   # the C interface before the staged branch
    "wpt_bvh_closest_hit": [_I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "wpt_bvh_closest_threads": [_I],
    "wpt_bvh_any_hit": [_I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P],
    "wpt_bvh_any_threads": [_I],
}


def patched(src: Path, edits, out: Path) -> Path:
    """A copy of the walk's sources from `src` with `edits` applied."""
    out.mkdir(parents=True, exist_ok=True)
    for name in SOURCES:
        text = (src / name).read_text()
        for f, old, new in edits:
            if f == name:
                if old not in text:
                    raise ValueError(f"a patch does not apply to {src / name}: {old[:60]!r}")
                text = text.replace(old, new)
        (out / name).write_text(text)
    return out


def _entry_name(mangled: str) -> str:
    try:
        name = subprocess.run(["c++filt"], input=mangled, capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return mangled
    return name.split("(anonymous namespace)::", 1)[-1].split("(")[0]


def build_all(dirs):
    """{name: ctypes library} of the walk in each directory, built at once;
    each one's ptxas lines printed."""
    procs = {}
    for name, d in dirs.items():
        cmd = [native._nvcc(), *native.NVCC_FLAGS, "-shared", "-o", str(d / "libwalk.so"),
               str(d / "bvh_closest.cu"), str(d / "bvh_any.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
        entry, lines = "", []
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = _entry_name(line.split("'")[1])
            elif "Used" in line or "spill" in line:
                lines.append(f"  {entry}: {line.split('ptxas info    :')[-1].strip()}")
        print(f"== {name}\n" + "\n".join(lines), flush=True)
        lib = ctypes.CDLL(str(dirs[name] / "libwalk.so"))
        parent = name == "parent" or name.startswith("parent:")
        sigs = _PARENT_SIGNATURES if parent else {
            k: native._SIGNATURES[k] for k in ("wpt_bvh_closest_hit", "wpt_bvh_closest_threads",
                                              "wpt_bvh_closest_budget", "wpt_bvh_any_hit",
                                              "wpt_bvh_any_threads", "wpt_bvh_any_budget")}
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, parent)
    return libs


_parent_scratch = {}


def _cast_parent(lib, name, bvh, rays, frames):
    """One cast through the PR 17 C interface."""
    o, d, tmin, tmax = rays
    n, dev = o.shape[0], o.device
    var = traverse.variant(bvh, frames)
    key = (id(lib), name, var)
    if key not in _parent_scratch:
        threads = getattr(lib, f"wpt_{name}_threads")(var)
        _parent_scratch[key] = (
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.empty(max(threads * max(bvh.depth - traverse.SHARED_STACK, 0) * 2, 1),
                        dtype=torch.int32, device=dev))
    counter, spill = _parent_scratch[key]
    fr = 0 if frames is None else frames.data_ptr()
    s = torch.cuda.current_stream().cuda_stream
    common = (var, o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), n,
              bvh.nodes.data_ptr(), bvh.prim_v.data_ptr(), bvh.n_tris, fr, counter.data_ptr(),
              spill.data_ptr())
    if name == "bvh_closest":
        t = torch.empty(n, device=dev)
        prim = torch.empty(n, dtype=torch.int32, device=dev)
        u, v = torch.empty_like(t), torch.empty_like(t)
        native.check(lib.wpt_bvh_closest_hit(*common, t.data_ptr(), prim.data_ptr(), u.data_ptr(),
                                             v.data_ptr(), s), "parent bvh_closest_hit")
        return t, prim, u, v
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    native.check(lib.wpt_bvh_any_hit(*common, occ.data_ptr(), s), "parent bvh_any_hit")
    return (occ,)


def cast(libs, which, name, bvh, rays, frames):
    """One K5 (`name` bvh_closest) or K6 (bvh_any) cast through library
    `which`: the parent's interface, or this tree's wrapper with the
    library in place of the port's own (its plan cached apart)."""
    lib, parent = libs[which]
    if parent:
        return _cast_parent(lib, name, bvh, rays, frames)
    saved, saved_scratch = native._lib, dict(traverse._SCRATCH)
    native._lib = lib
    traverse._SCRATCH.clear()
    traverse._SCRATCH.update(_own_scratch.setdefault(which, {}))
    try:
        if name == "bvh_closest":
            return traverse.bvh_closest_hit(bvh, *rays, frames)
        return (traverse.bvh_any_hit(bvh, *rays, frames),)
    finally:
        _own_scratch[which] = dict(traverse._SCRATCH)
        traverse._SCRATCH.clear()
        traverse._SCRATCH.update(saved_scratch)
        native._lib = saved


_own_scratch = {}


def _kernel(kname):
    return "bvh_closest" if kname == "bvh_closest_hit" else "bvh_any"


def run_frame(frame, libs, device, n: int = 20):
    """The frame's casts: exact variants held against the first library,
    dead-lane floors, and every library's time per cast in turns."""
    make_scene, make_frame = FRAMES[frame]
    scene = make_scene(device)
    render = make_frame(device, scene)
    render()
    casts = cast_steps.record_casts(render)
    print(f"{frame}: {len(casts)} casts; {cast_steps.tree_summary(scene.bvh)}; branch "
          f"{traverse.plan(scene.bvh, casts[0][3])[1]}", flush=True)
    names = list(libs)
    first = names[0]
    for which in names[1:]:
        if which not in EXACT and which != "this":
            continue
        for kname, bvh, rays, frames in casts:
            a = cast(libs, first, _kernel(kname), bvh, rays, frames)
            b = cast(libs, which, _kernel(kname), bvh, rays, frames)
            for x, y in zip(a, b):
                if x.dtype == torch.float32:
                    x, y = x.view(torch.int32), y.view(torch.int32)
                if not torch.equal(x, y):
                    raise AssertionError(f"{frame}: {which} differs from {first} on {kname}")
    print(f"{frame}: the exact variants bit-equal to {first} on every cast", flush=True)
    out = {"floors": {}, "times": {}}
    for which in dict.fromkeys((first, "this")):
        for kname in ("bvh_closest_hit", "bvh_any_hit"):
            sel = [c for c in casts if c[0] == kname]
            if sel:
                _, bvh, rays, frames = sel[0]
                dead = rays[:3] + (torch.zeros_like(rays[3]),)
                ms = [kc.device_ms(lambda: cast(libs, which, _kernel(kname), bvh, dead, frames), n)
                      for _ in range(3)]
                out["floors"][f"{which} {kname}"] = ms
                print(f"{frame} {which} {kname}: every lane dead "
                      f"{', '.join(f'{m * 1e3:.2f}' for m in ms)} us", flush=True)
    times = out["times"]
    for which in names + names[::-1]:
        for kname, bvh, rays, frames in casts:
            ms = kc.device_ms(lambda: cast(libs, which, _kernel(kname), bvh, rays, frames), n)
            times.setdefault(which, {}).setdefault(kname, []).append(ms)
    for which, per in times.items():
        for kname, ms in per.items():
            k = len(ms) // 2
            print(f"{frame} {which} {kname}: {k} casts, us per launch {sum(ms[:k]) / k * 1e3:.2f} / "
                  f"{sum(ms[k:]) / k * 1e3:.2f} (two turns)", flush=True)
    for kname in ("bvh_closest_hit", "bvh_any_hit"):
        sel = [c for c in casts if c[0] == kname]
        for i, c in enumerate(sel):
            live = int((c[2][3] > c[2][2]).sum())
            row = ", ".join(f"{w} {times[w][kname][i] * 1e3:.2f}" for w in names)
            print(f"  {frame} {kname} step {i}: {c[2][0].shape[0]} lanes, {live} live: {row}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="", help="comma-separated names of PATCHES, and of "
                    "PARENT_PATCHES as parent:<name> (with --parent)")
    ap.add_argument("--frames", default=",".join(FRAMES), help=f"subset of {','.join(FRAMES)}")
    ap.add_argument("--parent", default=None, help="an older tree's package directory")
    ap.add_argument("--out", default=None, help="also write the times here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_variants: no CUDA device", file=sys.stderr)
        return 2
    native.load_kernels()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    variants = [v for v in args.variants.split(",") if v]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        dirs = {}
        if args.parent:
            parent_src = Path(args.parent) / "csrc"
            dirs["parent"] = patched(parent_src, [], tmp / "parent")
        dirs["this"] = patched(native.SRC_DIR, [], tmp / "this")
        for v in variants:
            if v.startswith("parent:"):
                dirs[v] = patched(parent_src, PARENT_PATCHES[v.split(":", 1)[1]],
                                  tmp / v.replace(":", "_"))
            else:
                dirs[v] = patched(native.SRC_DIR, PATCHES[v], tmp / v)
        t0 = time.perf_counter()
        libs = build_all(dirs)
        print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
        res = {f: run_frame(f, libs, "cuda") for f in args.frames.split(",")}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
