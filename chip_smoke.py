#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``wurblpt_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one NVIDIA GPU

Phases, each a function, any failure exits non-zero and names its phase:

1. build  - compile the hand-written kernels of csrc/ with nvcc (sm_90a), one
   nvcc per source, all at once; compile the host BVH builder with g++.
2. scenes - terrain_city(seed=3) (102098 triangles) and city_night(seed=7)
   (249218 triangles after its OBJ/MTL round trip, 192 light triangles, an
   RGL sphere), each built on the card's host with its BVH;
   envmap_spheres(cube=True) (2 triangles, 3 spheres, a cube-map sky with a
   64 x 64 importance table), rtiow() (40 spheres, no triangle, a constant
   sky) and tof_box() (54 triangles, 32 of them the ToF light).
3. kernels - each kernel against its plain PyTorch version on the card, at
   its path's shapes, with the tolerances of utils/kernel_check.py; each
   kernel's wrapper-call time beside the plain version's and, where one
   PyTorch call computes the same function, that call's (CUDA events around
   20 calls after warm-up), and its bound: the least time an H100 could take
   for the same work (kernel_check.bound_ms). K1-K3 on the Cornell frame's
   block (128 x 128 pixels x 8 sample lanes = 131072 lanes); K5 on the mesh
   frame's 76800 camera rays and random rays, K6 on env-NEE shadow rays from
   their first hits and random rays, K8 on the camera directions and on
   uniforms; K7 on 1048576 lanes of the city frame's block (camera hits and
   their bounce directions, random tangent-space lanes); P0 on the Pallas
   probe's shapes and on the city's material rows at 1048576 lanes. K1-K3
   also on the rtiow frame's 98304 camera rays (spheres alone, no triangle),
   K1 and K3 on the envmap frame's 131072 camera rays (triangles and spheres
   together) and K2 on its env-NEE shadow rays; K8 on the cube map
   (the envmap frame's 131072 camera directions, random directions, and
   the axis, diagonal, face-edge and texel-boundary directions) and on the
   constant map, both bit-equal.
4. main path - the Cornell bench frame (128 x 128, 16 spp, 8 path
   components, SensorRGB) through render_frame_wavefront on the GPU. K1,
   K2, K3 and K4 must be launched and P0 not, the image must be finite, its
   mean within 1e-3 relative of the JAX package's deterministic CPU output,
   and the cast counters within 0.5 % of it.
5. mesh path - the bvh_100k bench frame (160 x 120, 4 spp, 4 path
   components): K3, K5, K6 and K8 must be launched, and the frame held to
   its JAX reference as in phase 4.
6. city path - the city_many_lights bench frame (1920 x 1080, 360-degree
   stereo, 1 spp, 4 path components, per-light MIS): K3, K5, K6, K7 (eval and
   sample), K8 and P0 must be launched, and the frame held to its JAX
   reference as in phase 4.
7. envmap path - the envmap_cube_is bench frame (128 x 128, 16 spp, 8 path
   components; glass, mirror and GGX spheres under the importance-sampled
   cube-map sky): K1, K2, K3, P0 and K8 (radiance, sample, pdf) must be
   launched, and the frame held to its JAX reference as in phase 4.
8. rtiow path - the rtiow_distortion bench frame (192 x 128, 16 spp, 8 path
   components, OpenCV lens, 40 spheres under a constant sky): K1, K3, P0
   and K8 radiance must be launched (no shadow ray: no light, no sky
   importance), and the frame held to its JAX reference as in phase 4.
9. tof path - the tof_amcw bench frame (96 x 96, 16 spp, 6 path components,
   SensorTofAmcw, the ToF cone light with per-light MIS) at phase 0: K1,
   K2, K3 and K4 (regeneration, shade, resolve) must be launched and P0
   not, and the frame held to its JAX reference (mean energy, the three
   channel means, counters); phases 1-3 keep the counters and the mean
   and phase 2 swaps the buckets a and b; the 4-phase distance at depth 1
   is held to the first-hit distance of the pixel-centre rays (median
   under 2 mm).

The Cornell frame (phase 4) and the ToF frame take K4, the diffuse class's
wavefront step (regeneration, K1, K3, shade, K2, resolve); the other paths
the torch-op bounce. The kernels phase holds each K4 kernel against its
plain version on the first block of both frames after 2 steps (lanes live,
dead and due for regeneration). Every path prints its frame time, paths/s,
Mrays/s and kernel launches per wavefront step, and apart from them the
copies and memsets (one more frame under torch.profiler; the scene's
tables are built once per scene, before the frames); the two K4 paths also
the launches of one step of the loop and of the frame's set-up, from the
difference to the same frame at 1 path component, and fail above 12
kernel launches per step of the frame. Each path's counters are set to 0
just before it and read just after; a kernel's `launches` in the JSON line
is the sum over the paths that use it (K8's three records each over the
paths of their map's kind).

Output, at the end: the card's name and power limit as nvidia-smi reports
them, one JSON line with the kernels, and as the last line
{"ok": true, "device": {...}}. No result is printed without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback

DEVICE = "cuda"
kc = np = torch = None   # bound in main(): nothing is imported before the CUDA check

PATHS = ("main path", "mesh path", "city path", "envmap path", "rtiow path", "tof path")
K4_PATHS = ("main path", "tof path")
K4_MAX_LAUNCHES_PER_STEP = 12   # kernel launches per step of a K4 frame, set-up included
ENV_ALL = ("env_radiance", "env_sample", "env_pdf")
# name -> (source, TPU kernel it replaces, launch counters, paths whose launches count)
KERNELS = {
    "closest_hit": ("wurblpt_tpu_torch/csrc/closest_hit.cu",
                    "wurblpt_tpu/render/intersect_mxu.py:164", ("closest_hit",), PATHS),
    "any_hit": ("wurblpt_tpu_torch/csrc/any_hit.cu",
                "wurblpt_tpu/render/intersect_mxu.py:259", ("any_hit",), PATHS),
    "assemble_hit": ("wurblpt_tpu_torch/csrc/assemble_hit.cu",
                     "wurblpt_tpu/render/intersect_mxu.py:345", ("assemble_hit",), PATHS),
    "bvh_closest_hit": ("wurblpt_tpu_torch/csrc/bvh_closest.cu",
                        "wurblpt_tpu/accel/traverse.py:511", ("bvh_closest_hit",), PATHS),
    "bvh_any_hit": ("wurblpt_tpu_torch/csrc/bvh_any.cu",
                    "wurblpt_tpu/accel/traverse.py:597", ("bvh_any_hit",), PATHS),
    "envmap": ("wurblpt_tpu_torch/csrc/envmap.cu", "wurblpt_tpu/render/envmap.py:166",
               ENV_ALL, ("mesh path", "city path")),
    "envmap_cube": ("wurblpt_tpu_torch/csrc/envmap.cu", "wurblpt_tpu/render/envmap.py:118",
                    ENV_ALL, ("envmap path",)),
    "envmap_constant": ("wurblpt_tpu_torch/csrc/envmap.cu", "wurblpt_tpu/render/envmap.py:181",
                        ("env_radiance",), ("rtiow path",)),
    "rgl_eval": ("wurblpt_tpu_torch/csrc/rgl.cu", "wurblpt_tpu/materials/rgl.py:633",
                 ("rgl_eval",), PATHS),
    "rgl_sample": ("wurblpt_tpu_torch/csrc/rgl.cu", "wurblpt_tpu/materials/rgl.py:650",
                   ("rgl_sample",), PATHS),
    "row_gather": ("wurblpt_tpu_torch/csrc/row_gather.cu", "tools/probe_pallas_gather.py:20",
                   ("row_gather",), PATHS),
    "regen_pinhole": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:973",
                      ("regen_pinhole",), K4_PATHS),
    "shade_diffuse": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:400",
                      ("shade_diffuse",), K4_PATHS),
    "nee_resolve": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:648",
                    ("nee_resolve",), K4_PATHS),
}
K4 = ("regen_pinhole", "shade_diffuse", "nee_resolve")
MAIN_PATH = ("closest_hit", "any_hit", "assemble_hit") + K4
TOF_PATH = MAIN_PATH
MESH_PATH = ("assemble_hit", "bvh_closest_hit", "bvh_any_hit") + ENV_ALL
CITY_PATH = MESH_PATH + ("rgl_eval", "rgl_sample", "row_gather")
ENVMAP_PATH = ("closest_hit", "any_hit", "assemble_hit", "row_gather") + ENV_ALL
RTIOW_PATH = ("closest_hit", "assemble_hit", "row_gather", "env_radiance")


def phase_build():
    from wurblpt_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.build_kernels()
    native.load_kernels()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.1f} s -> {lib.relative_to(native.BUILD_DIR.parent.parent)}")
    t0 = time.perf_counter()
    native.load_bvh_builder()
    print(f"build: host BVH builder {time.perf_counter() - t0:.1f} s")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())


def _timed_records(timed, errs, lanes):
    """name -> (kernel call, plain call, (bytes, flops) of the work, library call or None)."""
    records = []
    for name, (kernel, plain, work, library) in timed.items():
        ms = kc.time_ms(kernel, DEVICE)
        plain_ms = kc.time_ms(plain, DEVICE)
        library_ms = None if library is None else kc.time_ms(library, DEVICE)
        bound, bound_by = kc.bound_ms(*work)
        print(f"kernels: {name} {ms:.4f} ms (wrapper call) vs plain {plain_ms:.4f} ms"
              f"{'' if library is None else f', library {library_ms:.4f} ms'}; bound "
              f"{bound:.6f} ms by {bound_by} ({work[0]:.4g} bytes, {work[1]:.4g} flops) "
              f"at {lanes} lanes")
        src, replaces, _, _ = KERNELS[name]
        records.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": 0, "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": library_ms})
    return records


def _run_checks(checks):
    errs = {}
    for name, check, sets in checks:
        err = 0.0
        for label, args in sets.items():
            res = check(*args)
            torch.cuda.synchronize()
            print(f"kernels: {name} [{label}] ok {res}")
            err = max(err, res["max_abs_err"])
        errs[name] = err
    return errs


def phase_kernels(scenes_on_card):
    from wurblpt_tpu_torch.accel import traverse
    from wurblpt_tpu_torch.materials import rgl
    from wurblpt_tpu_torch.render import bsdf, envmap, gather, intersect, intersect_brute
    from wurblpt_tpu_torch.utils import scenes

    mesh_scene, city_scene = scenes_on_card["mesh"], scenes_on_card["city"]

    # K1-K3 on the Cornell frame's block.
    scene = scenes.cornell_box_ref(DEVICE)
    bs = intersect_brute.build_brute_scene(scene)
    ht = intersect.build_hit_tables(scene)
    cam = kc.camera_lanes(kc.BENCH_WIDTH, kc.BENCH_WIDTH, kc.BENCH_LANES_M, DEVICE)
    rnd = kc.random_lanes(cam[0].shape[0], DEVICE)
    shadow = kc.shadow_lanes(scene, bs, cam)
    # The same on the sphere scenes: rtiow's camera rays (no triangle at all),
    # and the envmap frame's camera rays (triangles and spheres together) and
    # env-NEE shadow rays from their first hits.
    rt_scene, env_scene = scenes_on_card["rtiow"], scenes_on_card["envmap"]
    rt_bs = intersect_brute.build_brute_scene(rt_scene)
    rt_ht = intersect.build_hit_tables(rt_scene)
    rt_cam = kc.rtiow_camera_lanes(DEVICE)
    env_bs = intersect_brute.build_brute_scene(env_scene)
    env_ht = intersect.build_hit_tables(env_scene)
    env_cam = kc.envmap_camera_lanes(DEVICE)
    env_shadow = kc.env_shadow_lanes(env_scene, env_cam, env_bs)
    errs = _run_checks((
        ("closest_hit", lambda b, r: kc.check_closest_hit(b, r),
         {"camera": (bs, cam), "random": (bs, rnd), "rtiow camera, spheres only": (rt_bs, rt_cam),
          "envmap camera": (env_bs, env_cam)}),
        ("any_hit", lambda b, r: kc.check_any_hit(b, r),
         {"shadow": (bs, shadow), "random": (bs, rnd),
          "rtiow camera, spheres only": (rt_bs, rt_cam), "envmap env shadow": (env_bs, env_shadow)}),
        ("assemble_hit", lambda b, h, r: kc.check_assemble_hit(b, h, r),
         {"camera": (bs, ht, cam), "random": (bs, ht, rnd),
          "rtiow camera, spheres only": (rt_bs, rt_ht, rt_cam),
          "envmap camera": (env_bs, env_ht, env_cam)})))
    t, prim, u, v = intersect_brute.closest_hit_plain(bs, *cam)
    o, d = cam[0], cam[1]
    records = _timed_records({
        "closest_hit": (lambda: intersect_brute.closest_hit(bs, *cam),
                        lambda: intersect_brute.closest_hit_plain(bs, *cam),
                        kc.closest_hit_work(bs, cam), None),
        "any_hit": (lambda: intersect_brute.any_hit(bs, *shadow),
                    lambda: intersect_brute.any_hit_plain(bs, *shadow),
                    kc.any_hit_work(bs, shadow), None),
        "assemble_hit": (lambda: intersect.assemble_hit(ht, o, d, t, prim, u, v),
                         lambda: intersect.assemble_hit_plain(ht, o, d, t, prim, u, v),
                         kc.assemble_hit_work(ht, o.shape[0]), None),
    }, errs, cam[0].shape[0])

    # K5, K6, K8 on the mesh frame's block.
    bvh, env = mesh_scene.bvh, mesh_scene.envmap
    mcam = kc.mesh_camera_lanes(DEVICE)
    n = mcam[0].shape[0]
    mrnd = kc.terrain_random_lanes(n, DEVICE)
    eshadow = kc.env_shadow_lanes(mesh_scene, mcam)
    u3 = torch.as_tensor(np.random.default_rng(3).uniform(size=(n, 3)), dtype=torch.float32,
                         device=DEVICE)
    errs = _run_checks((
        ("bvh_closest_hit", lambda r: kc.check_bvh_closest_hit(bvh, r),
         {"camera": (mcam,), "random": (mrnd,)}),
        ("bvh_any_hit", lambda r: kc.check_bvh_any_hit(bvh, r),
         {"env shadow": (eshadow,), "random": (mrnd,)}),
        ("envmap", lambda dirs, uni: kc.check_envmap(env, dirs, uni),
         {"camera directions, uniforms": (mcam[1], u3)})))

    def env_all(radiance, sample, pdf, env=env, dirs=mcam[1], uni=u3):
        return lambda: (radiance(env, dirs), sample(env, uni), pdf(env, dirs))

    records += _timed_records({
        "bvh_closest_hit": (lambda: traverse.bvh_closest_hit(bvh, *mcam),
                            lambda: traverse.bvh_closest_hit_plain(bvh, *mcam),
                            kc.bvh_work(bvh, mcam, any_hit=False), None),
        "bvh_any_hit": (lambda: traverse.bvh_any_hit(bvh, *eshadow),
                        lambda: traverse.bvh_any_hit_plain(bvh, *eshadow),
                        kc.bvh_work(bvh, eshadow, any_hit=True), None),
        "envmap": (env_all(envmap.env_radiance, envmap.env_sample, envmap.env_pdf),
                   env_all(envmap.env_radiance_plain, envmap.env_sample_plain,
                           envmap.env_pdf_plain), kc.envmap_work(env, n), None),
    }, errs, n)

    # K8's cube branch on the envmap frame's sky (with its importance tables)
    # and its constant branch on rtiow's sky.
    cube, const = env_scene.envmap, rt_scene.envmap
    ecam = env_cam[1]
    ne = ecam.shape[0]
    eu3 = torch.as_tensor(np.random.default_rng(4).uniform(size=(ne, 3)), dtype=torch.float32,
                          device=DEVICE)
    rdirs = kc.random_directions(ne, DEVICE)
    edges = kc.cube_edge_directions(DEVICE)
    errs = _run_checks((
        ("envmap_cube", lambda dirs, uni: kc.check_envmap(cube, dirs, uni),
         {"envmap camera directions, uniforms": (ecam, eu3), "random directions": (rdirs, eu3),
          "axes, diagonals, face edges, texel boundaries": (edges, eu3[:edges.shape[0]])}),
        ("envmap_constant", lambda dirs: kc.check_envmap(const, dirs),
         {"rtiow camera directions": (rt_cam[1],), "random directions": (rdirs,)})))
    records += _timed_records({
        "envmap_cube": (env_all(envmap.env_radiance, envmap.env_sample, envmap.env_pdf, cube, ecam,
                                eu3),
                        env_all(envmap.env_radiance_plain, envmap.env_sample_plain,
                                envmap.env_pdf_plain, cube, ecam, eu3),
                        kc.envmap_work(cube, ne), None),
    }, errs, ne)
    nr = rt_cam[1].shape[0]
    records += _timed_records({
        "envmap_constant": (lambda: envmap.env_radiance(const, rt_cam[1]),
                            lambda: envmap.env_radiance_plain(const, rt_cam[1]),
                            kc.env_radiance_work(const, nr),
                            lambda: const.const_radiance.repeat(nr, 1)),
    }, errs, nr)

    # K7 on the city frame's block; P0 on the probe's shapes and the city's material rows.
    tables = city_scene.rgl
    mid, wi, wo, u2 = kc.city_rgl_lanes(city_scene, DEVICE)
    packed = bsdf.pack_material_table(city_scene.materials)
    mat_idx = torch.as_tensor(np.random.default_rng(9).integers(0, packed.shape[0], kc.CITY_LANES),
                              dtype=torch.int32, device=DEVICE)
    probe_rows, probe_vec = kc.probe_gather_inputs(DEVICE)
    errs = _run_checks((
        ("rgl", lambda: kc.check_rgl(tables, (mid, wi, wo, u2)),
         {"city camera hits and random lanes": ()}),
        ("row_gather", kc.check_row_gather,
         {"probe rows [512, 128] x 256": probe_rows, "probe vector [512] x [8, 128]": probe_vec,
          "city material rows": (packed, mat_idx)})))
    errs["rgl_eval"] = errs["rgl_sample"] = errs.pop("rgl")
    records += _timed_records({
        "rgl_eval": (lambda: rgl.rgl_eval(tables, mid, wi, wo),
                     lambda: rgl.rgl_eval_plain(tables, mid, wi, wo),
                     kc.rgl_work(tables, mid.shape[0], sample=False), None),
        "rgl_sample": (lambda: rgl.rgl_sample(tables, mid, wi, u2),
                       lambda: rgl.rgl_sample_plain(tables, mid, wi, u2),
                       kc.rgl_work(tables, mid.shape[0], sample=True), None),
        "row_gather": (lambda: gather.row_gather(packed, mat_idx),
                       lambda: gather.row_gather_plain(packed, mat_idx),
                       kc.row_gather_work(packed, mat_idx),
                       lambda: torch.index_select(packed, 0, mat_idx)),
    }, errs, mid.shape[0])
    return records + _k4_records()


def _k4_records():
    """K4's kernels against their plain versions on the Cornell and the ToF
    frame's first block after 2 steps; timed on the Cornell block."""
    from wurblpt_tpu_torch.render import wavefront as wf

    inputs = {frame: kc.k4_inputs(DEVICE, frame) for frame in ("cornell", "tof")}
    errs = {name: 0.0 for name in K4}
    for frame, inp in inputs.items():
        res = kc.check_k4(inp)
        torch.cuda.synchronize()
        for name in K4:
            print(f"kernels: {name} [{frame} block after 2 steps, "
                  f"{inp.regen[0].active.shape[0]} lanes] ok {res[name]}")
            errs[name] = max([errs[name]] + [v for k, v in res[name].items()
                                             if isinstance(v, float)])
    inp = inputs["cornell"]

    def shade(fn):
        return lambda: fn(*inp.shade)

    return _timed_records({
        "regen_pinhole": (lambda: wf.regen_pinhole(*inp.regen), lambda: wf.regen_plain(*inp.regen),
                          kc.k4_work(inp, "regen_pinhole"), None),
        "shade_diffuse": (shade(wf.shade_diffuse), shade(wf.shade_diffuse_plain),
                          kc.k4_work(inp, "shade_diffuse"), None),
        "nee_resolve": (lambda: wf.nee_resolve(*inp.resolve),
                        lambda: wf.nee_resolve_plain(*inp.resolve),
                        kc.k4_work(inp, "nee_resolve"), None),
    }, errs, inp.regen[0].active.shape[0])


def _drive(label, render, names, absent=()):
    """Render once with the counters at 0, check that `names` launched and
    `absent` did not, then time 5 more frames; returns (first image, stats,
    counters, frame times)."""
    from wurblpt_tpu_torch import native

    native.reset_launch_counts()
    t0 = time.perf_counter()
    img, stats = render()
    first_s = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    print(f"{label}: launches {launches}, first frame {first_s * 1e3:.1f} ms")
    for name in names:
        assert launches[name] > 0, f"kernel {name} was not launched on the {label}"
    for name in absent:
        assert launches[name] == 0, f"kernel {name} was launched on the {label}"
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        render()
        times.append(time.perf_counter() - t0)
    return img, [int(x) for x in stats.tolist()], launches, times


def _count_launches(render):
    """(CUDA kernel launches, copies and memsets, wavefront steps) of one
    frame rendered under torch.profiler; a step is one closest-hit cast."""
    from torch.profiler import ProfilerActivity, profile

    from wurblpt_tpu_torch import native

    native.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(e.count for e in device if e.key.startswith(("Memcpy", "Memset")))
    kernels = sum(e.count for e in device) - copies
    return kernels, copies, native.LAUNCHES["closest_hit"] + native.LAUNCHES["bvh_closest_hit"]


def _report(label, stats, times, paths, render, short=None, max_per_step=None):
    """Frame time, paths/s, Mrays/s and the kernel launches (and apart from
    them the copies and memsets) of one more frame per step; with `short`,
    the same frame at 1 path component, also the launches of one step of
    the loop, (launches - short's) / (steps - short's), and those of the
    frame's set-up (the lane state), which a step does not repeat. Fails if
    the kernel launches per step of the frame exceed `max_per_step`."""
    dt = statistics.median(times)
    n, c, steps = _count_launches(render)
    per_step = (f", {n} kernel launches and {c} copies/memsets in {steps} steps "
                f"({n / max(steps, 1):.2f} and {c / max(steps, 1):.2f} per step")
    if short is not None:
        n0, c0, steps0 = _count_launches(short)
        n1, c1 = (n - n0) / (steps - steps0), (c - c0) / (steps - steps0)
        per_step += (f"; {n1:.2f} and {c1:.2f} per step of the loop, {n - n1 * steps:.0f} and "
                     f"{c - c1 * steps:.0f} of set-up")
    print(f"{label}: frame {dt * 1e3:.2f} ms (median of 5; all "
          f"{[round(t * 1e3, 2) for t in times]}), {paths / dt:.4g} paths/s, "
          f"{stats[1] / dt / 1e6:.4g} Mrays/s{per_step}) on {_nvidia_smi()}")
    if max_per_step is not None:
        assert n <= max_per_step * steps, (
            f"{label}: {n / steps:.2f} kernel launches per step, more than {max_per_step}")


def phase_main_path():
    render = kc.bench_frame(DEVICE)
    img, stats, launches, times = _drive("main path", render, MAIN_PATH, ("row_gather",))
    print(f"main path: mean radiance {float(img.double().mean())!r} (reference {kc.REF_MEAN}), "
          f"stats {stats} (reference {list(kc.REF_STATS)})")
    kc.check_bench_frame(img, stats)
    _report("main path", stats, times, kc.BENCH_WIDTH ** 2 * kc.BENCH_SSQRT ** 2, render,
            kc.bench_frame(DEVICE, depth=1), K4_MAX_LAUNCHES_PER_STEP)
    return launches


def phase_city_path(city_scene):
    render = kc.city_frame(DEVICE, city_scene)
    img, stats, launches, times = _drive("city path", render, CITY_PATH)
    print(f"city path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.CITY_REF_MEAN}), stats {stats} (reference {list(kc.CITY_REF_STATS)})")
    kc.check_city_frame(img, stats)
    _report("city path", stats, times, kc.CITY_WIDTH * kc.CITY_HEIGHT * kc.CITY_SSQRT ** 2,
            render)
    return launches


def phase_mesh_path(mesh_scene):
    render = kc.mesh_frame(DEVICE, mesh_scene)
    img, stats, launches, times = _drive("mesh path", render, MESH_PATH)
    print(f"mesh path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.MESH_REF_MEAN}), stats {stats} (reference {list(kc.MESH_REF_STATS)})")
    kc.check_mesh_frame(img, stats)
    _report("mesh path", stats, times, kc.MESH_WIDTH * kc.MESH_HEIGHT * kc.MESH_SSQRT ** 2,
            render)
    return launches


def phase_envmap_path(env_scene):
    render = kc.envmap_frame(DEVICE, env_scene)
    img, stats, launches, times = _drive("envmap path", render, ENVMAP_PATH)
    print(f"envmap path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.ENVMAP_REF_MEAN}), stats {stats} "
          f"(reference {list(kc.ENVMAP_REF_STATS)})")
    kc.check_envmap_frame(img, stats)
    _report("envmap path", stats, times, kc.ENVMAP_WIDTH ** 2 * kc.ENVMAP_SSQRT ** 2,
            render)
    return launches


def phase_rtiow_path(rt_scene):
    render = kc.rtiow_frame(DEVICE, rt_scene)
    img, stats, launches, times = _drive("rtiow path", render, RTIOW_PATH)
    print(f"rtiow path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.RTIOW_REF_MEAN}), stats {stats} (reference {list(kc.RTIOW_REF_STATS)})")
    kc.check_rtiow_frame(img, stats)
    _report("rtiow path", stats, times, kc.RTIOW_WIDTH * kc.RTIOW_HEIGHT * kc.RTIOW_SSQRT ** 2,
            render)
    return launches


def phase_tof_path(tof_scene):
    render = kc.tof_frame(DEVICE, tof_scene)
    img, stats, launches, times = _drive("tof path", render, TOF_PATH, ("row_gather",))
    channels = [float(img[..., c].double().mean()) for c in range(3)]
    print(f"tof path: phase 0 mean energy {float(img.double().mean())!r} J (reference "
          f"{kc.TOF_REF_MEAN}), channels a, b, energy {channels} (reference "
          f"{list(kc.TOF_REF_CHANNELS)}), stats {stats} (reference {list(kc.TOF_REF_STATS)})")
    kc.check_tof_frame(img, stats)
    _report("tof path", stats, times, kc.TOF_WIDTH ** 2 * kc.TOF_SSQRT ** 2, render,
            kc.tof_frame(DEVICE, tof_scene, depth=1), K4_MAX_LAUNCHES_PER_STEP)
    # Phases 1-3: the same paths (the counters), the same energy; tau = pi
    # swaps the two buckets.
    for i in (1, 2, 3):
        img_i, stats_i = kc.tof_frame(DEVICE, tof_scene, phase_index=i)()
        mean_i = float(img_i.double().mean())
        ch = [float(img_i[..., c].double().mean()) for c in range(3)]
        print(f"tof path: phase {i} mean energy {mean_i!r} J, channels {ch}, stats "
              f"{stats_i.tolist()}")
        assert [int(x) for x in stats_i.tolist()] == stats, f"phase {i}: counters differ"
        assert abs(mean_i - kc.TOF_REF_MEAN) <= 1e-3 * kc.TOF_REF_MEAN, f"phase {i}: mean"
        assert abs(ch[2] - channels[2]) <= 1e-6 * channels[2], f"phase {i}: energy differs"
        if i == 2:
            for c in (0, 1):
                assert abs(ch[c] - channels[1 - c]) <= 1e-3 * channels[1 - c], "a, b not swapped"
    dist = kc.tof_distance_check(DEVICE, tof_scene)
    print(f"tof path: 4-phase distance at depth 1 against the pixel-centre first hits: {dist}")
    return launches


def phase_scenes():
    from wurblpt_tpu_torch.utils import scenes

    out = {}
    for label, build in (("mesh", lambda: scenes.terrain_city(seed=3, device=DEVICE)),
                         ("city", lambda: scenes.city_night(seed=7, device=DEVICE)),
                         ("envmap", lambda: scenes.envmap_spheres(cube=True, device=DEVICE)),
                         ("rtiow", lambda: scenes.rtiow(device=DEVICE)),
                         ("tof", lambda: scenes.tof_box(device=DEVICE))):
        t0 = time.perf_counter()
        scene = build()
        torch.cuda.synchronize()
        bvh = (f"{scene.bvh.nodes.shape[0]} BVH nodes, depth {scene.bvh.depth}" if scene.has_bvh
               else "brute force")
        print(f"scenes: {label} scene built for the GPU in {time.perf_counter() - t0:.2f} s: "
              f"{scene.n_tris} triangles, {scene.n_spheres} spheres, {scene.n_lights} light "
              f"triangles, {bvh}, sky kind {scene.env_kind}")
        out[label] = scene
    return out


def _nvidia_smi():
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60)
    except OSError as e:
        return f"nvidia-smi failed: {e}"
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "nvidia-smi failed"


def main() -> int:
    global kc, np, torch

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from wurblpt_tpu_torch.utils import kernel_check as kc
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    out = {}
    for name, phase in (("build", phase_build), ("scenes", phase_scenes),
                        ("kernels", lambda: phase_kernels(out["scenes"])),
                        ("main path", phase_main_path),
                        ("mesh path", lambda: phase_mesh_path(out["scenes"]["mesh"])),
                        ("city path", lambda: phase_city_path(out["scenes"]["city"])),
                        ("envmap path", lambda: phase_envmap_path(out["scenes"]["envmap"])),
                        ("rtiow path", lambda: phase_rtiow_path(out["scenes"]["rtiow"])),
                        ("tof path", lambda: phase_tof_path(out["scenes"]["tof"]))):
        try:
            out[name] = phase()
        except Exception as e:  # report which phase failed, then fail the run
            traceback.print_exc()
            print(f"FAILED phase {name}: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
    records = out["kernels"]
    for r in records:
        _, _, counters, paths = KERNELS[r["name"]]
        r["launches"] = sum(out[path][c] for path in paths for c in counters)
    print(_nvidia_smi())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
