#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``wurblpt_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one NVIDIA GPU

Phases, each a function, any failure exits non-zero and names its phase:

1. build  - compile the hand-written kernels of csrc/ with nvcc (sm_90a), one
   nvcc per source, all at once; compile the host BVH builder with g++.
2. scenes - terrain_city(seed=3) (102098 triangles) and city_night(seed=7)
   (249218 triangles after its OBJ/MTL round trip, 192 light triangles, an
   RGL sphere), each built on the card's host with its BVH (its nodes, leaf
   rows, depth and table size printed);
   envmap_spheres(cube=True) (2 triangles, 3 spheres, a cube-map sky with a
   64 x 64 importance table), rtiow() (40 spheres, no triangle, a constant
   sky), tof_box() (54 triangles, 32 of them the ToF light),
   cornell_box_animated() (36 triangles, 4 animation rows: the short box
   turning, the tall box and the light sliding), the same with two spheres
   (one riding the short box's turn), and ROADMAP C.1's brute-force fields:
   sphere_field() with 3000 and 4096 spheres (the K1 form's 6144 and 8192
   columns) and tri_sphere_field() (2000 triangles and 40 spheres, 8448
   columns: the sweeps).
3. kernels - each kernel against its plain PyTorch version on the card, at
   its path's shapes, with the tolerances of utils/kernel_check.py; each
   kernel's wrapper-call time beside the plain version's and, where one
   PyTorch call computes the same function, that call's (CUDA events around
   20 calls after warm-up), and its bound: the least time an H100 could take
   for the same work (kernel_check.bound_ms). K1-K3 on the Cornell frame's
   block (128 x 128 pixels x 8 sample lanes = 131072 lanes); K5 on the mesh
   frame's 76800 camera rays and random rays, K6 on env-NEE shadow rays from
   their first hits and random rays, both also with every lane dead and on
   1000 lanes (bit-equal); K8's equirect branch on the city
   frame's night sky, its block's 1048576 camera directions and uniforms;
   K7 on 1048576 lanes of the city frame's block (camera hits and
   their bounce directions, random tangent-space lanes); P0 on the Pallas
   probe's shapes and on the city's material rows at 1048576 lanes (K8's
   equirect branch, K7 and the material rows now run inside K4's shades;
   their stand-alone kernels stay checked here). K1-K3
   also on the rtiow frame's 98304 camera rays (spheres alone, no triangle),
   K1 and K3 on the envmap frame's 131072 camera rays (triangles and spheres
   together) and K2 on its env-NEE shadow rays; K8 on the cube map
   (the envmap frame's 131072 camera directions, random directions, and
   the axis, diagonal, face-edge and texel-boundary directions) and on the
   constant map, both bit-equal. K1, K2 and K3 also on the C.1 sphere
   fields' 98304 camera rays (3000 and 4096 spheres; K2 on shadow rays from
   their first hits to random sky directions). The sweeps KS1 and KS2 and
   the hit assembly (K3 static, K3a animated) against their plain versions,
   bit-equal, on three sets of rays: the cornell_animated frame's block
   (131072 camera rays, random rays, and NEE shadow rays toward the light
   where it is at t = 0.5), tri_sphere_field's camera rays (static sweeps)
   and the animated Cornell box with spheres (the camera rays: the sphere
   branches in object space); KS1, KS2 and K3a timed on the
   cornell_animated block.
4. main path - the Cornell bench frame (128 x 128, 16 spp, 8 path
   components, SensorRGB) through render_frame_wavefront on the GPU. K1,
   K2, K3 and K4 must be launched and P0 not, the image must be finite, its
   mean within 1e-3 relative of the JAX package's deterministic CPU output,
   and the cast counters within 0.5 % of it.
5. mesh path - the bvh_100k bench frame (160 x 120, 4 spp, 4 path
   components, GGX and mirror spheres under the importance-sampled equirect
   sky) through K4's env class: the regeneration, K5, K3, the env shade, K6
   and the NEE resolve must be launched, and neither P0 nor K8's stand-alone
   kernels (the shade reads the sky inline); the frame held to its JAX
   reference as in phase 4.
6. city path - the city_many_lights bench frame (1920 x 1080, 360-degree
   stereo, 1 spp, 4 path components; ModPhong, RGL, 192 window triangles
   under per-light MIS beside the importance-sampled night sky) through
   K4's lit class: the surround regeneration, K5, K3, the lit shade (RGL,
   the sky and the material rows inline), K6 (the light and sky shadow
   rays in one cast) and the NEE resolve must be launched, and neither P0,
   K7's nor K8's stand-alone kernels; the frame held to its JAX reference
   as in phase 4.
7. envmap path - the envmap_cube_is bench frame (128 x 128, 16 spp, 8 path
   components; glass, mirror and GGX spheres under the importance-sampled
   cube-map sky) through K4's env class: the regeneration, K1, K3, the env
   shade (its cube-sky and glass instantiation), K2 and the NEE resolve
   must be launched, and neither P0 nor K8's stand-alone kernels; the frame
   held to its JAX reference as in phase 4.
8. rtiow path - the rtiow_distortion bench frame (192 x 128, 16 spp, 8 path
   components, OpenCV lens, 40 spheres under a constant sky) through K4's
   env class: the regeneration (with the lens's fixed point), K1, K3, the
   env shade (its constant-sky and glass instantiation) and the resolve
   must be launched, and neither K2 (no light, no sky importance: no shadow
   ray), P0 nor K8's stand-alone kernels; the frame held to its JAX
   reference as in phase 4.
9. tof path - the tof_amcw bench frame (96 x 96, 16 spp, 6 path components,
   SensorTofAmcw, the ToF cone light with per-light MIS) at phase 0: K1,
   K2, K3 and K4 (regeneration, shade, resolve) must be launched and P0
   not, and the frame held to its JAX reference (mean energy, the three
   channel means, counters); phases 1-3 keep the counters and the mean
   and phase 2 swaps the buckets a and b; the 4-phase distance at depth 1
   is held to the first-hit distance of the pixel-centre rays (median
   under 2 mm).
10. cornell_animated path - the animated Cornell frame (128 x 128, 16 spp,
   8 path components, SensorRGB, t0 = t1 = 0.5) through render_frame_wavefront
   on K4's diffuse class with the scene's casts: the regeneration, KS1, K3a,
   the diffuse shade (the moving light placed at t = 0.5 in the frame's step
   tables), KS2 and the NEE resolve must be launched, and neither K1, K2,
   K3 nor P0; the frame held to its JAX reference as in phase 4
   (`jax_frame_reference.py cornell_animated`), at most 12 launches per
   step of the loop and 400 per frame.

The Cornell frame (phase 4) and the ToF frame take K4's diffuse class
(regeneration, K1, K3, wpt_shade_diffuse, K2, resolve), the cornell_animated
frame the same class around the sweeps (regeneration, KS1, K3a,
wpt_shade_diffuse, KS2, resolve), the mesh frame K4's
env class (regeneration, K5, K3, wpt_shade_env, K6, resolve), the envmap
and rtiow frames the env class on the brute-force casts (regeneration, K1,
K3, wpt_shade_env, K2 where the sky is importance-sampled, resolve), the
city frame K4's lit class (wpt_regen_surround, K5, K3, wpt_shade_lit, K6 on
2 x 1048576 shadow rays, the resolve of two pending deposits per lane).
The kernels phase holds each K4 kernel against its plain version on the
first block of the seven frames after 2 steps (lanes live, dead and, where
a lane has samples left, due for regeneration) and on the city block as
the frame starts it (at 1 spp the one step where its lanes regenerate: the
surround regeneration is checked and timed there), the env shade also
with the ToF sensor on the mesh, envmap and rtiow blocks, the lit shade
with the ToF sensor on the city block, the regeneration also with the
RADIAL_ONLY and RADIAL_AND_PLANAR lenses on the rtiow block; a
regeneration is timed only on lanes that regenerate. K5 and K6 are also
held against their plain versions (bit-equal) and timed beside their bound
at every cast of the mesh frame (4 steps) and the city frame (2 blocks of 4
steps), on the rays each step gives, with each cast's live lanes
(`utils/cast_steps.py`); the lit shade and the surround regeneration at
every step of the city frame and the regeneration at every step of the
Cornell, mesh and rtiow frames' first block likewise, with their live and
regenerated lanes and their bounds in place and copying
(`utils/k4_steps.py`). The regenerations and the lit shade update the
lane state in place: each check gives every call its own copy of the
inputs, and each time restores them before every call, outside the timed
window (the device's time per call). Every path
prints its frame time, paths/s, Mrays/s, device time and kernel launches
per wavefront step, and apart from them the copies and memsets (one more
frame under torch.profiler; the scene's tables are built once per scene,
before the frames); every path also the launches of one step of the loop
and of the frame's set-up, from the difference to the same frame at 1
path component. Cornell, ToF, envmap and rtiow fail above 12 kernel
launches per step of the frame; the mesh frame (4 steps, so its ~31
launches of set-up alone come to ~8 per step) above 100 per frame,
cornell_animated (the animations' and the moving light's rows, ~180
launches once per frame) above 400; every
frame above 12 per step of the loop (the city's 2 blocks of 4 steps carry
the set-up of two blocks). Each path's counters are set to 0 just before
it and read just after; a kernel's `launches` in the JSON line is the sum
over the paths that use it. The stand-alone K8 and K7 kernels run on no
path (their work runs inside K4's shades), so their records count 0
launches, and so does P0's; their `inline_in` lists the
shade that does their work on a K4 path, the path and its launches there:
the equirect K8 record the env shade on the mesh path and the lit shade on
the city path; the cube and constant K8 records the env shade on the
envmap and rtiow paths; K7's two records and P0's (the material rows) the
lit shade on the city path. Each shade, regeneration and resolve record
counts those of its own paths (the diffuse shade, the pinhole regeneration
and the one-deposit resolve also the cornell_animated path's); the sweeps'
and K3a's records those of the cornell_animated path.

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

K4_PATHS = ("main path", "mesh path", "city path", "envmap path", "rtiow path", "tof path",
            "cornell_animated path")
PATHS = K4_PATHS
# Kernel launches per step of a K4 frame's loop, and per step of the frame
# with its set-up (all but the mesh frame, whose 4 steps carry ~31 launches of
# set-up: it is held to MESH_MAX_FRAME_LAUNCHES instead).
K4_MAX_LAUNCHES_PER_STEP = 12
MESH_MAX_FRAME_LAUNCHES = 100          # kernel launches of one mesh frame
# kernel launches of one cornell_animated frame: 16 steps, the lane state's
# set-up and, once per frame, the animations' rows at the frame's instant
# and the moving light's rows (~180 PyTorch launches)
ANIM_MAX_FRAME_LAUNCHES = 400
PROFILE_TRIES = 10                     # profiles of a frame taken while the profiler loses events
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
    "envmap": ("wurblpt_tpu_torch/csrc/envmap.cu", "wurblpt_tpu/render/envmap.py:166", ENV_ALL,
               PATHS),
    "envmap_cube": ("wurblpt_tpu_torch/csrc/envmap.cu", "wurblpt_tpu/render/envmap.py:118",
                    ENV_ALL, PATHS),
    "envmap_constant": ("wurblpt_tpu_torch/csrc/envmap.cu", "wurblpt_tpu/render/envmap.py:181",
                        ENV_ALL, PATHS),
    "rgl_eval": ("wurblpt_tpu_torch/csrc/rgl.cu", "wurblpt_tpu/materials/rgl.py:633",
                 ("rgl_eval",), PATHS),
    "rgl_sample": ("wurblpt_tpu_torch/csrc/rgl.cu", "wurblpt_tpu/materials/rgl.py:650",
                   ("rgl_sample",), PATHS),
    "row_gather": ("wurblpt_tpu_torch/csrc/row_gather.cu", "tools/probe_pallas_gather.py:20",
                   ("row_gather",), PATHS),
    "regen_pinhole": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:973",
                      ("regen_pinhole",), ("main path", "mesh path", "envmap path", "tof path",
                                           "cornell_animated path")),
    "regen_lens": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/camera.py:140",
                   ("regen_pinhole",), ("rtiow path",)),
    "regen_surround": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/camera.py:244",
                       ("regen_surround",), ("city path",)),
    "shade_diffuse": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:400",
                      ("shade_diffuse",), ("main path", "tof path", "cornell_animated path")),
    "shade_env": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:400",
                  ("shade_env",), ("mesh path",)),
    "shade_env_glass_cube": ("wurblpt_tpu_torch/csrc/wavefront.cu",
                             "wurblpt_tpu/render/integrator.py:400", ("shade_env",),
                             ("envmap path",)),
    "shade_env_glass_constant": ("wurblpt_tpu_torch/csrc/wavefront.cu",
                                 "wurblpt_tpu/render/integrator.py:400", ("shade_env",),
                                 ("rtiow path",)),
    "shade_lit": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:400",
                  ("shade_lit",), ("city path",)),
    "nee_resolve": ("wurblpt_tpu_torch/csrc/wavefront.cu", "wurblpt_tpu/render/integrator.py:648",
                    ("nee_resolve",), tuple(p for p in K4_PATHS if p != "city path")),
    "nee_resolve_lit": ("wurblpt_tpu_torch/csrc/wavefront.cu",
                        "wurblpt_tpu/render/integrator.py:648", ("nee_resolve",), ("city path",)),
    "sweep_closest": ("wurblpt_tpu_torch/csrc/sweep_closest.cu",
                      "wurblpt_tpu/render/intersect.py:216", ("sweep_closest",), PATHS),
    "sweep_any": ("wurblpt_tpu_torch/csrc/sweep_any.cu", "wurblpt_tpu/render/intersect.py:397",
                  ("sweep_any",), PATHS),
    "assemble_hit_anim": ("wurblpt_tpu_torch/csrc/assemble_hit.cu",
                          "wurblpt_tpu/render/intersect.py:510", ("assemble_hit_anim",), PATHS),
}
# The stand-alone kernels whose work a K4 shade does inline: record ->
# (shade, path) pairs. Their records count their own launches (none on any
# path) and list in `inline_in` each shade that does their work, on which
# path, with its launches there.
INLINE = {"envmap": (("shade_env", "mesh path"), ("shade_lit", "city path")),
          "envmap_cube": (("shade_env", "envmap path"),),
          "envmap_constant": (("shade_env", "rtiow path"),),
          "rgl_eval": (("shade_lit", "city path"),), "rgl_sample": (("shade_lit", "city path"),),
          "row_gather": (("shade_lit", "city path"),)}
# The record of each K4 frame's shade, regeneration and resolve, where not
# the kernel's own name (the mesh, Cornell and ToF frames).
K4_RECORDS = {("shade_env", "envmap"): "shade_env_glass_cube",
              ("shade_env", "rtiow"): "shade_env_glass_constant",
              ("regen_pinhole", "rtiow"): "regen_lens",
              ("nee_resolve", "city"): "nee_resolve_lit"}
MAIN_PATH = ("closest_hit", "any_hit", "assemble_hit", "regen_pinhole", "shade_diffuse",
             "nee_resolve")
TOF_PATH = MAIN_PATH
MESH_PATH = ("regen_pinhole", "bvh_closest_hit", "assemble_hit", "shade_env", "bvh_any_hit",
             "nee_resolve")
CITY_PATH = ("regen_surround", "bvh_closest_hit", "assemble_hit", "shade_lit", "bvh_any_hit",
             "nee_resolve")
# The stand-alone kernels whose work the lit shade does inline.
CITY_ABSENT = ("row_gather", "rgl_eval", "rgl_sample") + ENV_ALL
ENVMAP_PATH = ("regen_pinhole", "closest_hit", "assemble_hit", "shade_env", "any_hit",
               "nee_resolve")
RTIOW_PATH = ("regen_pinhole", "closest_hit", "assemble_hit", "shade_env", "nee_resolve")
# The animated frame: K4's diffuse class around the sweeps and K3a; no K1-K3
# (the scene is swept) and no P0 (the shade reads the material rows itself).
ANIM_PATH = ("regen_pinhole", "sweep_closest", "assemble_hit_anim", "shade_diffuse", "sweep_any",
             "nee_resolve")
ANIM_ABSENT = ("closest_hit", "any_hit", "assemble_hit", "row_gather", "shade_env", "shade_lit")
# The K4 kernels that update the lane state in place (render/wavefront.py).
IN_PLACE = ("regen_pinhole", "regen_surround", "shade_lit")


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
    lines = (lib.parent / "build.log").read_text().splitlines()
    entries = [line.split("'")[1] for line in lines if "Compiling entry function" in line]
    try:   # demangled, without the parameter list: "shade_env_kernel<1>"
        names = subprocess.run(["c++filt"], input="\n".join(entries), capture_output=True,
                               text=True, check=True).stdout.splitlines()
        names = dict(zip(entries, (n.split("(anonymous namespace)::", 1)[-1].split("(")[0]
                                   for n in names)))
    except (OSError, subprocess.CalledProcessError):
        names = {}
    entry = ""
    for line in lines:
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line or "spill" in line:
            print(f"  ptxas: {names.get(entry, entry)}:",
                  line.split("ptxas info    :")[-1].strip())


def _timed_records(timed, errs, lanes):
    """name -> (kernel call, plain call, (bytes, flops) of the work, library call or None).
    A kernel that writes its inputs comes as (function, arguments): it is
    timed on the same inputs each call, restored outside the timed window
    (kc.time_restored_ms: the device's time per call)."""
    records = []
    for name, (kernel, plain, work, library) in timed.items():
        ms = (kc.time_restored_ms(*kernel, DEVICE) if isinstance(kernel, tuple)
              else kc.time_ms(kernel, DEVICE))
        plain_ms = kc.time_ms(plain, DEVICE)
        library_ms = None if library is None else kc.time_ms(library, DEVICE)
        bound, bound_by = kc.bound_ms(*work)
        how = "device, inputs restored" if isinstance(kernel, tuple) else "wrapper call"
        print(f"kernels: {name} {ms:.4f} ms ({how}) vs plain {plain_ms:.4f} ms"
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
    # ROADMAP C.1's sphere fields, the K1 form at 6144 and 8192 columns.
    fcam = kc.field_camera_lanes(DEVICE)
    fields = {}
    for n_sph in (3000, 4096):
        f_scene = scenes_on_card[f"sphere_field {n_sph}"]
        f_bs = intersect_brute.build_brute_scene(f_scene)
        assert intersect_brute.brute_eligible(f_scene), f"{n_sph} spheres: not the K1 form's"
        f_shadow = kc.sky_shadow_lanes(
            lambda *r, b=f_bs: intersect_brute.closest_hit_plain(b, *r), fcam)
        fields[n_sph] = (f_bs, intersect.build_hit_tables(f_scene), f_shadow)
    errs = _run_checks((
        ("closest_hit", lambda b, r: kc.check_closest_hit(b, r),
         {"camera": (bs, cam), "random": (bs, rnd), "rtiow camera, spheres only": (rt_bs, rt_cam),
          "envmap camera": (env_bs, env_cam),
          **{f"{k}-sphere field camera": (f[0], fcam) for k, f in fields.items()}}),
        ("any_hit", lambda b, r: kc.check_any_hit(b, r),
         {"shadow": (bs, shadow), "random": (bs, rnd),
          "rtiow camera, spheres only": (rt_bs, rt_cam), "envmap env shadow": (env_bs, env_shadow),
          **{f"{k}-sphere field sky shadow": (f[0], f[2]) for k, f in fields.items()}}),
        ("assemble_hit", lambda b, h, r: kc.check_assemble_hit(b, h, r),
         {"camera": (bs, ht, cam), "random": (bs, ht, rnd),
          "rtiow camera, spheres only": (rt_bs, rt_ht, rt_cam),
          "envmap camera": (env_bs, env_ht, env_cam),
          **{f"{k}-sphere field camera": (f[0], f[1], fcam) for k, f in fields.items()}})))
    sweep_records = _sweep_records(scenes_on_card, fcam, errs)
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
    }, errs, cam[0].shape[0]) + sweep_records

    # K5 and K6 on the mesh frame's block.
    bvh = mesh_scene.bvh
    mcam = kc.mesh_camera_lanes(DEVICE)
    n = mcam[0].shape[0]
    mrnd = kc.terrain_random_lanes(n, DEVICE)
    eshadow = kc.env_shadow_lanes(mesh_scene, mcam)
    dead = mrnd[:3] + (torch.zeros_like(mrnd[3]),)
    ragged = tuple(x[:1000] for x in mrnd)
    errs = _run_checks((
        ("bvh_closest_hit", lambda r: kc.check_bvh_closest_hit(bvh, r),
         {"camera": (mcam,), "random": (mrnd,), "every lane dead": (dead,),
          "1000 lanes": (ragged,)}),
        ("bvh_any_hit", lambda r: kc.check_bvh_any_hit(bvh, r),
         {"env shadow": (eshadow,), "random": (mrnd,), "every lane dead": (dead,),
          "1000 lanes": (ragged,)})))
    records += _timed_records({
        "bvh_closest_hit": (lambda: traverse.bvh_closest_hit(bvh, *mcam),
                            lambda: traverse.bvh_closest_hit_plain(bvh, *mcam),
                            kc.bvh_work(bvh, mcam, any_hit=False), None),
        "bvh_any_hit": (lambda: traverse.bvh_any_hit(bvh, *eshadow),
                        lambda: traverse.bvh_any_hit_plain(bvh, *eshadow),
                        kc.bvh_work(bvh, eshadow, any_hit=True), None),
    }, errs, n)

    # K8's equirect branch on the city frame's block and its night sky (the
    # mesh path's env shade and the city path's lit shade read their skies
    # inline; the stand-alone kernels stay checked here).
    env = city_scene.envmap
    cdirs, cu3 = kc.city_env_lanes(DEVICE)
    nc = cdirs.shape[0]
    errs = _run_checks((
        ("envmap", lambda dirs, uni: kc.check_envmap(env, dirs, uni),
         {"city camera directions, uniforms": (cdirs, cu3)}),))

    def env_all(radiance, sample, pdf, env=env, dirs=cdirs, uni=cu3):
        return lambda: (radiance(env, dirs), sample(env, uni), pdf(env, dirs))

    records += _timed_records({
        "envmap": (env_all(envmap.env_radiance, envmap.env_sample, envmap.env_pdf),
                   env_all(envmap.env_radiance_plain, envmap.env_sample_plain,
                           envmap.env_pdf_plain), kc.envmap_work(env, nc), None),
    }, errs, nc)

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

    # K7 on the city frame's block; P0 on the probe's shapes and the city's
    # material rows (the lit shade evaluates, samples and reads them inline).
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
    return records + _k4_records(scenes_on_card)


def _sweep_records(scenes_on_card, fcam, errs):
    """KS1, KS2 and the hit assembly (K3a animated, K3 static: its error joins
    `errs["assemble_hit"]`) against their plain versions on the
    cornell_animated block, the animated box with spheres and
    tri_sphere_field's camera rays; KS1, KS2 and K3a timed on the
    cornell_animated block."""
    from wurblpt_tpu_torch.render import intersect, intersect_sweep as sw

    sets = {}
    for label, key, rays in (("cornell_animated", "cornell_animated", None),
                             ("animated box with spheres", "cornell_animated spheres", None),
                             ("tri_sphere_field", "tri_sphere_field", fcam)):
        scene = scenes_on_card[key]
        ss, ht = sw.build_sweep_scene(scene), intersect.build_hit_tables(scene)
        fr = kc.frames_at(scene) if scene.n_anims > 1 else None
        if rays is None:
            rays = kc.camera_lanes(kc.BENCH_WIDTH, kc.BENCH_WIDTH, kc.BENCH_LANES_M, DEVICE)
        if fr is None:
            shadow = kc.sky_shadow_lanes(lambda *r, s=ss: sw.closest_sweep_plain(s, *r), rays)
        else:
            shadow = kc.anim_shadow_lanes(scene, ss, fr, rays)
        sets[label] = (ss, ht, fr, rays, shadow)
    cam = sets["cornell_animated"][3]
    rnd = kc.random_lanes(cam[0].shape[0], DEVICE)
    ss, ht, fr, _, shadow = sets["cornell_animated"]
    sets["cornell_animated random"] = (ss, ht, fr, rnd, rnd)
    assemble = lambda v: kc.check_assemble_hit_sweep(v[0], v[1], v[3], v[2])  # noqa: E731
    sweep_errs = _run_checks((
        ("sweep_closest", lambda v: kc.check_sweep_closest(v[0], v[3], v[2]),
         {k: (v,) for k, v in sets.items()}),
        ("sweep_any", lambda v: kc.check_sweep_any(v[0], v[4], v[2]),
         {(k if k.endswith("random") else k + " shadow"): (v,) for k, v in sets.items()}),
        ("assemble_hit_anim", assemble,
         {k: (v,) for k, v in sets.items() if v[2] is not None}),
        ("assemble_hit", assemble, {"tri_sphere_field, the sweep's winners":
                                    (sets["tri_sphere_field"],)})))
    errs["assemble_hit"] = max(errs["assemble_hit"], sweep_errs.pop("assemble_hit"))
    t, prim, u, v = sw.closest_sweep_plain(ss, *cam, fr)
    o, d = cam[0], cam[1]
    return _timed_records({
        "sweep_closest": (lambda: sw.closest_sweep(ss, *cam, fr),
                          lambda: sw.closest_sweep_plain(ss, *cam, fr),
                          kc.sweep_work(ss, cam, fr), None),
        "sweep_any": (lambda: sw.any_sweep(ss, *shadow, fr),
                      lambda: sw.any_sweep_plain(ss, *shadow, fr),
                      kc.sweep_work(ss, shadow, fr, any_hit=True), None),
        "assemble_hit_anim": (lambda: intersect.assemble_hit(ht, o, d, t, prim, u, v, fr),
                              lambda: intersect.assemble_hit_plain(ht, o, d, t, prim, u, v, fr),
                              kc.assemble_hit_work(ht, o.shape[0], fr), None),
    }, sweep_errs, o.shape[0])


def _k4_records(scenes_on_card):
    """K4's kernels against their plain versions on the first block after 2
    steps of the Cornell, cornell_animated, ToF, mesh, envmap, rtiow and city
    frames, and on
    the city block as the frame starts it (at 1 spp only that step
    regenerates, every lane); the env shade also seen by the ToF sensor on
    the mesh, envmap and rtiow blocks (its other instantiations), the lit
    shade by the ToF sensor on the city block, the regeneration also through
    the RADIAL_ONLY and RADIAL_AND_PLANAR lenses on the rtiow block. Timed:
    the regeneration and the resolve on the Cornell block, the regeneration
    through the OpenCV lens on the rtiow block, the surround regeneration on
    the fresh city block, the lit shade and the resolve of two pending
    deposits on the city block after 2 steps, each other shade on its
    frames' blocks; a regeneration is timed only where lanes regenerate.
    Then K5 and K6 at every cast of the mesh and city frames."""
    from wurblpt_tpu_torch.render import wavefront as wf
    from wurblpt_tpu_torch.render.camera import CameraConfig, DistortionModel
    from wurblpt_tpu_torch.render.sensor import SensorTofAmcw

    tof, rgb = SensorTofAmcw(), None
    cases = [("cornell", "cornell", rgb, None, 2),
             ("cornell_animated", "cornell_animated", rgb, None, 2), ("tof", "tof", rgb, None, 2),
             ("mesh", "mesh", rgb, None, 2), ("mesh, ToF sensor,", "mesh", tof, None, 2),
             ("envmap", "envmap", rgb, None, 2), ("envmap, ToF sensor,", "envmap", tof, None, 2),
             ("rtiow", "rtiow", rgb, None, 2), ("rtiow, ToF sensor,", "rtiow", tof, None, 2),
             ("city", "city", rgb, None, 2), ("city, ToF sensor,", "city", tof, None, 2),
             # 1 spp: only the block's first step regenerates (every lane)
             ("city", "city", rgb, None, 0)]
    cases += [(f"rtiow, lens model {model},", "rtiow", rgb,
               CameraConfig(distortion=model, undistort_iters=kc.RTIOW_CAMERA.undistort_iters), 2)
              for model in (DistortionModel.RADIAL_ONLY, DistortionModel.RADIAL_AND_PLANAR)]
    errs, inputs = {}, {}
    for label, frame, sensor, cfg, steps in cases:
        inp = kc.k4_inputs(DEVICE, frame, steps=steps, scene=scenes_on_card.get(frame),
                           sensor=sensor, cfg=cfg)
        inputs.setdefault((frame, steps), inp)
        res = kc.check_k4(inp)
        torch.cuda.synchronize()
        regenerated = kc.regenerated_lanes(inp)
        for name, fields in res.items():
            print(f"kernels: {name} [{label} block after {steps} steps, "
                  f"{inp.regen[0].active.shape[0]} lanes"
                  f"{f', {regenerated} regenerated' if name.startswith('regen') else ''}] "
                  f"ok {fields}")
            record = K4_RECORDS.get((name, frame), name)
            errs[record] = max([errs.get(record, 0.0)]
                               + [v for v in fields.values() if isinstance(v, float)])
    records = []
    for record, frame, kernel in (("regen_pinhole", ("cornell", 2), "regen_pinhole"),
                                  ("regen_lens", ("rtiow", 2), "regen_pinhole"),
                                  ("regen_surround", ("city", 0), "regen_surround"),
                                  ("shade_diffuse", ("cornell", 2), "shade_diffuse"),
                                  ("shade_env", ("mesh", 2), "shade_env"),
                                  ("shade_env_glass_cube", ("envmap", 2), "shade_env"),
                                  ("shade_env_glass_constant", ("rtiow", 2), "shade_env"),
                                  ("shade_lit", ("city", 2), "shade_lit"),
                                  ("nee_resolve", ("cornell", 2), "nee_resolve"),
                                  ("nee_resolve_lit", ("city", 2), "nee_resolve")):
        inp = inputs[frame]
        if kernel.startswith("regen"):   # a regeneration timed where no lane regenerates is a copy
            assert kc.regenerated_lanes(inp) > 0, f"{record}: no lane to regenerate on {frame}"
        args = {"regen_pinhole": inp.regen, "regen_surround": inp.regen,
                "nee_resolve": inp.resolve}.get(kernel, inp.shade)
        plain = getattr(wf, "regen_plain" if kernel.startswith("regen") else kernel + "_plain")
        fn = getattr(wf, kernel)
        # the in-place kernels on the same inputs each call; the others as they are
        call = ((fn, args) if kernel in IN_PLACE else lambda f=fn, a=args: f(*a))
        records += _timed_records({record: (
            call, lambda f=plain, a=args: f(*a), kc.k4_work(inp, kernel), None)}, errs,
            inp.regen[0].active.shape[0])
    _frame_casts(scenes_on_card)
    _frame_k4_steps(scenes_on_card)
    return records


def _frame_casts(scenes_on_card):
    """K5 and K6 at every cast of the mesh frame (4 steps) and the city frame
    (2 blocks of 4 steps), on the rays each step really gives: each cast held
    against its plain version (bit-equal), its wrapper-call time beside the
    bound of the same work (kc.bvh_work), with its lanes and live lanes."""
    from wurblpt_tpu_torch.utils import cast_steps

    for frame, make in (("mesh", kc.mesh_frame), ("city", kc.city_frame)):
        render = make(DEVICE, scenes_on_card[frame])
        render()
        rows = cast_steps.cast_rows(frame, render, DEVICE)
        for r in rows:
            print(f"kernels: {cast_steps.format_row(r)}, bit-equal to the plain walk")
        for line in cast_steps.summary(rows):
            print(f"kernels: {line}")


def _frame_k4_steps(scenes_on_card):
    """The lit shade and the surround regeneration at every step of the city
    frame (2 blocks of 4 steps), and the regeneration at every step of the
    Cornell, mesh and rtiow frames' first block, on the lanes each step
    really gives (`utils/k4_steps.py`): each call held against its plain
    version (bit-equal), its device time per call on restored inputs beside
    its bounds, in place and copying."""
    from wurblpt_tpu_torch.utils import k4_steps

    for frame in ("city", "cornell", "mesh", "rtiow"):
        rows = k4_steps.frame_rows(frame, DEVICE, scenes_on_card.get(frame))
        for r in rows:
            assert r["max_abs_err"] == 0.0 and r["discrete_differ"] == 0, r
            print(f"kernels: {k4_steps.format_row(r)}, bit-equal to the plain version")
        for line in k4_steps.summary(rows):
            print(f"kernels: {line}")


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
    """(CUDA kernel launches, copies and memsets, wavefront steps, device ms)
    of one frame rendered under torch.profiler; a step is one closest-hit
    cast, the device time the sum over its kernels, copies and memsets. The
    profiler at times loses events, most often on short frames: a profile in
    which it saw another number of the port's kernels than the wrappers
    launched (native.LAUNCHES) is taken again, up to PROFILE_TRIES times; if
    none saw them all, the phase fails rather than gate on an undercount."""
    from torch.profiler import ProfilerActivity, profile

    from wurblpt_tpu_torch import native
    from wurblpt_tpu_torch.utils.profile_frame import OURS

    for _ in range(PROFILE_TRIES):
        native.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            render()
        device = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = sum(e.count for e in device if any(k in e.key for k in OURS))
        if seen == sum(native.LAUNCHES.values()):
            break
        print(f"profiler: saw {seen} of the {sum(native.LAUNCHES.values())} launches of the "
              f"port's kernels; profiling the frame again")
    else:
        raise AssertionError(f"profiler: lost events in all {PROFILE_TRIES} profiles; the "
                             f"frame's launches and device time are not measured")
    copies = sum(e.count for e in device if e.key.startswith(("Memcpy", "Memset")))
    kernels = sum(e.count for e in device) - copies
    device_ms = sum(getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0) for e in device) / 1e3
    return (kernels, copies, native.LAUNCHES["closest_hit"] + native.LAUNCHES["bvh_closest_hit"]
            + native.LAUNCHES["sweep_closest"], device_ms)


def _report(label, stats, times, paths, render, short=None, max_per_step=None,
            max_loop_per_step=None, max_frame=None):
    """Frame time, paths/s, Mrays/s and the kernel launches (and apart from
    them the copies and memsets) of one more frame per step; with `short`,
    the same frame at 1 path component, also the launches of one step of
    the loop, (launches - short's) / (steps - short's), and those of the
    frame's set-up (the lane state), which a step does not repeat. Fails if
    the kernel launches per step of the frame exceed `max_per_step`, those
    per step of the loop `max_loop_per_step`, or those of the frame
    `max_frame`."""
    dt = statistics.median(times)
    n, c, steps, device_ms = _count_launches(render)
    per_step = (f", device time {device_ms:.3f} ms (profiled frame), {n} kernel launches and "
                f"{c} copies/memsets in {steps} steps "
                f"({n / max(steps, 1):.2f} and {c / max(steps, 1):.2f} per step")
    n1 = None
    if short is not None:
        n0, c0, steps0, _ = _count_launches(short)
        n1, c1 = (n - n0) / (steps - steps0), (c - c0) / (steps - steps0)
        per_step += (f"; {n1:.2f} and {c1:.2f} per step of the loop, {n - n1 * steps:.0f} and "
                     f"{c - c1 * steps:.0f} of set-up")
    print(f"{label}: frame {dt * 1e3:.2f} ms (median of 5; all "
          f"{[round(t * 1e3, 2) for t in times]}), {paths / dt:.4g} paths/s, "
          f"{stats[1] / dt / 1e6:.4g} Mrays/s{per_step}) on {_nvidia_smi()}")
    if max_per_step is not None:
        assert n <= max_per_step * steps, (
            f"{label}: {n / steps:.2f} kernel launches per step, more than {max_per_step}")
    if max_loop_per_step is not None:
        assert n1 <= max_loop_per_step, (
            f"{label}: {n1:.2f} kernel launches per step of the loop, more than "
            f"{max_loop_per_step}")
    if max_frame is not None:
        assert n <= max_frame, f"{label}: {n} kernel launches per frame, more than {max_frame}"


def phase_main_path():
    render = kc.bench_frame(DEVICE)
    img, stats, launches, times = _drive("main path", render, MAIN_PATH, ("row_gather",))
    print(f"main path: mean radiance {float(img.double().mean())!r} (reference {kc.REF_MEAN}), "
          f"stats {stats} (reference {list(kc.REF_STATS)})")
    kc.check_bench_frame(img, stats)
    _report("main path", stats, times, kc.BENCH_WIDTH ** 2 * kc.BENCH_SSQRT ** 2, render,
            kc.bench_frame(DEVICE, depth=1), K4_MAX_LAUNCHES_PER_STEP, K4_MAX_LAUNCHES_PER_STEP)
    return launches


def phase_city_path(city_scene):
    render = kc.city_frame(DEVICE, city_scene)
    img, stats, launches, times = _drive("city path", render, CITY_PATH, CITY_ABSENT)
    print(f"city path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.CITY_REF_MEAN}), stats {stats} (reference {list(kc.CITY_REF_STATS)})")
    kc.check_city_frame(img, stats)
    _report("city path", stats, times, kc.CITY_WIDTH * kc.CITY_HEIGHT * kc.CITY_SSQRT ** 2,
            render, kc.city_frame(DEVICE, city_scene, depth=1),
            max_loop_per_step=K4_MAX_LAUNCHES_PER_STEP)
    return launches


def phase_mesh_path(mesh_scene):
    render = kc.mesh_frame(DEVICE, mesh_scene)
    img, stats, launches, times = _drive("mesh path", render, MESH_PATH,
                                         ("row_gather",) + ENV_ALL)
    print(f"mesh path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.MESH_REF_MEAN}), stats {stats} (reference {list(kc.MESH_REF_STATS)})")
    kc.check_mesh_frame(img, stats)
    _report("mesh path", stats, times, kc.MESH_WIDTH * kc.MESH_HEIGHT * kc.MESH_SSQRT ** 2,
            render, kc.mesh_frame(DEVICE, mesh_scene, depth=1),
            max_loop_per_step=K4_MAX_LAUNCHES_PER_STEP, max_frame=MESH_MAX_FRAME_LAUNCHES)
    return launches


def phase_envmap_path(env_scene):
    render = kc.envmap_frame(DEVICE, env_scene)
    img, stats, launches, times = _drive("envmap path", render, ENVMAP_PATH,
                                         ("row_gather",) + ENV_ALL)
    print(f"envmap path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.ENVMAP_REF_MEAN}), stats {stats} "
          f"(reference {list(kc.ENVMAP_REF_STATS)})")
    kc.check_envmap_frame(img, stats)
    _report("envmap path", stats, times, kc.ENVMAP_WIDTH ** 2 * kc.ENVMAP_SSQRT ** 2,
            render, kc.envmap_frame(DEVICE, env_scene, depth=1), K4_MAX_LAUNCHES_PER_STEP,
            K4_MAX_LAUNCHES_PER_STEP)
    return launches


def phase_rtiow_path(rt_scene):
    render = kc.rtiow_frame(DEVICE, rt_scene)
    img, stats, launches, times = _drive("rtiow path", render, RTIOW_PATH,
                                         ("row_gather", "any_hit") + ENV_ALL)
    print(f"rtiow path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.RTIOW_REF_MEAN}), stats {stats} (reference {list(kc.RTIOW_REF_STATS)})")
    kc.check_rtiow_frame(img, stats)
    _report("rtiow path", stats, times, kc.RTIOW_WIDTH * kc.RTIOW_HEIGHT * kc.RTIOW_SSQRT ** 2,
            render, kc.rtiow_frame(DEVICE, rt_scene, depth=1), K4_MAX_LAUNCHES_PER_STEP,
            K4_MAX_LAUNCHES_PER_STEP)
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
            kc.tof_frame(DEVICE, tof_scene, depth=1), K4_MAX_LAUNCHES_PER_STEP,
            K4_MAX_LAUNCHES_PER_STEP)
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


def phase_anim_path(scene):
    render = kc.cornell_animated_frame(DEVICE, scene)
    img, stats, launches, times = _drive("cornell_animated path", render, ANIM_PATH, ANIM_ABSENT)
    print(f"cornell_animated path: mean radiance {float(img.double().mean())!r} "
          f"(reference {kc.ANIM_REF_MEAN}), stats {stats} (reference {list(kc.ANIM_REF_STATS)})")
    kc.check_cornell_animated_frame(img, stats)
    _report("cornell_animated path", stats, times, kc.BENCH_WIDTH ** 2 * kc.BENCH_SSQRT ** 2,
            render, kc.cornell_animated_frame(DEVICE, scene, depth=1),
            max_loop_per_step=K4_MAX_LAUNCHES_PER_STEP, max_frame=ANIM_MAX_FRAME_LAUNCHES)
    return launches


def phase_scenes():
    from wurblpt_tpu_torch.utils import cast_steps, scenes

    out = {}
    for label, build in (("mesh", lambda: scenes.terrain_city(seed=3, device=DEVICE)),
                         ("city", lambda: scenes.city_night(seed=7, device=DEVICE)),
                         ("envmap", lambda: scenes.envmap_spheres(cube=True, device=DEVICE)),
                         ("rtiow", lambda: scenes.rtiow(device=DEVICE)),
                         ("tof", lambda: scenes.tof_box(device=DEVICE)),
                         ("cornell_animated", lambda: scenes.cornell_box_animated(DEVICE)),
                         ("cornell_animated spheres",
                          lambda: scenes.cornell_box_animated(DEVICE, spheres=True)),
                         ("sphere_field 3000", lambda: scenes.sphere_field(3000, device=DEVICE)),
                         ("sphere_field 4096", lambda: scenes.sphere_field(4096, device=DEVICE)),
                         ("tri_sphere_field", lambda: scenes.tri_sphere_field(device=DEVICE))):
        t0 = time.perf_counter()
        scene = build()
        torch.cuda.synchronize()
        bvh = (f"BVH: {cast_steps.tree_summary(scene.bvh)}" if scene.has_bvh else "brute force")
        print(f"scenes: {label} scene built for the GPU in {time.perf_counter() - t0:.2f} s: "
              f"{scene.n_tris} triangles, {scene.n_spheres} spheres, {scene.n_lights} light "
              f"triangles, {bvh}, sky kind {scene.env_kind}, {scene.n_anims} animation rows")
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
                        ("tof path", lambda: phase_tof_path(out["scenes"]["tof"])),
                        ("cornell_animated path",
                         lambda: phase_anim_path(out["scenes"]["cornell_animated"]))):
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
        if r["name"] in INLINE:
            r["inline_in"] = [{"kernel": c, "path": path, "launches": out[path][c]}
                              for c, path in INLINE[r["name"]]]
    print(_nvidia_smi())
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
