"""The casts of the frames at every step, on the rays each step really
gives: the time of each cast on the card beside its bound.

    python -m wurblpt_tpu_torch.utils.cast_steps [--frames mesh,city,...] [--out FILE]

Renders each frame once with the inputs of every cast recorded, then, per
recorded cast: the kernel held against its plain version on it, its lanes
and live lanes (t_max > t_min), its time and its bound, with the bytes and
flops it rests on. The frames cast through a BVH (`kernel_check.mesh_frame`,
`city_frame`, `rtiow_bvh_frame`, `cornell_animated_bvh_frame`) record
`bvh_closest_hit` and `bvh_any_hit` (K5/K6; the animations' rows too, where
the frame is animated), checked by `kernel_check.check_bvh_closest_hit` /
`check_bvh_any_hit`, timed as the wrapper call by CUDA events around 20
back-to-back calls after warm-up (the card stays busy, so this is the
device time per call), bounded by `kernel_check.bvh_work`, and shown with
the walk's branch (`traverse.plan`: staged in shared memory or the L2
walk), its object rays and its lengths (`traverse.bvh_walk_counts`: the
mean, 99th percentile and maximum lockstep steps of a live lane, and the
mean of a warp's longest walk, which bounds a launch of one wave). The brute-force
frames (`bench_frame`, `tof_frame`, `envmap_frame`, `rtiow_frame`) record
`closest_hit` and `any_hit` (K1/K2), checked bit for bit
(`check_closest_hit` / `check_any_hit`), timed by their device time per
call (`kernel_check.device_ms`: their wrapper calls take longer on the host
than the kernels on the card), bounded by `closest_hit_work` /
`any_hit_work`; the swept frame (`cornell_animated_frame`) records
`closest_sweep` and `any_sweep` (KS1/KS2, with the frame's animation rows),
checked bit for bit (`check_sweep_closest` / `check_sweep_any`), timed so,
bounded by `sweep_work`. Every frame also records its hit assemblies (K3's
K4 form, K3a's where animated), each checked (`check_assemble_hit_k4`),
timed by its device time per call and bounded by what the launch's data
needs (`kernel_check.assemble_hit_work` with the launch's winners and the
class's field set).
All nine frames by default. `chip_smoke.py` runs the same rows; the
command line prints them (and with `--out` writes them as JSON) with the
tree's size, and uses nothing but `kernel_check`'s frames, checks, timers
and work counts, so a copy of this file also times an older tree's kernels
on the same frames. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from ..accel import traverse
from ..render import integrator, intersect, intersect_brute, intersect_sweep
from . import kernel_check as kc
from . import scenes

CASTS = ("bvh_closest_hit", "bvh_any_hit")
WALK_KEYS = ("steps_mean", "steps_p99", "steps_max", "warp_steps_mean", "object_rays")
BRUTE_CASTS = ("closest_hit", "any_hit")
SWEEP_CASTS = ("closest_sweep", "any_sweep")
ASSEMBLY = ("assemble_hit_k4", "assemble_hit_k4_anim")


FRAMES = ("mesh", "city", "rtiow_bvh", "cornell_animated_bvh")
BRUTE_FRAMES = ("cornell", "tof", "envmap", "rtiow")
SWEEP_FRAMES = ("cornell_animated",)


def record_casts(render, module=traverse, names=CASTS):
    """[(kernel name, accel, (o, d, t_min, t_max), frames)] of every call of
    `module`'s casts `names` (K5/K6 by default; K1/K2 as
    `render.intersect` calls them) made by one call of `render`, the rays
    copied as they were passed."""
    casts = []
    saved = {name: getattr(module, name) for name in names}

    def recorder(name):
        def call(accel, o, d, t_min, t_max, *frames):
            casts.append((name, accel, tuple(x.clone() for x in (o, d, t_min, t_max)),
                          frames[0] if frames else None))
            return saved[name](accel, o, d, t_min, t_max, *frames)
        return call

    try:
        for name in names:
            setattr(module, name, recorder(name))
        render()
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)
    return casts


def _bit_equal(res):
    assert res["differ"] == 0, f"{res['differ']} lanes differ from the plain version"


def cast_rows(frame: str, render, device, n: int = 20):
    """One row per cast of one frame (K5/K6, K1/K2 on a brute-force frame,
    KS1/KS2 on a swept one), each cast first held against its plain version:
    step, lanes, live lanes, ms per call, bound ms, what bounds it, and the
    bytes and flops of the bound."""
    brute, swept = frame in BRUTE_FRAMES, frame in SWEEP_FRAMES
    names = BRUTE_CASTS if brute else SWEEP_CASTS if swept else CASTS
    rows, step = [], {name: 0 for name in names}
    recorded = (record_casts(render, intersect, names) if brute or swept
                else record_casts(render))
    for name, accel, rays, frames in recorded:
        if brute:
            _bit_equal(getattr(kc, f"check_{name}")(accel, rays))
            fn = getattr(intersect_brute, name)
            ms = kc.device_ms(lambda f=fn, b=accel, r=rays: f(b, *r), n)
            work = getattr(kc, f"{name}_work")(accel, rays)
        elif swept:   # the checks hold every lane bit for bit, or raise
            any_hit = name == "any_sweep"
            (kc.check_sweep_any if any_hit else kc.check_sweep_closest)(accel, rays, frames)
            fn = getattr(intersect_sweep, name)
            ms = kc.device_ms(lambda f=fn, s=accel, r=rays, a=frames: f(s, *r, a), n)
            work = kc.sweep_work(accel, rays, frames, any_hit=any_hit)
        else:
            getattr(kc, f"check_{name}")(accel, rays, frames)
            fn = getattr(traverse, name)
            ms = kc.time_ms(lambda f=fn, b=accel, r=rays, a=frames: f(b, *r, a), device, n)
            counts = traverse.bvh_walk_counts(accel, *rays, any_hit=name == "bvh_any_hit",
                                              frames=frames)
            work = kc.bvh_work(accel, rays, any_hit=name == "bvh_any_hit", frames=frames,
                               counts=counts)
        bound, bound_by = kc.bound_ms(*work)
        rows.append({"frame": frame, "kernel": name, "step": step[name],
                     "lanes": int(rays[0].shape[0]), "live": int((rays[3] > rays[2]).sum()),
                     "ms": ms, "bound_ms": bound, "bound_by": bound_by,
                     "bytes": float(work[0]), "flops": float(work[1])})
        if not (brute or swept):   # the walk's lengths and branch
            rows[-1].update({k: counts[k] for k in WALK_KEYS})
            rows[-1]["branch"] = traverse.plan(
                accel, frames, "bvh_any" if name == "bvh_any_hit" else "bvh_closest")[1]
        step[name] += 1
    return rows


def k3_rows(frame: str, render, n: int = 20):
    """One row per hit assembly of one frame (K3's K4 form, K3a's where the
    frame is animated), on the winners each step's cast gives, each first
    held against the plain version (`kernel_check.check_assemble_hit_k4`:
    the class's fields bit-equal on hit lanes, miss lanes untouched): step,
    lanes, hit lanes, device ms per call, and the bound of what the launch's
    data needs, with its bytes and flops."""
    calls, saved = [], integrator.assemble_hit_k4

    def record(ht, o, d, t, prim, u, v, frames, out):
        fields = tuple(f for f in kc.HIT_FIELD_BYTES if getattr(out, f, None) is not None)
        calls.append((ht, tuple(x.clone() for x in (o, d, t, prim, u, v)), frames, fields))
        return saved(ht, o, d, t, prim, u, v, frames, out)

    integrator.assemble_hit_k4 = record
    try:
        render()
    finally:
        integrator.assemble_hit_k4 = saved
    rows = []
    for step, (ht, hit_args, frames, fields) in enumerate(calls):
        kc.check_assemble_hit_k4(ht, hit_args, frames, fields)
        out = intersect.hit_buffers(fields, hit_args[0].shape[0], hit_args[0].device)
        ms = kc.device_ms(lambda h=ht, a=hit_args, f=frames, b=out:
                          intersect.assemble_hit_k4(h, *a, f, b), n)
        work = kc.assemble_hit_work(ht, hit_args[3], frames, fields)
        bound, bound_by = kc.bound_ms(*work)
        rows.append({"frame": frame, "kernel": ASSEMBLY[frames is not None], "step": step,
                     "lanes": int(hit_args[0].shape[0]), "live": int((hit_args[3] >= 0).sum()),
                     "ms": ms, "bound_ms": bound, "bound_by": bound_by, "bytes": float(work[0]),
                     "flops": float(work[1])})
    return rows


def tree_summary(bvh) -> str:
    size = sum(x.numel() * x.element_size() for x in bvh if isinstance(x, torch.Tensor))
    parts = [f"{bvh.nodes.shape[0]} nodes of {bvh.nodes.shape[1] * bvh.nodes.element_size()} B",
             f"{bvh.n_tris} leaf triangles and {bvh.n_spheres} leaf spheres of "
             f"{bvh.prim_v.shape[1] * bvh.prim_v.element_size()} B",
             f"{bvh.n_anims - 1} animations", f"depth {bvh.depth}",
             f"{size / 2**20:.2f} MiB of tables"]
    return ", ".join(parts)


def format_row(r) -> str:
    walk = ""
    if "steps_mean" in r:
        walk = (f"; {r['branch']} walk, steps a lane mean {r['steps_mean']:.2f}, p99 "
                f"{r['steps_p99']:.0f}, max {r['steps_max']}, a warp's longest mean "
                f"{r['warp_steps_mean']:.2f}, object rays {r['object_rays']}")
    return (f"{r['frame']} {r['kernel']} step {r['step']}: {r['lanes']} lanes, {r['live']} "
            f"{'hits' if r['kernel'] in ASSEMBLY else 'live'}, "
            f"{r['ms']:.4f} ms per call, bound {r['bound_ms']:.6f} ms by {r['bound_by']} "
            f"({r['ms'] / r['bound_ms']:.1f}x; {r['bytes']:.6g} bytes, {r['flops']:.6g} flops)"
            f"{walk}")


def summary(rows):
    """One line per kernel over one frame's rows: casts, ms, bound ms."""
    out = []
    for name in CASTS + BRUTE_CASTS + SWEEP_CASTS + ASSEMBLY:
        sel = [r for r in rows if r["kernel"] == name]
        if sel:
            walk = ""
            if "steps_mean" in sel[0]:
                walk = (f"; mean over the casts of a lane's steps "
                        f"{sum(r['steps_mean'] for r in sel) / len(sel):.2f}, of a warp's "
                        f"longest walk {sum(r['warp_steps_mean'] for r in sel) / len(sel):.2f}")
            out.append(f"{sel[0]['frame']} {name}: {len(sel)} casts, "
                       f"{sum(r['ms'] for r in sel):.4f} ms in all, mean "
                       f"{sum(r['ms'] for r in sel) / len(sel):.4f} ms, bounds "
                       f"{sum(r['bound_ms'] for r in sel):.6f} ms in all{walk}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    every = FRAMES + BRUTE_FRAMES + SWEEP_FRAMES
    ap.add_argument("--frames", default=",".join(every),
                    help=f"comma-separated subset of {','.join(every)}")
    ap.add_argument("--out", default=None, help="also write the rows here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cast_steps: no CUDA device", file=sys.stderr)
        return 2
    device = "cuda"
    build = {"mesh": (lambda: scenes.terrain_city(seed=3, device=device), kc.mesh_frame),
             "city": (lambda: scenes.city_night(seed=7, device=device), kc.city_frame),
             "rtiow_bvh": (lambda: scenes.rtiow(n=kc.RTIOW_BVH_N, device=device, use_bvh=True),
                           kc.rtiow_bvh_frame),
             "cornell_animated_bvh": (lambda: scenes.cornell_box_animated(
                 device, spheres=True, use_bvh=True), kc.cornell_animated_bvh_frame),
             "cornell": (lambda: None, lambda dev, _: kc.bench_frame(dev)),
             "tof": (lambda: scenes.tof_box(device=device), kc.tof_frame),
             "envmap": (lambda: scenes.envmap_spheres(cube=True, device=device),
                        kc.envmap_frame),
             "rtiow": (lambda: scenes.rtiow(device=device), kc.rtiow_frame),
             "cornell_animated": (lambda: scenes.cornell_box_animated(device),
                                  kc.cornell_animated_frame)}
    rows = []
    for frame in args.frames.split(","):
        make_scene, make_frame = build[frame]
        scene = make_scene()
        if frame in FRAMES:
            print(f"{frame}: {tree_summary(scene.bvh)}")
        render = make_frame(device, scene)
        render()   # warm-up
        frame_rows = cast_rows(frame, render, device) + k3_rows(frame, render)
        for r in frame_rows:
            print(format_row(r))
        for line in summary(frame_rows):
            print(line)
        rows += frame_rows
        del scene, render
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
