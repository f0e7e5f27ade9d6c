"""K5 and K6 at every cast of the mesh and city frames, on the rays each step
really gives: the time of each cast on the card beside its bound.

    python -m wurblpt_tpu_torch.utils.cast_steps [--out FILE]

Renders each frame once (`kernel_check.mesh_frame`, `city_frame`) with the
inputs of every `bvh_closest_hit` and `bvh_any_hit` call recorded, then, per
recorded cast: the kernel held against its plain version on it
(`kernel_check.check_bvh_closest_hit` / `check_bvh_any_hit`), its lanes and
live lanes (t_max > t_min), the wrapper call's time by CUDA events around
20 back-to-back calls after warm-up (the card stays busy, so this is the
device time per call), and its bound (`kernel_check.bvh_work` on the same
rays: the walk's work counted by the plain version), with the bytes and
flops it rests on. `chip_smoke.py` runs the same rows; the command line
prints them (and with `--out` writes them as JSON) with the tree's size,
and uses nothing but `kernel_check`'s frames, checks, timer and work count,
so a copy of this file also times an older tree's kernels on the same
frames. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from ..accel import traverse
from . import kernel_check as kc
from . import scenes

CASTS = ("bvh_closest_hit", "bvh_any_hit")


def record_casts(render):
    """[(kernel name, bvh, (o, d, t_min, t_max))] of every K5/K6 call made
    by one call of `render`, the rays copied as they were passed."""
    casts = []
    saved = {name: getattr(traverse, name) for name in CASTS}

    def recorder(name):
        def call(bvh, o, d, t_min, t_max):
            casts.append((name, bvh, tuple(x.clone() for x in (o, d, t_min, t_max))))
            return saved[name](bvh, o, d, t_min, t_max)
        return call

    try:
        for name in CASTS:
            setattr(traverse, name, recorder(name))
        render()
    finally:
        for name, fn in saved.items():
            setattr(traverse, name, fn)
    return casts


def cast_rows(frame: str, render, device, n: int = 20):
    """One row per K5/K6 call of one frame, each cast first held against its
    plain version: step, lanes, live lanes, ms per call, bound ms, what
    bounds it, and the bytes and flops of the bound."""
    rows, step = [], {name: 0 for name in CASTS}
    for name, bvh, rays in record_casts(render):
        getattr(kc, f"check_{name}")(bvh, rays)
        fn = getattr(traverse, name)
        ms = kc.time_ms(lambda f=fn, b=bvh, r=rays: f(b, *r), device, n)
        work = kc.bvh_work(bvh, rays, any_hit=name == "bvh_any_hit")
        bound, bound_by = kc.bound_ms(*work)
        rows.append({"frame": frame, "kernel": name, "step": step[name],
                     "lanes": int(rays[0].shape[0]), "live": int((rays[3] > rays[2]).sum()),
                     "ms": ms, "bound_ms": bound, "bound_by": bound_by,
                     "bytes": float(work[0]), "flops": float(work[1])})
        step[name] += 1
    return rows


def tree_summary(bvh) -> str:
    size = sum(x.numel() * x.element_size() for x in bvh if isinstance(x, torch.Tensor))
    parts = [f"{bvh.nodes.shape[0]} nodes of {bvh.nodes.shape[1] * bvh.nodes.element_size()} B",
             f"{bvh.tri_v.shape[0]} leaf triangles of "
             f"{bvh.tri_v.shape[1] * bvh.tri_v.element_size()} B",
             f"depth {bvh.depth}", f"{size / 2**20:.2f} MiB of tables"]
    return ", ".join(parts)


def format_row(r) -> str:
    return (f"{r['frame']} {r['kernel']} step {r['step']}: {r['lanes']} lanes, {r['live']} live, "
            f"{r['ms']:.4f} ms per call, bound {r['bound_ms']:.6f} ms by {r['bound_by']} "
            f"({r['ms'] / r['bound_ms']:.1f}x; {r['bytes']:.6g} bytes, {r['flops']:.6g} flops)")


def summary(rows):
    """One line per kernel over one frame's rows: casts, ms, bound ms."""
    out = []
    for name in CASTS:
        sel = [r for r in rows if r["kernel"] == name]
        if sel:
            out.append(f"{sel[0]['frame']} {name}: {len(sel)} casts, "
                       f"{sum(r['ms'] for r in sel):.4f} ms in all, mean "
                       f"{sum(r['ms'] for r in sel) / len(sel):.4f} ms, bounds "
                       f"{sum(r['bound_ms'] for r in sel):.6f} ms in all")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cast_steps: no CUDA device", file=sys.stderr)
        return 2
    device = "cuda"
    build = {"mesh": (lambda: scenes.terrain_city(seed=3, device=device), kc.mesh_frame),
             "city": (lambda: scenes.city_night(seed=7, device=device), kc.city_frame)}
    rows = []
    for frame in ("mesh", "city"):
        make_scene, make_frame = build[frame]
        scene = make_scene()
        print(f"{frame}: {tree_summary(scene.bvh)}")
        render = make_frame(device, scene)
        render()   # warm-up
        frame_rows = cast_rows(frame, render, device)
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
