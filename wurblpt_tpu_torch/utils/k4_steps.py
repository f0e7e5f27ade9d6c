"""K4's regenerations and shades at every step of the frames, on the lanes
each step really gives: the time of each call on the card beside its
bounds.

    python -m wurblpt_tpu_torch.utils.k4_steps [--frames city,cornell,...] [--out FILE]

Renders each frame once (`kernel_check.city_frame`, `bench_frame`,
`tof_frame`, `mesh_frame`, `envmap_frame`, `rtiow_frame`,
`cornell_animated_frame`, `cornell_animated_bvh_frame`,
`rtiow_bvh_frame`; all nine by default) with the inputs of its K4 calls
recorded: on the city every `shade_lit` and `regen_surround` call (2
blocks of 4 steps), on the other frames every `regen_pinhole` call and
every `shade_diffuse` or `shade_env` call of the first block. A
regeneration first adds the step before's pending NEE deposits (the
resolve, folded in), so each is timed with them, and each block ends with
one that only adds the last step's deposits and finds no work. Each input
is copied as it was passed (the kernels write their inputs: the in-place
contract of render/wavefront.py). Then, per recorded
call: the kernel held against its plain version on it
(`kernel_check.check_call`: bit-equal on the card), its lanes, live lanes
(active at the shade) and regenerated lanes, its time
(`kernel_check.time_restored_ms`: the inputs restored before each of 20
calls, outside the timed window, each call timed on the device by its own
CUDA events), and its bounds under the in-place contract and under the
earlier one, in which every lane's state was written anew
(`kernel_check.k4_work`), with the bytes and flops they rest on.
`chip_smoke.py` runs the same rows. The command line uses nothing but
`kernel_check`'s frames, checks, timer and work counts, so a copy of this
file and of kernel_check.py also times an older tree's kernels on the same
frames. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from ..render import wavefront as wf
from . import kernel_check as kc
from . import scenes

RECORDED = ("regen_pinhole", "regen_surround", "shade_diffuse", "shade_env", "shade_lit")
SHADES = ("shade_diffuse", "shade_env", "shade_lit")
FRAMES = {"city": (lambda dev: scenes.city_night(seed=7, device=dev), kc.city_frame),
          "cornell": (lambda dev: None, lambda dev, scene: kc.bench_frame(dev)),
          "tof": (lambda dev: scenes.tof_box(device=dev), kc.tof_frame),
          "mesh": (lambda dev: scenes.terrain_city(seed=3, device=dev), kc.mesh_frame),
          "envmap": (lambda dev: scenes.envmap_spheres(cube=True, device=dev), kc.envmap_frame),
          "rtiow": (lambda dev: scenes.rtiow(device=dev), kc.rtiow_frame),
          "cornell_animated": (lambda dev: scenes.cornell_box_animated(dev),
                               kc.cornell_animated_frame),
          "cornell_animated_bvh": (lambda dev: scenes.cornell_box_animated(
              dev, spheres=True, use_bvh=True), kc.cornell_animated_bvh_frame),
          "rtiow_bvh": (lambda dev: scenes.rtiow(n=kc.RTIOW_BVH_N, device=dev, use_bvh=True),
                        kc.rtiow_bvh_frame)}


def record_k4(render, first_block_only: bool = False):
    """[(kernel name, its arguments)] of every regeneration and shade call
    made by one call of `render` (with `first_block_only`, those of the
    frame's first block: a shade belongs to the block of the regeneration
    before it), the lane state copied as it was passed."""
    calls = []
    saved = {name: getattr(wf, name) for name in RECORDED}
    block = [0]

    def recorder(name):
        def call(*args):
            if name.startswith("regen"):
                block[0] = args[5].blk
            if not (first_block_only and block[0] > 0):
                calls.append((name, kc.fresh_args(args)))
            return saved[name](*args)
        return call

    try:
        for name in RECORDED:
            setattr(wf, name, recorder(name))
        render()
    finally:
        for name, fn in saved.items():
            setattr(wf, name, fn)
    return calls


def k4_rows(frame: str, render, device, n: int = 20, first_block_only: bool = False):
    """One row per recorded call of one frame, each call first held against
    its plain version: kernel, step, lanes, live lanes (active at the
    shade), regenerated lanes, ms per call, the bound ms under the in-place
    contract and under the copy contract, what bounds them, and their bytes
    and flops."""
    rows, step = [], dict.fromkeys(RECORDED, 0)
    for name, args in record_k4(render, first_block_only):
        fn = getattr(wf, name)
        shade = name in SHADES
        plain = getattr(wf, f"{name}_plain") if shade else wf.regen_plain
        res = kc.check_call(fn, plain, args, cast_rows=shade)
        err = max([0.0] + [v for v in res.values() if isinstance(v, float)])
        discrete = sum(v for v in res.values() if isinstance(v, int))
        ms = kc.time_restored_ms(fn, args, device, n)
        inputs = kc.K4Inputs(None if shade else args, args if shade else None, None)
        st = args[3] if shade else args[0]
        row = {"frame": frame, "kernel": name, "step": step[name], "lanes": int(st.active.shape[0]),
               "live": int(st.active.sum()) if shade else None,
               "regenerated": None if shade else kc.regenerated_lanes(inputs),
               "pending_rows": (None if shade or args[7] is None
                                else args[7].shape[0] // st.active.shape[0]),
               "ms": ms, "max_abs_err": err, "discrete_differ": discrete}
        for contract, in_place in (("", True), ("copy_", False)):
            work = kc.k4_work(inputs, name, in_place=in_place)
            bound, bound_by = kc.bound_ms(*work)
            row.update({f"{contract}bound_ms": bound, f"{contract}bound_by": bound_by,
                        f"{contract}bytes": float(work[0]), f"{contract}flops": float(work[1])})
        if not shade:   # the stand-alone resolve's bound on the step it ends (none at a start)
            start = not bool(st.active.any()) and not bool(args[2].any())
            resolve = kc.K4Inputs(None, None, (st.acc, args[7], args[8], st.active, args[2],
                                               args[5]))
            row["resolve_bound_ms"] = (None if start
                                       else kc.bound_ms(*kc.k4_work(resolve, "nee_resolve"))[0])
        rows.append(row)
        step[name] += 1
    return rows


def format_row(r) -> str:
    lanes = (f"{r['live']} live" if r["live"] is not None else
             f"{r['regenerated']} regenerated, {r['pending_rows'] or 0} pending rows per lane")
    return (f"{r['frame']} {r['kernel']} step {r['step']}: {r['lanes']} lanes, {lanes}, "
            f"{r['ms']:.4f} ms per call (max abs err {r['max_abs_err']}, "
            f"{r['discrete_differ']} discrete differences), bound {r['bound_ms']:.6f} ms by "
            f"{r['bound_by']} ({r['bytes']:.6g} bytes, {r['flops']:.6g} flops; copy contract "
            f"{r['copy_bound_ms']:.6f} ms by {r['copy_bound_by']}, {r['copy_bytes']:.6g} bytes)")


def summary(rows):
    """One line per frame and kernel: calls, ms, both bounds."""
    out = []
    for frame in dict.fromkeys(r["frame"] for r in rows):
        for name in RECORDED:
            sel = [r for r in rows if r["frame"] == frame and r["kernel"] == name]
            if sel:
                resolves = [r["resolve_bound_ms"] for r in sel
                            if r.get("resolve_bound_ms") is not None]
                out.append(f"{frame} {name}: {len(sel)} calls, "
                           f"{sum(r['ms'] for r in sel):.4f} ms in all, bounds "
                           f"{sum(r['bound_ms'] for r in sel):.6f} ms in place, "
                           f"{sum(r['copy_bound_ms'] for r in sel):.6f} ms copying"
                           + (f"; the stand-alone resolve's bounds over the {len(resolves)} "
                              f"steps it would end {sum(resolves):.6f} ms" if resolves else ""))
    return out


def frame_rows(frame: str, device, scene=None, n: int = 20):
    """The rows of one frame (its scene built here unless given), each call
    timed over `n` calls."""
    make_scene, make_frame = FRAMES[frame]
    render = make_frame(device, make_scene(device) if scene is None else scene)
    render()   # warm-up
    return k4_rows(frame, render, device, n, first_block_only=frame != "city")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", default=",".join(FRAMES), help="comma-separated frames")
    ap.add_argument("--out", default=None, help="also write the rows here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_steps: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for frame in args.frames.split(","):
        frame_rows_ = frame_rows(frame, "cuda")
        for r in frame_rows_:
            print(format_row(r))
        for line in summary(frame_rows_):
            print(line)
        rows += frame_rows_
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
