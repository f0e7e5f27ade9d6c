"""Where the time of the port's seven frames goes on the GPU.

    python -m wurblpt_tpu_torch.utils.profile_frame [--frames mesh,city] [--runs N]

For each frame in turn (by default all seven: the Cornell bench frame, the
mesh frame of bench config bvh_100k, the city frame of bench config
city_many_lights, the envmap frame of envmap_cube_is, the rtiow frame of
rtiow_distortion, the ToF frame of tof_amcw at phase 0, the animated
Cornell frame cornell_animated at t = 0.5): renders it once to
warm up, N times (5 by default) unprofiled, once under torch.profiler (CPU
+ CUDA activities), and 3 times
more unprofiled (frames after a profiled one run slower), and prints: the
wavefront steps, the number of kernel launches (and apart from them the
copies and memsets, such as each step's read of the loop condition), the
summed device time of all kernels and copies, the
profiled frame's wall time and the median unprofiled one, the device's busy
share of each (kernels run on one stream, so they do not overlap; the
profiler adds host time, hardly any device time), the device time of the
hand-written kernels in all and per launch, the device time per kernel
name, and the host ops by launch count.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .. import native
from .kernel_check import (
    bench_frame,
    city_frame,
    cornell_animated_frame,
    envmap_frame,
    mesh_frame,
    rtiow_frame,
    tof_frame,
)

# The hand-written kernels, by the names the profiler's keys contain.
OURS = ("closest_hit_kernel", "any_hit_kernel", "assemble_hit_kernel", "bvh_closest_kernel",
        "bvh_any_kernel", "env_radiance_kernel", "env_sample_kernel", "env_pdf_kernel",
        "rgl_eval_kernel", "rgl_sample_kernel", "row_gather_kernel", "regen_kernel",
        "shade_kernel", "shade_env_kernel", "shade_lit_kernel", "resolve_kernel",
        "sweep_closest_kernel", "sweep_any_kernel")
_TOP = 25


def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def _wall_ms(frame):
    t0 = time.perf_counter()
    frame()
    return (time.perf_counter() - t0) * 1e3


def profile_one(name, frame, step_counter, runs: int = 5):
    """Profile one frame function (see the module docstring)."""
    print(f"== {name}")
    frame()
    # Unprofiled frames first: frames after a profiled one run slower.
    plain = [_wall_ms(frame) for _ in range(runs)]
    plain_ms = statistics.median(plain)
    native.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = _wall_ms(frame)
    steps = native.LAUNCHES[step_counter]
    after = [_wall_ms(frame) for _ in range(3)]

    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3
    copies = sum(e.count for e in kernels if e.key.startswith(("Memcpy", "Memset")))
    launches = sum(e.count for e in kernels) - copies
    print(f"{steps} wavefront steps, {launches} kernel launches "
          f"({launches / max(steps, 1):.1f} per step) and {copies} copies and memsets "
          f"({copies / max(steps, 1):.1f} per step), "
          f"device time {dev_ms:.3f} ms")
    print(f"profiled frame {wall_ms:.2f} ms wall: busy share {dev_ms / wall_ms:.3f}")
    print(f"unprofiled frame {plain_ms:.2f} ms wall (median of {runs}: "
          f"{[round(t, 2) for t in plain]}): busy share {dev_ms / plain_ms:.3f}, "
          f"idle share {1 - dev_ms / plain_ms:.3f}; after profiling "
          f"{[round(t, 2) for t in after]} ms")
    for e in sorted(kernels, key=lambda e: e.key):
        if any(k in e.key for k in OURS):
            ms = _device_us(e) / 1e3
            print(f"  hand-written {e.key[:60]}: {ms:.3f} ms in {e.count} launches, "
                  f"{ms / e.count * 1e3:.2f} us each ({ms / plain_ms:.4f} of the frame)")
    print(f"device time by kernel (top {_TOP}):")
    for e in sorted(kernels, key=_device_us, reverse=True)[:_TOP]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:100]}")
    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")]
    print(f"host ops by calls (top {_TOP}):")
    for e in sorted(ops, key=lambda e: e.count, reverse=True)[:_TOP]:
        print(f"  {e.count:7d} calls  {e.self_cpu_time_total / 1e3:9.3f} ms self  {e.key}")


FRAMES = {
    "cornell": ("cornell bench frame", bench_frame, "closest_hit"),
    "mesh": ("mesh frame (bvh_100k)", mesh_frame, "bvh_closest_hit"),
    "city": ("city frame (city_many_lights)", city_frame, "bvh_closest_hit"),
    "envmap": ("envmap frame (envmap_cube_is)", envmap_frame, "closest_hit"),
    "rtiow": ("rtiow frame (rtiow_distortion)", rtiow_frame, "closest_hit"),
    "tof": ("tof frame (tof_amcw, phase 0)", tof_frame, "closest_hit"),
    "cornell_animated": ("animated cornell frame (t = 0.5)", cornell_animated_frame,
                         "sweep_closest"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", default=",".join(FRAMES),
                    help=f"comma-separated, of {', '.join(FRAMES)}")
    ap.add_argument("--runs", type=int, default=5, help="unprofiled frames timed per frame")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: needs a CUDA device")
    for key in args.frames.split(","):
        name, make, step_counter = FRAMES[key]
        profile_one(name, make("cuda"), step_counter, args.runs)


if __name__ == "__main__":
    main()
