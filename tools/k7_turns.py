"""Device time per launch of K7 (the measured RGL BRDF's stand-alone eval
and sample, ``csrc/rgl.cu``) and of K4's lit shade, for comparing two
versions of the port in turns on one card: each call times the
``wurblpt_tpu_torch`` of the tree it is given.

    python tools/k7_turns.py --tree DIR [--label NAME]

DIR is the root of a checkout whose ``wurblpt_tpu_torch`` is timed (its
kernels built from its own sources into its own ``_build``). Timed, each on
the tree's own kernels and on the inputs its own path hands them:

* material_comparison at the app's size (``kernel_check.EXAMPLE_FRAMES``:
  the generic bounce, passes of 8 samples): the frame's digest of its
  image and stats (``kernel_check.frame_digest``), its mean and its ms
  (median of 5); a profiled pass's device ms and K7's part of it; each of
  K7's calls in one pass (``kernel_check.capture_rgl_calls``) timed again
  on its own inputs beside its RGL lanes (the ids >= 0 that the tree's
  ``_lane_frame`` saw) and the bound of their work (``rgl_work``: every
  lane's id read and outputs written, inputs, tables and arithmetic for the
  RGL lanes);
* the RGL quad at the grad phase's size (``grad_check.rgl_table_loss`` at
  ``RGL_QUAD_WIDTH``², ``RGL_QUAD_SSQRT``² spp in one pass): one
  step's forward and whole step (forward and backward of d(mean)/d(rgb
  scale)) profiled, their device ms and K7's part; each of K7's calls in
  one forward timed again as above (the first bounce: every lane sees the
  quad);
* K7 on the city's 1048576 lanes (``kernel_check.city_rgl_lanes``: every
  lane live) and on ``wide_rgl_lanes`` (262144 lanes at ids -1, 0 and 1 of
  two synthetic materials with 128 x 128 and 33 x 33 vndf tables, from
  numpy seed 31; a tree before the skip computes the ids -1 at material 0);
* the lit shade (``render.wavefront.shade_lit``) on the city block after 2
  steps (``kernel_check.k4_inputs``), its inputs restored before each call
  (``kernel_check.time_restored_ms``).

Prints one JSON line: the card, its power limit, each case's device
microseconds a launch (``kernel_check.device_ms``: CUDA events around 20
launches queued behind a spin kernel) and its bound in microseconds
(``kernel_check.bound_ms``). The tree's own ``kernel_check`` helpers are
used where it has them; the copies below serve trees that predate them.
Needs a CUDA device."""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
import time


def rgl_work(tables, n: int, sample: bool, live: int):
    """kernel_check.rgl_work with its `live` lanes, for a tree whose count
    takes none."""
    t_bytes = sum(x.numel() * x.element_size() for x in tables) if live else 0
    if sample:
        return n * (4 + 12 + 16 + 4 + 1) + live * (12 + 8) + t_bytes, live * 900.0
    return n * (4 + 16 + 4) + live * (12 + 12) + t_bytes, live * 450.0


def frame_digest(img, stats) -> str:
    """kernel_check.frame_digest, for a tree without it."""
    import numpy as np
    import torch

    h = hashlib.sha256(img.detach().to("cpu", torch.float32).contiguous().numpy().tobytes())
    h.update(np.asarray([int(x) for x in stats], np.int64).tobytes())
    return h.hexdigest()


def capture_rgl_calls(rgl, render):
    """kernel_check.capture_rgl_calls, for a tree without it."""
    calls = []
    eval_raw, sample_raw = rgl.rgl_eval_raw, rgl.rgl_sample_raw

    def watch(kind, raw):
        def call(tables, mid, wi, x):
            calls.append((kind, tables, mid.clone(), wi.clone(), x.clone()))
            return raw(tables, mid, wi, x)
        return call

    rgl.rgl_eval_raw, rgl.rgl_sample_raw = watch("eval", eval_raw), watch("sample", sample_raw)
    try:
        render()
    finally:
        rgl.rgl_eval_raw, rgl.rgl_sample_raw = eval_raw, sample_raw
    return calls


def wide_rgl_lanes(scenes, rgl, torch, np, device, n: int = 262144, seed: int = 31):
    """kernel_check.wide_rgl_lanes, for a tree without it."""
    rs = np.random.default_rng(seed)

    def fields(k, P, T, hv, hl, hn):
        sp = scenes._smooth_positive
        return dict(phi_i=np.linspace(-np.pi, np.pi, P).astype(np.float32),
                    theta_i=np.linspace(0.0, np.pi / 2, T).astype(np.float32),
                    ndf=sp((hn, hn), seed + 10 * k + 1),
                    sigma=sp((hn, hn), seed + 10 * k + 2, 0.2, 0.4),
                    vndf=sp((P, T, hv, hv), seed + 10 * k + 3),
                    luminance=sp((P, T, hl, hl), seed + 10 * k + 4),
                    rgb=sp((P, T, 3, hl, hl), seed + 10 * k + 5))

    tables = rgl.stack_rgl_tables([rgl.load_rgl_material(fields(0, 2, 3, 128, 128, 32)),
                                   rgl.load_rgl_material(fields(1, 1, 2, 33, 16, 16))], device)
    f32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)  # noqa

    def dirs():
        x = rs.standard_normal((n, 3))
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        x[:, 2] = np.abs(x[:, 2]) * np.where(rs.uniform(size=n) < 0.1, -1.0, 1.0)
        return f32(x)

    mid = torch.as_tensor(rs.choice(np.array([-1, 0, 1], np.int32), n, p=[0.2, 0.4, 0.4]),
                          device=device)
    wi, wo = dirs(), dirs()
    return tables, mid, wi, wo, f32(rs.uniform(size=(n, 2)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k7_turns: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from wurblpt_tpu_torch import native
    from wurblpt_tpu_torch.materials import rgl
    from wurblpt_tpu_torch.render import wavefront as wf
    from wurblpt_tpu_torch.utils import grad_check as gc
    from wurblpt_tpu_torch.utils import kernel_check as kc
    from wurblpt_tpu_torch.utils import scenes

    work = (kc.rgl_work if "live" in inspect.signature(kc.rgl_work).parameters
            else lambda t, n, sample, live: rgl_work(t, n, sample, live))
    digest = getattr(kc, "frame_digest", frame_digest)
    capture = (kc.capture_rgl_calls if hasattr(kc, "capture_rgl_calls")
               else lambda render: capture_rgl_calls(rgl, render))
    wide_lanes = (kc.wide_rgl_lanes if hasattr(kc, "wide_rgl_lanes")
                  else lambda d: wide_rgl_lanes(scenes, rgl, torch, np, d))

    native.build_kernels()
    dev = "cuda"
    us, bound = {}, {}

    def timed(label, fn, w):
        us[label] = kc.device_ms(fn) * 1e3
        bound[label] = kc.bound_ms(*w)[0] * 1e3

    def device_ms(fn):
        """(device ms of one run of fn, K7's part) from the profiler; None
        where the profiler lost the run's events."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev_us = {e.key: (getattr(e, "self_device_time_total", None)
                          or getattr(e, "self_cuda_time_total", 0))
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        if not dev_us:
            return None, None
        return (sum(dev_us.values()) / 1e3,
                sum(v for k, v in dev_us.items() if "rgl_eval" in k or "rgl_sample" in k) / 1e3)

    def time_calls(prefix, calls):
        """Each captured K7 call timed again; its (lanes, RGL lanes) by kind."""
        lanes = {"eval": [], "sample": []}
        for k, (kind, tb, mid, wi, x) in enumerate(calls):
            n, live = mid.shape[0], int((mid >= 0).sum())
            lanes[kind].append(live)
            raw = rgl.rgl_sample_raw if kind == "sample" else rgl.rgl_eval_raw
            timed(f"{prefix} {kind} {k // 2}", lambda r=raw, a=(tb, mid, wi, x): r(*a),
                  work(tb, n, kind == "sample", live))
        return lanes

    # material_comparison: the frame, a profiled pass, and K7's calls of one pass
    name = "material_comparison"
    render = kc.example_frame(name, dev, scenes.material_comparison(device=dev))
    img, stats = render()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        render()
        times.append((time.perf_counter() - t0) * 1e3)
    pass_ms, pass_k7_ms = device_ms(lambda: render(one_pass=True))
    calls = capture(lambda: render(one_pass=True))
    pass_lanes = time_calls(f"{name} pass", calls)

    # the RGL quad at the grad phase's size: one step's forward and the step
    loss = gc.rgl_table_loss(dev, gc.RGL_QUAD_WIDTH, gc.RGL_QUAD_SSQRT)

    def forward():
        return loss(torch.tensor(1.0, device=dev, requires_grad=True))

    def step():
        forward().backward()

    step()
    quad_fwd_ms, quad_fwd_k7_ms = device_ms(forward)
    quad_step_ms, quad_step_k7_ms = device_ms(step)
    quad_calls = capture(forward)
    quad_lanes = time_calls("RGL quad 128^2 forward", quad_calls)

    # the city's lanes (every lane live), the wide tables, the lit shade
    city = scenes.city_night(device=dev)
    c_mid, c_wi, c_wo, c_u2 = kc.city_rgl_lanes(city, dev)
    sets = {"city lanes": (city.rgl, c_mid, c_wi, c_wo, c_u2),
            "wide 128 lanes": wide_lanes(dev)}
    for label, (tb, mid, wi, wo, u2) in sets.items():
        n, live = mid.shape[0], int((mid >= 0).sum())
        timed(f"{label} eval", lambda a=(tb, mid, wi, wo): rgl.rgl_eval(*a),
              work(tb, n, False, live))
        timed(f"{label} sample", lambda a=(tb, mid, wi, u2): rgl.rgl_sample(*a),
              work(tb, n, True, live))
    inp = kc.k4_inputs(dev, "city", steps=2, scene=city)
    us["lit shade city block after 2 steps"] = kc.time_restored_ms(
        wf.shade_lit, inp.shade, dev) * 1e3
    bound["lit shade city block after 2 steps"] = kc.bound_ms(
        *kc.k4_work(inp, "shade_lit"))[0] * 1e3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"tree": args.tree, "label": args.label, "package": native.__file__, "card": smi,
           "material_comparison": {
               "digest": digest(img, stats), "mean": float(img.double().mean()),
               "stats": [int(x) for x in stats.tolist()], "frame_ms": statistics.median(times),
               "frame_ms_all": times, "pass_device_ms": pass_ms, "pass_k7_device_ms": pass_k7_ms,
               "pass_lanes": calls[0][2].shape[0], "rgl_lanes": pass_lanes},
           "rgl_quad_128": {
               "forward_device_ms": quad_fwd_ms, "forward_k7_device_ms": quad_fwd_k7_ms,
               "step_device_ms": quad_step_ms, "step_k7_device_ms": quad_step_k7_ms,
               "lanes": quad_calls[0][2].shape[0], "rgl_lanes": quad_lanes},
           "device_us": us, "bound_us": bound}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
