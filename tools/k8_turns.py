"""Device time of K8 (the sky's stand-alone kernels, ``csrc/envmap.cu``) and
of K8T's sample backward on the lanes the sky-yaw step hands them, for
comparing two versions of the port in turns on one card: each call times
the ``wurblpt_tpu_torch`` of the tree it is given.

    python tools/k8_turns.py --tree DIR [--label NAME]

DIR is the root of a checkout whose ``wurblpt_tpu_torch`` is timed (its
kernels built from its own sources into its own ``_build``). The lanes come
from the tree's ``utils/grad_check.py`` `sky_yaw_lanes` (one step of
`sky_yaw_loss` at 128 x 128, 16 spp, depth 8, recording each bounce's
env_miss and env_nee inputs and K8T's sample backward's); a tree older
than it records the same lanes once this tree's
``wurblpt_tpu_torch/utils/grad_check.py`` is copied over its own (it wraps
only entry points every version of the port has). Timed, each on the
tree's own entry points:

* K8 per bounce, the launches of one bounce summed: a tree with K8's pairs
  (``envmap.env_miss_lanes``) launches `env_miss_raw` on the escaped lanes'
  directions under their mask and `env_nee_raw` on the uniforms under the
  RANDOM lanes' mask (two launches); an older tree `env_radiance_raw` and
  `env_pdf` of every lane's direction, then `env_sample_raw` of every
  lane's uniforms and `env_radiance_raw` of the sampled directions (four
  launches), as its env_miss and env_nee did;
* K8T's sample backward (``backward.env_sample_bwd``) per bounce on the
  recorded uniforms and cotangents, and on `grad_check.env_sample_lanes`
  (262144 uniforms of the turned equirect sky, every lane carrying a random
  cotangent);
* K8's single entry points on the kernels phase's lanes: the city block's
  1048576 camera directions and uniforms on its equirect night sky
  (`kernel_check.city_env_lanes`) and the envmap frame's camera lanes on
  its cube sky, radiance, sample and pdf one call each;
* the yaw step itself, profiled: its forward's and its whole step's device
  ms, CUDA kernel launches and K8's and K8T's kernels among them.

Prints one JSON line: the card, its power limit, each case's device
microseconds (``kernel_check.device_ms``: CUDA events around 20 calls
queued behind a spin kernel) and its bound (``kernel_check.bound_ms`` of
``kernel_check.env_lanes_work`` / ``grad_check.env_sample_bwd_work``, the
lanes in each mask; the tree's own where it has them, else this file's
copies). Needs a CUDA device."""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys


def env_lanes_work(env, n: int, sample: bool, pdf: bool, rad: bool, live=None):
    """kernel_check.env_lanes_work, for a tree without it."""
    masked = live is not None
    live = n if live is None else live
    out = n * ((12 if sample else 0) + (4 if pdf else 0) + (16 if rad else 0))
    tables = 0
    if live:
        if rad:
            tables += (env.const_radiance if env.kind == 3 else env.image).numel() * 4
        if sample or pdf:
            tables += env.pdf_table.numel() * 4
        if sample:
            tables += (env.alias_prob.numel() + env.alias_idx.numel()) * 4
    ops = int(sample) + int(pdf) + int(rad and env.kind != 3)
    reads_x = sample or pdf or env.kind != 3
    return ((n if masked else 0) + out + (live * 12 if reads_x else 0) + tables,
            live * 60.0 * ops)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k8_turns: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from wurblpt_tpu_torch import native
    from wurblpt_tpu_torch.render import backward as bw
    from wurblpt_tpu_torch.render import envmap
    from wurblpt_tpu_torch.utils import grad_check as gc
    from wurblpt_tpu_torch.utils import kernel_check as kc
    from wurblpt_tpu_torch.utils import scenes

    work = getattr(kc, "env_lanes_work", env_lanes_work)
    pairs = hasattr(envmap, "env_miss_lanes")
    native.build_kernels()
    dev = "cuda"
    us, bound = {}, {}

    def timed(label, fn, w):
        us[label] = kc.device_ms(fn) * 1e3
        bound[label] = kc.bound_ms(*w)[0] * 1e3

    yaw = gc.sky_yaw_lanes(dev)
    env = yaw["env"]
    lanes = []
    for b, ((d, esc, act), (u3, rnd), (su, g)) in enumerate(zip(yaw["miss"], yaw["nee"],
                                                                yaw["sample_bwd"])):
        n, n_esc, n_rnd = d.shape[0], int(esc.sum()), int(rnd.sum())
        live = int((g != 0).any(-1).sum())
        lanes.append({"active": int(act.sum()), "escaped": n_esc, "env_nee": n_rnd,
                      "cotangent": live})
        # the bound of the work either tree must do: the lanes each result is read on
        w_miss = work(env, n, False, True, True, n_esc)
        w_nee = work(env, n, True, True, True, n_rnd)
        if pairs:
            def miss(d=d, m=esc):
                return envmap.env_miss_raw(env, d, m)

            def nee(u=u3, m=rnd):
                return envmap.env_nee_raw(env, u, m)
        else:   # an older tree: its bounce's four calls over every lane
            def miss(d=d):
                return envmap.env_radiance_raw(env, d), envmap.env_pdf(env, d)

            def nee(u=u3):
                return envmap.env_radiance_raw(env, envmap.env_sample_raw(env, u)[0])
        timed(f"yaw bounce {b} K8 miss", miss, w_miss)
        timed(f"yaw bounce {b} K8 nee", nee, w_nee)
        timed(f"yaw bounce {b} K8", lambda a=miss, c=nee: (a(), c()),
              tuple(x + y for x, y in zip(w_miss, w_nee)))
        timed(f"yaw bounce {b} K8T sample", lambda u=su, gg=g: bw.env_sample_bwd(env, u, gg),
              gc.env_sample_bwd_work(env, su, g))
    senv, su3, sgd = gc.env_sample_lanes(dev)
    timed("K8T sample env_sample_lanes", lambda: bw.env_sample_bwd(senv, su3, sgd),
          gc.env_sample_bwd_work(senv, su3))

    # the single entry points on the kernels phase's lanes
    city = scenes.city_night(device=dev).envmap
    cdirs, cu3 = kc.city_env_lanes(dev)
    cube = scenes.envmap_spheres(cube=True, device=dev).envmap
    ecam = kc.envmap_camera_lanes(dev)[1]
    eu3 = torch.as_tensor(np.random.default_rng(4).uniform(size=(ecam.shape[0], 3)),
                          dtype=torch.float32, device=dev)
    for label, e, dd, uu in (("city equirect", city, cdirs, cu3),
                             ("envmap cube", cube, ecam, eu3)):
        n = dd.shape[0]
        timed(f"{label} radiance", lambda e=e, dd=dd: envmap.env_radiance(e, dd),
              work(e, n, False, False, True))
        timed(f"{label} sample", lambda e=e, uu=uu: envmap.env_sample(e, uu),
              work(e, n, True, True, False))
        timed(f"{label} pdf", lambda e=e, dd=dd: envmap.env_pdf(e, dd),
              work(e, n, False, True, False))

    # the yaw step, profiled
    loss = gc.sky_yaw_loss(dev)

    def forward():
        return loss(torch.tensor(gc.SKY_YAW, device=dev, requires_grad=True))

    def step():
        forward().backward()

    step()

    def profiled(fn):
        before = dict(native.LAUNCHES)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ours = {k: v - before[k] for k, v in native.LAUNCHES.items() if v != before[k]}
        ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

        def ms(es):
            return sum((getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0)) for e in es) / 1e3

        kern = [e for e in ev if not e.key.startswith(("Memcpy", "Memset"))]
        sky = collections.defaultdict(lambda: [0, 0.0])
        for e in kern:
            m = re.search(r"env_\w+_kernel(<[^>]*>)?", e.key)
            if m:
                sky[m.group(0)][0] += e.count
                sky[m.group(0)][1] += ms([e])
        return {"device_ms": ms(ev), "cuda_launches": sum(e.count for e in kern),
                "port_launches": ours, "k8_k8t": sky}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"tree": args.tree, "label": args.label, "package": native.__file__, "card": smi,
           "pairs": pairs, "yaw_lanes": lanes, "yaw_forward": profiled(forward),
           "yaw_step": profiled(step), "device_us": us, "bound_us": bound}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
