"""Device time per launch of the port's backward kernels whose work a later
version must keep, for comparing two versions of the port in turns on one
card: each call times the ``wurblpt_tpu_torch`` of the tree it is given.

    python tools/bwd_turns.py --tree DIR [--label NAME]

DIR is the root of a checkout whose ``wurblpt_tpu_torch`` is timed (its
kernels built from its own sources into its own ``_build``). Timed, each
with the variant named: K7T's tail form on the sample and the eval lanes of
`grad_check.rgl_lanes`; K8T without its rotation term on the equirect
sky's `grad_check.sky_lanes` (a tree whose `env_radiance_bwd` takes no
``rotation`` has only that kernel), and with it where the tree has it.
Prints one JSON line: the card, its power limit and each kernel's device
microseconds a launch (`kernel_check.device_ms`, CUDA events around 20
launches queued behind a spin kernel). Needs a CUDA device."""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    import torch

    if not torch.cuda.is_available():
        print("bwd_turns: no CUDA device", file=sys.stderr)
        return 2
    from wurblpt_tpu_torch import native
    from wurblpt_tpu_torch.render import backward as bw
    from wurblpt_tpu_torch.utils import grad_check as gc
    from wurblpt_tpu_torch.utils import kernel_check as kc

    native.build_kernels()
    tables, mid, wi, wo, u2, g_f = gc.rgl_lanes("cuda")
    env, d, g = gc.sky_lanes("cuda", cube=False)[:3]
    calls = {"rgl_bwd tail, sample": lambda: bw.rgl_bwd(tables, mid, wi, u2, g_f, True),
             "rgl_bwd tail, eval": lambda: bw.rgl_bwd(tables, mid, wi, wo, g_f, False)}
    if "rotation" in inspect.signature(bw.env_radiance_bwd).parameters:
        for rot in (False, True):
            calls[f"env_radiance_bwd equirect, rotation {rot}"] = (
                lambda rot=rot: bw.env_radiance_bwd(env, d, g, rotation=rot))
    else:
        calls["env_radiance_bwd equirect, rotation False"] = lambda: bw.env_radiance_bwd(env, d, g)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"tree": args.tree, "label": args.label, "package": native.__file__, "card": smi,
           "device_us": {k: kc.device_ms(f) * 1e3 for k, f in calls.items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
