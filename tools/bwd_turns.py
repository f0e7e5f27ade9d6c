"""Device time per launch of the port's backward kernels whose work a later
version must keep, for comparing two versions of the port in turns on one
card: each call times the ``wurblpt_tpu_torch`` of the tree it is given.

    python tools/bwd_turns.py --tree DIR [--label NAME]

DIR is the root of a checkout whose ``wurblpt_tpu_torch`` is timed (its
kernels built from its own sources into its own ``_build``). The inputs come
from the tree's `utils/grad_check.py`; a tree older than `rgl_quad_lanes`,
`scatter_lanes` and `rgl_lanes(stacked=...)` times the same inputs once
this tree's ``wurblpt_tpu_torch/utils/grad_check.py`` is copied over its own
(it calls only wrappers such a tree has). Timed, each with the variant
named:

* K7T's tail and full forms on the sample and the eval lanes of
  `grad_check.rgl_lanes` (131072 random lanes of two synthetic materials:
  the tables in shared memory), on the same lanes over a stack of
  `RGL_STACK_GLOBAL` materials (the tables past it: global atomics), and on
  the lanes the 128 x 128, 16 spp RGL tables step hands it
  (`rgl_quad_lanes`: its first bounce's eval and sample, a render's
  coherent directions and sparse cotangents);
* P0T on the Cornell block's material rows (`cornell_lanes`: 131072 x 23
  words onto 4 rows) and on tables of `SCATTER_ROWS_BLOCK` and
  `SCATTER_ROWS_GLOBAL` rows (`scatter_lanes`: past a copy per warp, and
  past the shared memory);
* K8T on `grad_check.sky_lanes`' 262144 lanes of the equirect, cube and
  constant skies and of the 512 x 1024 procedural sky, without its
  rotation term, and on the equirect and the 512 x 1024 sky with it too (a
  tree whose `env_radiance_bwd` takes no ``rotation`` has only the kernel
  without it);
* K3T on the Cornell block's 131072 winners after 2 bounces
  (`cornell_lanes`), the floor step's 65536 (`floor_lanes`) and
  tri_sphere_field's 131072 camera lanes (`field_lanes`, tables past
  K3T's shared memory);
* K3aT on the animated box with spheres (`anim_lanes`) and the animated
  field (`field_lanes(anim=...)`), each with the rows of one instant and
  per ray.

Prints one JSON line: the card, its power limit, each kernel's device
microseconds a launch (`kernel_check.device_ms`, CUDA events around 20
launches queued behind a spin kernel) and its bound in microseconds by the
tree's `*_work` (`kernel_check.bound_ms`). Needs a CUDA device."""

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
    dev = "cuda"
    tables, mid, wi, wo, u2, g_f = gc.rgl_lanes(dev)
    g_pdf, g_wo = gc.rgl_full_cotangents(mid.shape[0], dev)
    stacked = gc.rgl_lanes(dev, stacked=gc.RGL_STACK_GLOBAL)[0]
    # name -> (call, (bytes, flops) of its work)
    calls = {}

    def rgl_case(label, tb, md, w, x, gf, sample, gp, gw):
        for full in (False, True):
            kw = {"full": True, "g_pdf": gp, "g_wo": gw if sample else None} if full else {}
            calls[f"rgl_bwd {'full' if full else 'tail'}, {label}"] = (
                lambda kw=kw: bw.rgl_bwd(tb, md, w, x, gf, sample, **kw),
                gc.rgl_bwd_work(tb, md.shape[0], sample, full=full, live=gc.rgl_live(
                    gf, gp if full else None, gw if full and sample else None)))

    for label, tb in (("", tables), (f", {gc.RGL_STACK_GLOBAL} stacked", stacked)):
        rgl_case(f"sample{label}", tb, mid, wi, u2, g_f, True, g_pdf, g_wo)
        rgl_case(f"eval{label}", tb, mid, wi, wo, g_f, False, g_pdf, None)
    for kind, (tb, md, w, x, gf, gp, gw) in gc.rgl_quad_lanes(dev).items():
        rgl_case(f"RGL quad 128^2 {kind} lanes", tb, md, w, x, gf, kind == "sample", gp, gw)
    cornell = gc.cornell_lanes(dev)
    for label, (g, idx, rows) in {
            "cornell material rows": (cornell["g_rows"], cornell["mat"],
                                      cornell["mat_table"].shape[0]),
            **{f"table of {r} x 23": gc.scatter_lanes(dev, r)
               for r in (gc.SCATTER_ROWS_BLOCK, gc.SCATTER_ROWS_GLOBAL)}}.items():
        calls[f"row_scatter {label}"] = (lambda g=g, idx=idx, rows=rows: bw.row_scatter(g, idx, rows),
                                         gc.row_scatter_work(g, idx, rows))
    has_rot = "rotation" in inspect.signature(bw.env_radiance_bwd).parameters

    def sky_case(label, env, d, g, rot):
        kw = {"rotation": rot} if has_rot else {}
        calls[label] = (lambda: bw.env_radiance_bwd(env, d, g, **kw),
                        gc.env_radiance_bwd_work(env, d, **kw))

    skies = (("equirect", False, None, (False, True)), ("cube", True, None, (False,)),
             ("constant", False, "constant", (False,)),
             ("equirect 512 x 1024", False, "large", (False, True)))
    for label, cube, kind, rots in skies:
        env, d, g = gc.sky_lanes(dev, cube=cube, kind=kind)[:3]
        for rot in rots if has_rot else (False,):
            sky_case(f"env_radiance_bwd {label}, rotation {rot}", env, d, g, rot)
    keys = ("ht", "o", "d", "t", "prim", "u", "v", "backside")
    hits = {"assemble_hit_bwd cornell block": cornell,
            "assemble_hit_bwd floor step": gc.floor_lanes(dev),
            "assemble_hit_bwd tri_sphere_field": gc.field_lanes(dev)}
    for k in ("one instant", "per ray"):
        hits[f"assemble_hit_anim_bwd animated box, rows of {k}"] = gc.anim_lanes(
            dev, per_ray=k == "per ray")
        hits[f"assemble_hit_anim_bwd animated tri_sphere_field, rows of {k}"] = gc.field_lanes(
            dev, anim=k)
    for name, ln in hits.items():
        fr = ln.get("frames")
        a = [ln[k] for k in keys] + ln["cot"]
        work = gc.assemble_hit_bwd_work(ln) if fr is None else gc.assemble_hit_anim_bwd_work(ln)
        calls[name] = (lambda a=a, f=fr: bw.assemble_hit_bwd(*a, frames=f), work)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"tree": args.tree, "label": args.label, "package": native.__file__, "card": smi,
           "device_us": {k: kc.device_ms(f) * 1e3 for k, (f, _) in calls.items()},
           "bound_us": {k: kc.bound_ms(*w)[0] * 1e3 for k, (_, w) in calls.items()}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
