"""The NEE resolve folded into the next step's regeneration (K4's block loop,
``render/integrator.py`` `_make_k4_step`, ``render/wavefront.py``
`regen_plain`).

A K4 step used to run regenerate, cast, shade, shadow cast, resolve (the
pending deposits and the loop flag), then read the flag. Now the
regeneration first adds the step before's pending deposits and flags the
loop condition, the host reads it before the casts, and the block ends at a
regeneration that finds no work. These tests render small frames on the CPU
(the wrappers' plain versions) both ways, the earlier order rebuilt here
from the plain versions, and hold the folded loop to it bit for bit: the
image, the cast counters and the loop flag at every step. The diffuse
class (Cornell, two blocks; ToF; cornell_animated), the env class (envmap
with env NEE; rtiow, which casts no shadow ray) and the lit class (the small
city of tests/test_torch_wavefront_city.py, two pending rows per lane).
"""

import pytest
import torch

from test_torch_wavefront_city import H, W, _small_city
from wurblpt_tpu_torch.render import integrator
from wurblpt_tpu_torch.render import wavefront as wf
from wurblpt_tpu_torch.render.intersect import assemble_hit, scene_any_hit, scene_raw_hit
from wurblpt_tpu_torch.render.sensor import SensorTofAmcw
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

K4_STEP = integrator._make_k4_step


def _resolve_last_step(scene, static, tables, sensor, params, cam, cam_cfg, L, anim=None):
    """The K4 step in the order before the fold, from the plain versions:
    regeneration, casts, shade, shadow cast, then nee_resolve_plain's
    deposits and loop flag, read at the end of the step."""
    accel, ht = tables.accel, tables.hit
    frames = None if anim is None else anim.frames
    step_tables = wf.step_tables_at(tables.step, None if anim is None else anim.lights)
    route = wf.k4_route(step_tables, cam_cfg)
    t_min = torch.full((route.shadow_rows * L,), params.min_hit_distance)

    def step(ls, sample, k_next, lanes, carry):
        assert carry is None
        ls, sample, k_next, t_max, _ = wf.regen_plain(ls, sample, k_next, cam, cam_cfg, lanes,
                                                      params.randomize_ray_over_pixel)
        t, prim, u, v = scene_raw_hit(accel, ls.o, ls.d, t_min[:L], t_max, frames)
        hr = assemble_hit(ht, ls.o, ls.d, t, prim, u, v, frames)
        ls, shadow_o, shadow_d, shadow_tmax, pending = route.shade_plain(
            step_tables, sensor, params, ls, lanes.pixel, sample, t, prim, hr)
        occluded = (None if shadow_tmax is None
                    else scene_any_hit(accel, shadow_o, shadow_d, t_min, shadow_tmax, frames))
        acc, work = wf.nee_resolve_plain(ls.acc, pending, occluded, ls.active, k_next, lanes)
        return ls._replace(acc=acc), sample, k_next, None, bool(work.item())

    return step


def _recorded(make_step, calls):
    """`make_step` whose steps append (the carry they were given, the flag
    they return) to `calls`."""
    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recording(ls, sample, k_next, lanes, carry):
            out = step(ls, sample, k_next, lanes, carry)
            calls.append((carry, out[4]))
            return out
        return recording
    return make


FRAMES = {
    # (scene, camera, width, height, ssqrt, depth, extra kc._frame arguments)
    "cornell, two blocks": (lambda: scenes.cornell_box_ref("cpu"), scenes.cornell_ref_camera,
                            16, 16, 2, 8, dict(max_lanes=128)),
    "tof": (lambda: scenes.tof_box(device="cpu"), scenes.tof_camera, 12, 12, 2, 6,
            dict(sensor=SensorTofAmcw())),
    "cornell_animated": (lambda: scenes.cornell_box_animated("cpu"), scenes.cornell_ref_camera,
                         16, 16, 2, 8, dict(t=kc.ANIM_TIME)),
    "envmap": (lambda: scenes.envmap_spheres(cube=True, device="cpu"), scenes.envmap_camera,
               16, 16, 2, 8, {}),
    "rtiow": (lambda: scenes.rtiow(device="cpu"), scenes.rtiow_camera, 16, 12, 2, 8,
              dict(cfg=kc.RTIOW_CAMERA, lens=kc.RTIOW_LENS)),
    "small city, two pending rows": (_small_city, scenes.city_camera, W, H, 1, 4,
                                     dict(cfg=kc.CITY_CAMERA, eye_distance=kc.CITY_EYE_DISTANCE)),
    # a depth-2 path dies at its second step, after its last NEE sample
    "cornell, depth 2": (lambda: scenes.cornell_box_ref("cpu"), scenes.cornell_ref_camera,
                         8, 8, 1, 2, {}),
}


def _both_orders(monkeypatch, frame):
    """(image, counters, [(carry, flag)] per step) of the frame rendered
    with the folded loop, then with the resolve last."""
    make_scene, camera, w, h, ssqrt, depth, extra = FRAMES[frame]
    render = kc._frame(make_scene(), camera("cpu"), w, h, ssqrt, depth, "cpu", **extra)
    out = []
    for make_step in (K4_STEP, _resolve_last_step):
        calls = []
        monkeypatch.setattr(integrator, "_make_k4_step", _recorded(make_step, calls))
        img, stats = render()
        out.append((img, stats, calls))
    return out


@pytest.mark.parametrize("frame", list(FRAMES)[:-1])
def test_folded_loop_renders_the_resolve_last_loop_bit_for_bit(monkeypatch, frame):
    """The same image and cast counters as the loop that resolved at the end
    of each step; the flag after each regeneration is the flag the resolve
    gave at the end of the step before (the block's first step: work), so
    the folded loop runs one regeneration more per block and no cast more."""
    (img, stats, folded), (ref_img, ref_stats, resolved) = _both_orders(monkeypatch, frame)
    assert torch.equal(img.view(torch.int32), ref_img.view(torch.int32))
    assert stats.tolist() == ref_stats.tolist() and stats[0] > 0
    flags, ref_flags = [f for _, f in folded], [f for _, f in resolved]
    blocks = ref_flags.count(False)
    assert blocks == flags.count(False) == (2 if frame == "cornell, two blocks" else 1)
    expect = []
    for f in ref_flags:   # each block: work at its start, then the resolve's flags
        expect += [True, f] if not expect or expect[-1] is False else [f]
    assert flags == expect and len(flags) == len(ref_flags) + blocks
    # the carry: nothing at a block's start, pending deposits where the step casts shadow rays
    starts = [i for i in range(len(folded)) if i == 0 or not folded[i - 1][1]]
    assert all(folded[i][0] is None for i in starts)
    shadow = frame != "rtiow"
    assert all((c is not None) == shadow for i, (c, _) in enumerate(folded) if i not in starts)
    if frame.startswith("small city"):   # the light's rows, then the sky's
        pending, occluded = folded[1][0]
        assert pending.shape[0] == occluded.shape[0] == 2 * W * H


def test_the_last_regeneration_flushes_the_final_deposits(monkeypatch):
    """At depth 2 every path dies at its second step, each lane's last NEE
    sample still pending: the regeneration that ends the block adds the
    unoccluded ones, and the image keeps them (equal to the resolve-last
    loop's, and brighter than the image without that last regeneration's
    deposits)."""
    (img, stats, folded), (ref_img, _, _) = _both_orders(monkeypatch, "cornell, depth 2")
    assert torch.equal(img, ref_img)
    (pending, occluded), flag = folded[-1]
    assert flag is False and len(folded) == 3
    kept = torch.where(occluded[:, None], 0.0, pending)
    assert int((kept > 0).any(1).sum()) > 0.1 * pending.shape[0]
    # the same frame with the last regeneration's deposits dropped
    regen = wf.regen_plain

    def without_final_deposit(st, sample, k_next, cam, cfg, lanes, randomize, pending=None,
                              occluded=None):
        out = regen(st, sample, k_next, cam, cfg, lanes, randomize, pending, occluded)
        return out if bool(out[4]) else regen(st, sample, k_next, cam, cfg, lanes, randomize)

    monkeypatch.setattr(integrator, "_make_k4_step", K4_STEP)
    monkeypatch.setattr(wf, "regen_plain", without_final_deposit)
    make_scene, camera, w, h, ssqrt, depth, extra = FRAMES["cornell, depth 2"]
    dim, _ = kc._frame(make_scene(), camera("cpu"), w, h, ssqrt, depth, "cpu", **extra)()
    assert float(dim.sum()) < float(img.sum())
