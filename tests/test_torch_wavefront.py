"""K4, the diffuse class's wavefront step (render/wavefront.py,
csrc/wavefront.cu): its plain versions against the JAX package's bounce,
the routing, the wrappers' dispatch and input checks, and (marked `cuda`)
each kernel against its plain version on the card.

The JAX comparisons import jax inside the test, so that on a machine with
a GPU and no jax this file runs without the repository's conftest:
    python -m pytest --noconftest tests/test_torch_kernels.py tests/test_torch_wavefront.py
(the JAX tests skip there; here, with jax, they run and the CUDA tests skip).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from wurblpt_tpu_torch import CameraConfig, RenderParams, SceneStatic, native
from wurblpt_tpu_torch.render import integrator
from wurblpt_tpu_torch.render import wavefront as wf
from wurblpt_tpu_torch.render.camera import DistortionModel, SurroundMode
from wurblpt_tpu_torch.render.intersect import assemble_hit, build_hit_tables
from wurblpt_tpu_torch.render.intersect_brute import any_hit, build_brute_scene, closest_hit
from wurblpt_tpu_torch.render.sensor import SensorRGB, SensorTofAmcw
from wurblpt_tpu_torch.scene.ir import MaterialType
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

SMALL = dict(width=16, ssqrt=2, m=2)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return "cuda"


def _split_step(inp):
    """One K4 step on the CPU from the regeneration's inputs: regen_plain
    (with the step before's deposits), K1, K3, shade_diffuse_plain, K2 and
    the step's deposits (nee_resolve_plain's, which the next regeneration
    adds). Returns (the regenerated state, its sample ids, the next state,
    its cast counts)."""
    st, sample, k_next, t_max, _ = wf.regen_plain(*inp.regen)
    tables, sensor, params = inp.shade[:3]
    lanes = inp.regen[5]
    n = st.active.shape[0]
    bs, ht = build_brute_scene(tables.scene), build_hit_tables(tables.scene)
    t_min = torch.full((n,), params.min_hit_distance)
    t, prim, u, v = closest_hit(bs, st.o, st.d, t_min, t_max)
    hr = assemble_hit(ht, st.o, st.d, t, prim, u, v)
    st = st._replace(stats=torch.zeros((2,), dtype=torch.int64))
    new, shadow_o, shadow_d, shadow_tmax, pending = wf.shade_diffuse_plain(
        tables, sensor, params, st, lanes.pixel, sample, t, prim, hr)
    assert shadow_o is hr.position
    occluded = any_hit(bs, shadow_o, shadow_d, t_min, shadow_tmax)
    acc, _ = wf.nee_resolve_plain(new.acc, pending, occluded, new.active, k_next, lanes)
    return st, sample, new._replace(acc=acc), new.stats


@pytest.mark.parametrize("frame", ["cornell", "tof"])
def test_split_step_matches_the_jax_bounce_on_identical_states(frame):
    """States of a 16 x 16 frame with 4 spp (2 sample lanes per pixel) after
    2 steps, regenerated: the port's split step and one JAX bounce on the
    same state give the same discrete outcomes on every lane and floats
    within XLA's FMA contraction (rtol 1e-5, atol 1e-6)."""
    jax = pytest.importorskip("jax")
    with jax.default_device(jax.devices("cpu")[0]):      # XLA's CPU rounding, as in conftest
        _split_step_against_jax(jax, frame)


def _split_step_against_jax(jax, frame):
    from wurblpt_tpu import RenderParams as JRenderParams, SceneStatic as JSceneStatic
    from wurblpt_tpu import SensorRGB as JSensorRGB
    from wurblpt_tpu.render import integrator as jintegrator
    from wurblpt_tpu.render.intersect_mxu import build_mxu_scene
    from wurblpt_tpu.render.sensor import SensorTofAmcw as JSensorTofAmcw
    from wurblpt_tpu.utils import scenes as jscenes

    inp = kc.k4_inputs("cpu", frame, **SMALL)
    st, sample, new, stats = _split_step(inp)
    n = st.active.shape[0]
    assert 0 < int((~inp.regen[0].active).sum()) < n     # lanes due for regeneration
    if frame == "cornell":
        jscene, jsensor = jscenes.cornell_box_ref().build(), JSensorRGB()
    else:
        jscene, jsensor = jscenes.tof_box().build(), JSensorTofAmcw()
    depth = inp.shade[2].max_path_components
    body = jax.jit(jintegrator._make_bounce_fn(
        jscene, JSceneStatic.from_scene(jscene), jsensor, JRenderParams(max_path_components=depth),
        None, build_mxu_scene(jscene), n))
    a = {f: getattr(st, f).numpy() for f in st._fields}
    jnew = body(jintegrator._LoopState(
        bounce=a["bounce"].astype(np.int32), o=a["o"], d=a["d"], time=np.zeros((n,), np.float32),
        ior=a["ior"], throughput=a["throughput"], active=a["active"], acc=a["acc"],
        geom_len=a["geom_len"], opt_len=a["opt_len"], prev_pdf=a["prev_pdf"],
        prev_random=a["prev_random"], prev_light_pdf=a["prev_light_pdf"],
        stats=np.zeros((2,), np.int32)),
        inp.regen[5].pixel.numpy().astype(np.int32), sample.numpy().astype(np.int32))
    jnew = jax.tree_util.tree_map(np.asarray, jnew._asdict())
    for f in ("bounce", "active", "prev_random", "stats"):
        np.testing.assert_array_equal(getattr(new, f).numpy(), jnew[f], err_msg=f)
    for f in ("o", "d", "ior", "throughput", "acc", "geom_len", "opt_len", "prev_pdf",
              "prev_light_pdf"):
        np.testing.assert_allclose(getattr(new, f).numpy(), jnew[f], rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    assert float(new.acc.abs().sum()) > 0 and int(stats[1]) > int(stats[0]) > 0


@pytest.mark.parametrize("frame", ["cornell", "tof"])
def test_k4_route_gives_the_torch_op_bounce_bits(frame, monkeypatch):
    """On the CPU the K4 route (plain versions) and the generic torch-op
    bounce render the same frame bit for bit, and the Cornell and ToF
    frames take the K4 route."""
    if frame == "cornell":
        render = kc._frame(scenes.cornell_box_ref("cpu"), scenes.cornell_ref_camera("cpu"), 24,
                           24, 2, 8, "cpu")
    else:
        render = kc.tof_frame("cpu", depth=6, width=24, ssqrt=2)
    steps = []
    k4_step = integrator._make_k4_step

    def counting(*args):
        step = k4_step(*args)

        def run(*a):
            steps.append(1)
            return step(*a)
        return run

    monkeypatch.setattr(integrator, "_make_k4_step", counting)
    img, stats = render()
    assert len(steps) > 0
    monkeypatch.setattr(integrator, "diffuse_class", lambda *a: False)
    img_g, stats_g = render()
    assert torch.equal(img, img_g) and torch.equal(stats, stats_g)


def test_only_the_diffuse_class_takes_k4():
    """Cornell and ToF, also through a lens, take K4's diffuse class; a
    360-degree camera and the scenes of the env class do not."""
    cpu = "cpu"
    cases = {
        "cornell": (scenes.cornell_box_ref(cpu), CameraConfig(), True),
        "tof": (scenes.tof_box(device=cpu), CameraConfig(), True),
        "cornell, lens": (scenes.cornell_box_ref(cpu),
                          CameraConfig(distortion=DistortionModel.OPENCV), True),
        "cornell, 360": (scenes.cornell_box_ref(cpu), CameraConfig(surround=SurroundMode.S360),
                         False),
        "mesh": (scenes.terrain_city(seed=3, terrain_res=8, n_buildings=2, sphere_slices=4,
                                     device=cpu), CameraConfig(), False),
        "envmap": (scenes.envmap_spheres(cube=True, device=cpu), CameraConfig(), False),
        "rtiow": (scenes.rtiow(device=cpu), CameraConfig(), False),
    }
    for name, (scene, cfg, k4) in cases.items():
        assert wf.diffuse_class(scene, SceneStatic.from_scene(scene), cfg) == k4, name


def test_wrappers_take_the_plain_versions_on_cpu():
    inp = kc.k4_inputs("cpu", "tof", **SMALL)
    counts = dict(native.LAUNCHES)
    res = kc.check_k4(inp)
    assert native.LAUNCHES == counts            # no kernel ran
    for name, fields in res.items():
        assert all(v == 0 for v in fields.values()), (name, fields)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_wrappers_reject_malformed_inputs(bad):
    inp = kc.k4_inputs("cpu", "cornell", **SMALL)
    st, sample, k_next = inp.regen[:3]
    if bad == "dtype":
        st = st._replace(bounce=st.bounce.to(torch.int32))
    elif bad == "shape":
        st = st._replace(o=st.o[:, :2].contiguous())
    else:
        sample = sample.to("meta")
    with pytest.raises(ValueError):
        wf.regen_pinhole(st, sample, k_next, *inp.regen[3:])
    acc, pending, occluded, active, k_next, lanes = inp.resolve
    with pytest.raises(ValueError):
        wf.nee_resolve(acc, pending[:, :2].contiguous(), occluded, active, k_next, lanes)


def test_sensor_params_are_the_float32_factors_of_the_plain_version():
    kind, p = wf.sensor_params(SensorTofAmcw(phase_index=3))
    assert kind == 1 and p[0] == float(np.float32(2 * np.pi))
    assert p[2] == float(np.float32(3 * np.pi / 2)) and p[4] == float(np.float32(144e-12))
    kind, p = wf.sensor_params(SensorRGB(opl_max=2.5))
    assert kind == 0 and p[:4] == [0.0, 2.5, 0.0, float("inf")]
    with pytest.raises(ValueError):
        wf.sensor_params(object())


def test_resolve_flags_work_until_every_sample_is_done():
    inp = kc.k4_inputs("cpu", "cornell", **SMALL)
    acc, pending, occluded, active, k_next, lanes = inp.resolve
    _, work = wf.nee_resolve_plain(acc, pending, occluded, active, k_next, lanes)
    assert work.tolist() == [1]
    done = torch.full_like(k_next, lanes.P)
    _, work = wf.nee_resolve_plain(acc, pending, occluded, torch.zeros_like(active), done, lanes)
    assert work.tolist() == [0]
    out, _ = wf.nee_resolve_plain(acc, pending, torch.ones_like(occluded), active, k_next, lanes)
    assert torch.equal(out, acc + 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", ["cornell", "tof"])
def test_k4_kernels_match_plain(gpu, frame):
    """Each K4 kernel against its plain version on the frame's first block
    after 2 steps: bit-equal on the H100 (every field 0)."""
    inp = kc.k4_inputs(gpu, frame)
    before = {k: native.LAUNCHES[k] for k in ("regen_pinhole", "shade_diffuse", "nee_resolve")}
    res = kc.check_k4(inp)
    torch.cuda.synchronize()
    assert {k: native.LAUNCHES[k] - v for k, v in before.items()} == dict.fromkeys(before, 1)
    for name, fields in res.items():
        assert all(v == 0 for v in fields.values()), (name, fields)


@pytest.mark.cuda
def test_k4_kernels_reject_what_they_do_not_take(gpu):
    inp = kc.k4_inputs(gpu, "cornell", **SMALL)
    with pytest.raises(ValueError):
        wf.regen_pinhole(*inp.regen[:4], CameraConfig(surround=SurroundMode.S360),
                         *inp.regen[5:])
    with pytest.raises(ValueError):
        wf.shade_diffuse(inp.shade[0], SimpleNamespace(n_acc=3), *inp.shade[2:])


@pytest.mark.cuda
def test_tof_render_on_gpu_matches_the_jax_reference_numbers(gpu):
    native.reset_launch_counts()
    img, stats = kc.tof_frame(gpu)()
    kc.check_tof_frame(img, stats)
    for name in ("closest_hit", "any_hit", "assemble_hit_k4", "regen_pinhole", "shade_diffuse"):
        assert native.LAUNCHES[name] > 0, name
    assert native.LAUNCHES["row_gather"] == native.LAUNCHES["nee_resolve"] == 0
    assert kc.tof_distance_check(gpu)["median_abs_err_m"] < kc.TOF_DISTANCE_MEDIAN_MAX


def test_params_reach_the_plain_roulette():
    """Russian roulette from rr_start on: a lower start kills paths earlier."""
    inp = kc.k4_inputs("cpu", "cornell", **SMALL)
    args = list(inp.shade)
    outs = []
    for rr_start in (0, 50):
        args[2] = RenderParams(max_path_components=8, rr_start=rr_start)
        args[3] = args[3]._replace(stats=args[3].stats.clone())
        outs.append(wf.shade_diffuse_plain(*args)[0].active)
    assert int(outs[0].sum()) < int(outs[1].sum())


@pytest.mark.parametrize("frame", ["cornell", "tof"])
def test_k4_bounds_count_what_each_branch_reads(frame):
    """K4's bounds charge each lane what its branch reads: the regeneration
    in place reads every lane's active flag and a dead lane's next sample
    index and writes every lane's t_max and only a regenerated lane's state,
    sample id and next index (the earlier regeneration, which wrote every
    lane's state anew, read the old state on lanes it kept); the shade reads the primitive
    id only on active lanes, the hit record (but the position, which every
    lane's shadow ray starts from), the ray IOR and the previous bsdf
    sample's flag only on hit lanes, and the previous bsdf pdf with the
    geometric normal (per-light MIS, tof) or the previous mixture pdf
    (cornell) only on hit lanes whose last scatter was sampled; the resolve
    reads pending deposits only on unoccluded lanes."""
    inp = kc.k4_inputs("cpu", frame, **SMALL)
    st, _, k_next, _, _, lanes, _, pending, occluded = inp.regen
    n = st.active.shape[0]
    need = int(((~st.active) & (k_next < lanes.P) & lanes.valid).sum())
    assert 0 < need < n
    kept = 8 + 8 + 12 + 12 + 16 + 16 + 4 + 16 + 4 + 4       # sample, bounce .. prev_light_pdf
    written = 8 + 12 + 12 + 16 + 16 + 1 + 4 + 16 + 4 + 1 + 4 + 8 + 8 + 4
    camera = 4 * (2 + 2 + 3 + 4)
    # the step before's deposits: acc and the occlusion flag read on every
    # lane, the deposit on unoccluded ones, acc written where a bit changes
    # (every lane's acc under the copy contract), the loop flag
    n_open = int((~occluded).sum())
    changed = int((wf.deposit_pending(st.acc, pending, occluded).view(torch.int32)
                   != st.acc.view(torch.int32)).sum())
    assert 0 < n_open < n and 0 < changed < 3 * n
    deposit = n * (12 + 1) + 12 * n_open + 4
    assert (kc.k4_work(inp, "regen_pinhole", in_place=False)[0]
            == n * 10 + (n - need) * kept + n * written + camera + deposit + n * 12)
    dead = int((~st.active).sum())
    assert need <= dead
    refill = 8 + 12 + 12 + 16 + 16 + 1 + 4 + 16 + 4 + 1 + 4 + 8 + 8     # state, sample, k_next
    assert (kc.k4_work(inp, "regen_pinhole")[0]
            == n * (1 + 4) + dead * 8 + need * refill + camera + deposit + 4 * changed)
    assert kc.k4_work(inp, "regen_pinhole")[1] == kc.k4_work(inp, "regen_pinhole", False)[1]

    tables, _, _, sst, _, _, _, prim, _ = inp.shade
    hit = (prim >= 0) & sst.active
    weighted = int((hit & sst.prev_random).sum())
    assert 0 < weighted < int(hit.sum()) <= int(sst.active.sum()) <= n
    every = 1 + 8 + 12 + 16 + 12 + 4 + 16 + 8 + 8 + 12
    on_hit = 4 + 16 + 12 + 1 + 4 + 1
    if tables.per_light:
        on_weighted = 4 + 12
        rows = [tables.pick_area]
    else:
        on_weighted = 4 + 4
        rows = []
    rows += [tables.mat, tables.light_tri, tables.light_mat, tables.light_w, tables.alias_prob,
             tables.alias_idx]
    out = 8 + 12 + 12 + 16 + 1 + 12 + 4 + 16 + 4 + 1 + 4 + 12 + 4 + 12
    expect = (n * every + 4 * int(sst.active.sum()) + on_hit * int(hit.sum())
              + 12 * int((~hit).sum()) + on_weighted * weighted + n * out
              + sum(x.numel() * x.element_size() for x in rows) + 16)
    assert kc.k4_work(inp, "shade_diffuse", in_place=False)[0] == expect
    assert (frame == "tof") == tables.per_light

    # In place a lane pays only what its branch reads and changes: a dead
    # lane its flag and primitive id (read side by side), its
    # previous-sample fields and idle shadow row; an
    # escaped one also its deposits and bounce index, read and written; a
    # hit its state, hit record and pixel and sample id (Lambertian), its
    # shadow ray and new direction and throughput only where it is RANDOM.
    hr = inp.shade[8]
    args = list(inp.shade)
    args[3] = sst._replace(stats=sst.stats.clone())
    random = wf.shade_diffuse_plain(*args)[0].prev_random
    lamb = hit & (tables.scene.materials.typ[hr.mat.long()] == MaterialType.LAMBERTIAN)
    dead, escaped = ~sst.active, sst.active & (prim < 0)
    assert 0 < int(random.sum())
    if frame == "cornell":          # the closed ToF box keeps every lane active here
        assert int(dead.sum()) > 0 and int(escaped.sum()) > 0
    flags, idle = 4 + 1 + 4, 4 + 12                 # prev_pdf, prev_random, prev_light_pdf
    hit_read = 8 + 4 + 12 + 12 + 12 + 12 + 16 + 16 + 1 + 4 + 4 + 16 + 1
    hit_written = 12 + 8 + 12 + 16 + 4 + 1 + flags
    count = lambda m: int(m.sum())  # noqa: E731
    expect = (n * (1 + 4) + count(dead) * (flags + idle)
              + count(escaped) * (2 * (12 + 8) + 1 + flags + idle)
              + count(hit) * (hit_read + hit_written) + on_weighted * weighted + 16 * count(lamb)
              + count(random) * (12 + 16 + 12 + 4 + 12) + count(hit & ~random) * idle
              + sum(x.numel() * x.element_size() for x in rows) + 16)
    flops = 150.0 * count(hit) + 100.0 * count(random)
    if not tables.per_light:
        flops += 140.0 * tables.n_lights * count(random)
    assert kc.k4_work(inp, "shade_diffuse") == (expect, flops)
    assert expect < kc.k4_work(inp, "shade_diffuse", in_place=False)[0]

    acc, pending, occluded, active, _, _ = inp.resolve
    expect = n * (12 + 1 + 1) + 12 * int((~occluded).sum()) + 8 * int((~active).sum()) + n * 12 + 4
    assert kc.k4_work(inp, "nee_resolve")[0] == expect


def test_prepared_tables_render_the_frame_of_the_unprepared_scene():
    """A frame rendered with the scene's tables built once (prepare_scene) is
    bit-equal to one that builds them itself, on both routes: the ToF frame
    on K4, rtiow through a 360-degree camera on the torch-op bounce."""
    from wurblpt_tpu_torch import render_frame_wavefront
    from wurblpt_tpu_torch.render.camera import make_camera

    for scene, camera, cfg in (
            (scenes.tof_box(device="cpu"), scenes.tof_camera("cpu"), CameraConfig()),
            (scenes.rtiow(device="cpu"), scenes.rtiow_camera("cpu"),
             CameraConfig(surround=SurroundMode.S360))):
        static = SceneStatic.from_scene(scene)
        tables = integrator.prepare_scene(scene, static)
        assert (tables.step is not None) == (wf.diffuse_scene(scene, static)
                                             or wf.env_scene(scene, static))
        cam = make_camera(camera[0], camera[1], 16, 16, device="cpu")
        sensor = SensorTofAmcw() if wf.diffuse_scene(scene, static) else SensorRGB()
        args = (scene, static, cam, cfg, sensor, 16, 16, 2,
                RenderParams(max_path_components=3))
        a = integrator.render_frame_wavefront(*args, return_stats=True, device="cpu")
        b = render_frame_wavefront(*args, return_stats=True, device="cpu", tables=tables)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
