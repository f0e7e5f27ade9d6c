"""K4's lit class (render/wavefront.py `shade_lit`, `regen_surround`,
csrc/wavefront.cu wpt_shade_lit, wpt_regen_surround): Lambertian, GGX,
mirror, glass, ModPhong and RGL surfaces with triangle lights under
per-light MIS beside an importance-sampled sky, seen by a surround camera,
mono or stereo, or a pinhole; and the resolve of two pending deposits per
lane. Its plain versions against the JAX package's bounce and camera, the
K4 route against the torch-op route, the routing, the wrappers' input
checks and bounds, and (marked `cuda`) the kernels against their plain
versions on the card.

The small city of tests/test_torch_city.py (city_night at a small size:
12 buildings, 12 windows, the RGL sphere, the night sky), 48 x 24 pixels,
360-degree stereo, 1 spp, 4 path components; a variant with every lobe of
the class (its Lambertian materials turned RGL, GGX, glass and mirror by
turns, half its ModPhong materials see-through) for the lobes the city
itself does not reach.

The JAX comparisons import jax inside the test, so that on a machine with
a GPU and no jax this file runs without the repository's conftest:
    python -m pytest --noconftest tests/test_torch_kernels.py tests/test_torch_wavefront*.py
"""

import math

import numpy as np
import pytest
import torch

from wurblpt_tpu_torch import CameraConfig, SceneStatic, native
from wurblpt_tpu_torch.render import integrator
from wurblpt_tpu_torch.render import wavefront as wf
from wurblpt_tpu_torch.render.camera import SurroundMode
from wurblpt_tpu_torch.render.intersect import assemble_hit, scene_any_hit, scene_raw_hit
from wurblpt_tpu_torch.render.sensor import SensorRGB, SensorTofAmcw
from wurblpt_tpu_torch.scene.ir import EnvMapArrays, MaterialType, Spheres
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)

SMALL = dict(terrain_res=24, n_buildings=12, n_windows=12, sphere_slices=6)
W, H = 48, 24
CITY_CFG = kc.CITY_CAMERA


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return "cuda"


def _small_city(device="cpu"):
    return scenes.city_night(seed=7, **SMALL, device=device)


def _mixed_lobes(city):
    """The city with every lobe of the lit class: its Lambertian materials
    turned RGL (the ground among them), GGX (anisotropic), dispersive and
    absorbing glass and mirror by turns, every other ModPhong material half
    see-through (opacity 0.5, index 1.4)."""
    mt = city.materials
    typ, p0, p1, rid = mt.typ.clone(), mt.p0.clone(), mt.p1.clone(), mt.rgl_id.clone()
    dev = typ.device
    for i in range(typ.shape[0]):
        if typ[i] == MaterialType.LAMBERTIAN:
            turn = (i + 1) % 5
            if turn == 0:
                typ[i], rid[i] = MaterialType.RGL, 0
            elif turn == 1:
                typ[i] = MaterialType.GGX
                p0[i] = torch.tensor([0.2, 0.35, 0.0, 0.0], device=dev)
            elif turn == 2:
                typ[i] = MaterialType.GLASS
                p0[i] = torch.tensor([1.45, 1.5, 1.55, 1.5], device=dev)
                p1[i] = torch.tensor([0.3, 0.2, 0.1, 0.2], device=dev)
            elif turn == 3:
                typ[i] = MaterialType.MIRROR
        elif typ[i] == MaterialType.MODPHONG and i % 2 == 0:
            p0[i, 1], p0[i, 3] = 0.5, 1.4
    return city._replace(materials=mt._replace(typ=typ, p0=p0, p1=p1, rgl_id=rid))


def _small_inputs(scene=None, sensor=None, steps=2, ssqrt=1):
    return kc.k4_inputs("cpu", "city", scene=_small_city() if scene is None else scene,
                        width=W, height=H, ssqrt=ssqrt, m=1, steps=steps, sensor=sensor)


def _split_step(inp):
    """One lit-class K4 step on the CPU from the regeneration's inputs:
    regen_plain (with the step before's two deposits per lane), the
    closest-hit cast, K3, shade_lit_plain, one any-hit cast of the light and
    sky shadow rays and their deposits (nee_resolve_plain's, which the next
    regeneration adds). Returns (the regenerated state, its sample ids, the
    next state, its hit record and cast)."""
    st, sample, k_next, t_max, _ = wf.regen_plain(*inp.regen)
    tables, sensor, params = inp.shade[:3]
    lanes = inp.regen[5]
    n = st.active.shape[0]
    prepared = integrator.prepare_scene(tables.scene, SceneStatic.from_scene(tables.scene))
    t_min = torch.full((2 * n,), params.min_hit_distance)
    t, prim, u, v = scene_raw_hit(prepared.accel, st.o, st.d, t_min[:n], t_max)
    hr = assemble_hit(prepared.hit, st.o, st.d, t, prim, u, v)
    st = st._replace(stats=torch.zeros((2,), dtype=torch.int64))
    new, shadow_o, shadow_d, shadow_tmax, pending = wf.shade_lit_plain(
        tables, sensor, params, st, lanes.pixel, sample, t, prim, hr)
    occluded = scene_any_hit(prepared.accel, shadow_o, shadow_d, t_min, shadow_tmax)
    acc, _ = wf.nee_resolve_plain(new.acc, pending, occluded, new.active, k_next, lanes)
    return st, sample, new._replace(acc=acc), hr, prim


@pytest.mark.parametrize("states", ["bounce 0", "bounce 1", "bounce 2", "4 spp, regenerated"])
def test_split_lit_step_matches_the_jax_bounce_on_identical_states(states):
    """States of the small city frame (48 x 24, 360-degree stereo, 1 spp)
    after 0, 1 and 2 steps, and after 2 steps at 4 spp (lanes regenerated),
    carried from the JAX package's build: the port's split lit step
    (regen_plain, K5, K3, shade_lit_plain, one K6 cast of both kinds of
    shadow ray, the two-deposit resolve) and one JAX bounce on the same
    state give the same discrete outcomes (active, bounce index, the
    previous sample's flag) on every lane and the same cast counters; the
    floats agree within rtol 1e-5 / atol 1e-6 on every escaped lane and on
    all but one hit lane in 200 (rounded up), the hit position to rtol 1e-5
    of the addends of o + t d (XLA contracts it into an FMA). The parting
    lanes are the last bits of XLA's and PyTorch's CPU sin, cos, pow and
    atan2 turned up by the cosine sample, ModPhong's pow at a high
    exponent and RGL's quadratic CDF inversion (ROADMAP C.4)."""
    jax = pytest.importorskip("jax")
    from test_torch_wavefront_env import _jax_bounce

    from wurblpt_tpu.utils import scenes as jscenes
    from wurblpt_tpu_torch import scene_from_numpy

    steps, ssqrt = {"bounce 0": (0, 1), "bounce 1": (1, 1), "bounce 2": (2, 1),
                    "4 spp, regenerated": (2, 2)}[states]
    with jax.default_device(jax.devices("cpu")[0]):      # XLA's CPU rounding, as in conftest
        jscene = jscenes.city_night(seed=7, **SMALL).build(use_bvh=True)
        scene = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jscene), "cpu")
        inp = _small_inputs(scene, steps=steps, ssqrt=ssqrt)
        st, sample, new, hr, prim = _split_step(inp)
        jnew = _jax_bounce(jax, jscene, st, inp.regen[5].pixel, sample,
                           inp.shade[2].max_path_components)
    active = st.active.numpy()
    hit = (prim >= 0).numpy() & active
    assert hit.sum() > 0 and (active & ~hit).sum() > 0
    for f in ("bounce", "active", "prev_random", "stats"):
        np.testing.assert_array_equal(getattr(new, f).numpy(), jnew[f], err_msg=f)
    parted = np.zeros_like(active)
    for f in ("d", "ior", "throughput", "acc", "geom_len", "opt_len", "prev_pdf",
              "prev_light_pdf"):
        got, ref = getattr(new, f).numpy(), jnew[f]
        close = np.isclose(got, ref, rtol=1e-5, atol=1e-6)
        parted |= ~(close if close.ndim == 1 else close.all(-1))
    assert not (parted & ~hit).any(), np.nonzero(parted & ~hit)[0][:8]
    assert parted.sum() <= math.ceil(hit.sum() / 200), np.nonzero(parted)[0]
    o0, o_new = st.o.numpy(), new.o.numpy()
    addends = np.abs(o0) + np.abs(jnew["o"] - o0)
    assert (np.abs(o_new - jnew["o"]) <= 1e-5 * addends + 1e-6).all()
    stats = new.stats.numpy()
    assert stats[1] > stats[0] > 0 and (stats[1] - stats[0]) % 2 == 0   # two shadow casts


@pytest.mark.parametrize("name", ["city", "city, ToF sensor", "city, pinhole", "mixed lobes"])
def test_lit_k4_route_gives_the_torch_op_bounce_bits(name, monkeypatch):
    """On the CPU the lit-class K4 route (plain versions) and the generic
    torch-op bounce render the same frame bit for bit, and the frame takes
    the K4 route with the lit shade: the small city through its 360-degree
    stereo camera (with SensorRGB and with the ToF sensor), through a mono
    pinhole, and with every lobe of the class."""
    scene = _mixed_lobes(_small_city()) if name == "mixed lobes" else _small_city()
    cfg = CameraConfig() if name == "city, pinhole" else CITY_CFG
    sensor = SensorTofAmcw() if name.endswith("ToF sensor") else SensorRGB()
    render = kc._frame(scene, scenes.city_camera("cpu"), W, H, 1, 4, "cpu", cfg,
                       kc.CITY_EYE_DISTANCE, sensor=sensor)
    shades = []
    shade_lit = wf.shade_lit

    def counting(*args):
        shades.append(1)
        return shade_lit(*args)

    monkeypatch.setattr(wf, "shade_lit", counting)
    img, stats = render()
    assert len(shades) > 0
    monkeypatch.setattr(integrator, "lit_class", lambda *a: False)
    n_shades = len(shades)
    img_g, stats_g = render()
    assert len(shades) == n_shades
    assert torch.equal(img, img_g) and torch.equal(stats, stats_g)
    assert float(img.mean()) > 0 and int(stats[1]) > int(stats[0]) > 0


@pytest.mark.parametrize("cfg", [CITY_CFG, CameraConfig(surround=SurroundMode.S180)],
                         ids=["360 stereo", "180 mono"])
def test_surround_regen_matches_the_jax_camera(cfg):
    """regen_plain through the surround camera (the city's 360-degree stereo
    one, and a 180-degree mono one) on the small city block after 2 steps
    at 4 spp: the regenerated lanes' rays are the JAX package's camera_rays
    (camera.py:244-262: the equirect direction of each eye's half, the ODS
    eye offset) at the pixel coordinates its regeneration jitters them to,
    to 1e-6 of their size (XLA's FMA contraction in the rotation)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from wurblpt_tpu import CameraConfig as JCameraConfig, make_camera as jmake_camera
    from wurblpt_tpu.core.rng import Salt as JSalt, uniform2 as juniform2
    from wurblpt_tpu.core.transform import from_lookat as jfrom_lookat
    from wurblpt_tpu.render.camera import camera_rays as jcamera_rays
    from wurblpt_tpu_torch.render.camera import camera_from_numpy

    ssqrt = 2
    inp = _small_inputs(ssqrt=ssqrt)
    st, sample, k_next, _, _, lanes = inp.regen[:6]
    need = ((~st.active) & (k_next < lanes.P) & lanes.valid).numpy()
    assert 0 < need.sum() < need.size
    with jax.default_device(jax.devices("cpu")[0]):
        jcam = jmake_camera(transformation=jfrom_lookat((0.0, 3.5, 14.0), (0.0, 1.5, 0.0)),
                            vfov_deg=50.0, width=W, height=H, eye_distance=kc.CITY_EYE_DISTANCE)
        cam = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam), "cpu")
        new, new_sample, _, _, _ = wf.regen_plain(st, sample, k_next, cam, cfg, lanes, True)
        s_new = new_sample.numpy()[need].astype(np.int32)
        uj = np.asarray(juniform2(jnp.asarray(lanes.pixel.numpy()[need].astype(np.int32)),
                                  jnp.asarray(s_new), 0, JSalt.PIXEL_JITTER))
        jx = ((s_new % ssqrt).astype(np.float32) + uj[:, 0]) * np.float32(1.0 / ssqrt)
        jy = ((s_new // ssqrt).astype(np.float32) + uj[:, 1]) * np.float32(1.0 / ssqrt)
        pxy = np.stack([lanes.px.numpy()[need] + jx, lanes.py.numpy()[need] + jy], -1)
        k = pxy.shape[0]
        jo, jd, _ = jcamera_rays(jcam, JCameraConfig(surround=cfg.surround, stereo=cfg.stereo),
                                 jnp.asarray(pxy), W, H, 0.0, 0.0, jnp.zeros((k,)),
                                 jnp.zeros((k, 2)))
    np.testing.assert_allclose(new.o.numpy()[need], np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(new.d.numpy()[need], np.asarray(jd), rtol=0, atol=1e-6)
    origins = new.o.numpy()[need]
    eye = np.linalg.norm(origins - cam.transformation.translation.numpy(), axis=-1)
    if cfg.stereo:                      # each eye on the circle of diameter eye_distance
        np.testing.assert_allclose(eye, 0.5 * kc.CITY_EYE_DISTANCE, rtol=1e-3)
    else:
        assert eye.max() < 1e-6


def test_lit_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors the regeneration, the lit shade and the two-deposit
    resolve run their plain versions: no kernel launches and every field of
    check_k4 0."""
    inp = _small_inputs(ssqrt=2)
    counts = dict(native.LAUNCHES)
    res = kc.check_k4(inp)
    assert native.LAUNCHES == counts            # no kernel ran
    assert set(res) == {"regen_surround", "shade_lit", "nee_resolve"}
    for name, fields in res.items():
        assert all(v == 0 for v in fields.values()), (name, fields)


def test_the_city_block_regenerates_every_lane_on_its_first_step_only():
    """At 1 spp a lane takes one sample: on the block's fresh state every
    lane is due for regeneration, after 2 steps none is (the regeneration
    copies the state). So the surround regeneration is checked and timed on
    the fresh state, where it regenerates."""
    fresh, later = _small_inputs(steps=0), _small_inputs(steps=2)
    assert kc.regenerated_lanes(fresh) == W * H == fresh.regen[0].active.shape[0]
    assert kc.regenerated_lanes(later) == 0
    res = kc.check_k4(fresh)
    assert all(v == 0 for v in res["regen_surround"].values()), res
    assert kc.k4_work(fresh, "regen_surround")[1] == 180.0 * W * H
    # later: no refill, only the step before's deposits (3 adds per open row)
    assert kc.k4_work(later, "regen_surround")[1] == 3.0 * int((~later.regen[8]).sum())


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _rows_equal(a, b, rows):
    return torch.equal(_bits(a)[rows], _bits(b)[rows])


def test_in_place_lit_wrappers_leave_alone_what_the_contract_leaves_alone():
    """On CPU tensors regen_surround and shade_lit keep the kernels' in-place
    contract: they return the tensors they were given, the lanes and fields
    the contract does not write keep their bits, and what they write is the
    plain version's output. The regeneration adds the step before's
    deposits to acc on every lane and leaves every other field of a lane it
    does not refill as it was; the shade changes on a dead lane only the previous
    sample's pdf and flag, on an escaped lane not its origin, direction,
    ray IOR, throughput or path lengths, and on a hit lane that does not
    scatter not its direction, throughput or ray IOR."""
    inp = _small_inputs(ssqrt=2)
    args = kc.fresh_args(inp.regen)
    st, sample, k_next = args[:3]
    before = [x.clone() for x in (*st, sample, k_next)]
    need = (~st.active) & (k_next < args[5].P) & args[5].valid
    assert 0 < int(need.sum()) < need.numel()
    out = wf.regen_surround(*args)
    assert all(a is b for a, b in zip(out[0], st)) and out[1] is sample and out[2] is k_next
    ref = wf.regen_plain(*inp.regen)
    for f, a, b, r in zip((*wf.LoopState._fields, "sample", "k_next"), before,
                          (*st, sample, k_next), (*ref[0], ref[1], ref[2])):
        if f == "acc":
            assert _rows_equal(b, r, torch.ones_like(need)) and not _rows_equal(a, b, ~need)
        elif f != "stats":
            assert _rows_equal(a, b, ~need), f
            assert _rows_equal(b, r, need), f
    assert torch.equal(out[3], ref[3]) and torch.equal(out[4], ref[4])

    inp = _small_inputs(scene=_mixed_lobes(_small_city()), steps=2)
    args = kc.fresh_args(inp.shade)
    st = args[3]
    before = [x.clone() for x in st]
    dead, escaped, hit, _, scatters, _ = kc._shade_lanes(inp)
    kept = hit & ~scatters
    new, *rows = wf.shade_lit(*args)
    assert all(a is b for a, b in zip(new, st))
    ref, *ref_rows = wf.shade_lit_plain(*kc.fresh_args(inp.shade))
    assert int(dead.sum()) > 0 and int(escaped.sum()) > 0 and int(kept.sum()) > 0
    for f, a, b, r in zip(wf.LoopState._fields, before, new, ref):
        if f == "stats":
            continue
        assert torch.equal(_bits(b), _bits(r)), f           # the plain version's state
        if f not in ("prev_pdf", "prev_random"):
            assert _rows_equal(a, b, dead), f
        if f in ("o", "d", "ior", "throughput", "geom_len", "opt_len", "prev_light_pdf"):
            assert _rows_equal(a, b, escaped), f
        if f in ("d", "ior", "throughput"):
            assert _rows_equal(a, b, kept), f
    for got, want in zip(rows, ref_rows):
        assert torch.equal(got, want)


def test_check_k4_leaves_its_inputs_as_they_were():
    """check_k4 gives each in-place call its own copy of the inputs: after
    it the inputs keep their bits, where one call of the wrappers on them
    changes them."""
    inp = _small_inputs(steps=0)
    saved = [x.clone() for x in (*inp.regen[0], *inp.regen[1:3], *inp.shade[3])]
    res = kc.check_k4(inp)
    assert all(v == 0 for fields in res.values() for v in fields.values()), res
    now = (*inp.regen[0], *inp.regen[1:3], *inp.shade[3])
    assert all(torch.equal(a, b) for a, b in zip(saved, now))
    wf.regen_surround(*inp.regen)
    wf.shade_lit(*inp.shade)
    now = (*inp.regen[0], *inp.regen[1:3], *inp.shade[3])
    assert not all(torch.equal(a, b) for a, b in zip(saved, now))


def test_k4_steps_records_and_checks_every_lit_call_of_the_small_city():
    """utils/k4_steps.py on the small city frame (one block of 1152 lanes, 4
    steps): a surround regeneration and a lit shade per step and the
    regeneration that ends the block (it adds the last step's deposits and
    finds no work), each held to its plain version (0 everywhere on the
    CPU, where the wrappers run them), with its lanes, live lanes (active at
    the shade: all at the first step, fewer after) and regenerated lanes
    (all at the first step, none after, at 1 spp), and bounds in place below
    the copying ones."""
    from wurblpt_tpu_torch.utils import k4_steps

    render = kc._frame(_small_city(), scenes.city_camera("cpu"), W, H, 1, 4, "cpu", CITY_CFG,
                       kc.CITY_EYE_DISTANCE)
    rows = k4_steps.k4_rows("city", render, "cpu", n=1)
    assert [(r["kernel"], r["step"]) for r in rows] == [
        (k, s) for s in range(4) for k in ("regen_surround", "shade_lit")] + [
        ("regen_surround", 4)]
    for r in rows:
        assert r["lanes"] == W * H and r["max_abs_err"] == 0.0 and r["discrete_differ"] == 0
        assert r["bound_ms"] <= r["copy_bound_ms"] and r["bytes"] <= r["copy_bytes"]
    shades = [r for r in rows if r["kernel"] == "shade_lit"]
    regens = [r for r in rows if r["kernel"] == "regen_surround"]
    assert shades[0]["live"] == W * H > shades[1]["live"] >= shades[3]["live"] > 0
    assert regens[0]["regenerated"] == W * H and all(r["regenerated"] == 0 for r in regens[1:])
    # a step that refills nothing: its flags, t_max and the deposits of the step before
    assert regens[1]["bytes"] < regens[1]["copy_bytes"] / 5
    assert len(k4_steps.summary(rows)) == 2


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "geom_normal", "tangent",
                                 "mixture MIS", "no light", "no sky", "constant sky",
                                 "no importance", "RGL without tables", "media material",
                                 "light rows"])
def test_shade_lit_rejects_what_the_kernel_does_not_take(bad):
    inp = _small_inputs()
    args = list(inp.shade)
    tables, st, hr = args[0], args[3], args[8]
    env = tables.env
    if bad == "dtype":
        args[3] = st._replace(prev_pdf=st.prev_pdf.double())
    elif bad == "shape":
        args[3] = st._replace(ior=st.ior[:, :3].contiguous())
    elif bad == "device":
        args[4] = args[4].to("meta")
    elif bad in ("geom_normal", "tangent"):
        args[8] = hr._replace(**{bad: getattr(hr, bad)[:-1].contiguous()})
    elif bad == "mixture MIS":
        args[0] = tables._replace(per_light=False)
    elif bad == "no light":
        args[0] = tables._replace(n_lights=0)
    elif bad == "no sky":
        args[0] = tables._replace(env=None)
    elif bad == "constant sky":
        args[0] = tables._replace(env=EnvMapArrays(3, torch.ones((1, 1, 4)), torch.zeros((0, 0)),
                                                   torch.zeros((0,)),
                                                   torch.zeros((0,), dtype=torch.int32),
                                                   env.rotation, torch.ones(4)))
    elif bad == "no importance":
        args[0] = tables._replace(env=env._replace(pdf_table=torch.zeros((0, 0)),
                                                   alias_prob=torch.zeros((0,)),
                                                   alias_idx=torch.zeros((0,), dtype=torch.int32)))
    elif bad == "RGL without tables":
        args[0] = tables._replace(rgl=None)
    elif bad == "media material":
        args[0] = tables._replace(mat_types=tables.mat_types | {MaterialType.PHASE_ISO})
    else:
        args[0] = tables._replace(light_tri=tables.light_tri[:, :6].contiguous())
    with pytest.raises(ValueError):
        wf.shade_lit(*args)


def test_shade_lit_takes_spheres_in_a_bvh_scene():
    """The lit shade's tables of a BVH scene that holds a sphere (the small
    city's, with one sphere added): the wrapper takes them and gives its
    plain version's result on the city block after 2 steps."""
    inp = _small_inputs()
    args = list(inp.shade)
    tables = args[0]
    sphere = Spheres(torch.zeros((1, 3)), torch.ones((1,)), torch.zeros((1,), dtype=torch.int32))
    assert tables.scene.has_bvh and tables.scene.n_spheres == 0
    args[0] = tables._replace(scene=tables.scene._replace(spheres=sphere))
    counts = dict(native.LAUNCHES)
    res = kc.check_call(wf.shade_lit, wf.shade_lit_plain, tuple(args), cast_rows=True)
    assert native.LAUNCHES == counts            # the plain version ran
    assert all(v == 0 for v in res.values()), res


@pytest.mark.parametrize("bad", ["regen dtype", "regen shape", "three pending rows",
                                 "occluded rows", "regen: three pending rows",
                                 "regen: occluded rows", "regen: pending dtype",
                                 "regen: occluded dtype", "regen: pending alone",
                                 "regen: pending not contiguous", "regen: occluded device"])
def test_regen_surround_and_resolve_reject_malformed_inputs(bad):
    inp = _small_inputs()
    if bad.startswith("regen"):
        args = list(inp.regen)
        st, pending, occluded = args[0], args[7], args[8]
        n = st.acc.shape[0]
        assert pending.shape[0] == 2 * n == occluded.shape[0]
        if bad in ("regen dtype", "regen shape"):
            args[0] = (st._replace(bounce=st.bounce.to(torch.int32)) if bad == "regen dtype"
                       else st._replace(o=st.o[:, :2].contiguous()))
        else:
            args[7], args[8] = {
                "three pending rows": (torch.cat([pending, pending[:n]]), occluded),
                "occluded rows": (pending, occluded[:n].contiguous()),
                "pending dtype": (pending.double(), occluded),
                "occluded dtype": (pending, occluded.to(torch.uint8)),
                "pending alone": (pending, None),
                "pending not contiguous": (pending.t().contiguous().t(), occluded),
                "occluded device": (pending, occluded.to("meta")),
            }[bad.split(": ")[1]]
        with pytest.raises(ValueError):
            wf.regen_surround(*args)
        if ":" in bad:   # the pinhole regeneration checks the same rows
            with pytest.raises(ValueError):
                wf.regen_pinhole(*args[:4], kc.RTIOW_CAMERA, *args[5:])
        return
    acc, pending, occluded, active, k_next, lanes = inp.resolve
    assert pending.shape[0] == 2 * acc.shape[0] == occluded.shape[0]
    if bad == "three pending rows":
        pending = torch.cat([pending, pending[:acc.shape[0]]])
    else:
        occluded = occluded[:acc.shape[0]].contiguous()
    with pytest.raises(ValueError):
        wf.nee_resolve(acc, pending, occluded, active, k_next, lanes)


def test_lit_k4_bound_counts_what_the_branch_reads():
    """The lit shade's bound in place charges each lane what its branch
    reads and changes: every lane its active flag; a dead lane its previous
    sample's pdf and flag and its two idle shadow rows (t_max, pending): 38
    B; an active lane its primitive id, bounce index, direction, deposits
    and throughput; an escaped lane its flag and optical path length (the
    pdf where the flag is set) in and its deposits, bounce index, end, flag,
    pdf and idle rows out; a hit lane t, normal, position, ray IOR,
    backside, material, path lengths, flag, pixel and sample id in (the
    pdf, geometric normal and (pick, 1 / area) row where the flag is set,
    the tangent on GGX and RGL hits) and its deposits, bounce index,
    origin, path lengths, end, flag, pdf and mixture pdf out, where it
    scatters also its direction, throughput and ray IOR, on a RANDOM lane
    two shadow rays and two pending deposits, else its idle rows. The bound
    of the earlier lit shade, which wrote every lane's state anew
    (`in_place=False`), charges every lane its state, the sample ids,
    the ray IOR (read and written back) and the hit position (the origin of
    its two shadow rays); the primitive id and the previous sample's flag on
    active lanes; t, normal, backside and material on hit lanes; the origin
    where the ray missed; the previous pdf where the flag is set; the
    geometric normal and the (pick, 1 / area) row on hit lanes with the flag
    (the emitter's MIS weight); the tangent on GGX and RGL hits; two shadow
    rays and two pending deposits out per lane; both charge the material,
    light and sky rows and the RGL tables once. The two-deposit resolve
    charges both occlusion flags of every lane and each unoccluded row's
    deposit; the surround regeneration its camera's pose and eye
    distance."""
    inp = _small_inputs(scene=_mixed_lobes(_small_city()), ssqrt=2)
    tables, _, _, st, _, _, _, prim, hr = inp.shade
    env = tables.env
    n = st.active.shape[0]
    hit = (prim >= 0) & st.active
    typ = tables.scene.materials.typ[hr.mat.long()]
    framed = hit & ((typ == MaterialType.GGX) | (typ == MaterialType.RGL))
    weighted = st.active & st.prev_random
    assert int(framed.sum()) > 0 and int((hit & st.prev_random).sum()) > 0
    every = 1 + 8 + 12 + 16 + 16 + 12 + 4 + 16 + 8 + 8 + 12
    on_hit = 4 + 12 + 1 + 4
    out = 8 + 12 + 12 + 16 + 16 + 1 + 12 + 4 + 16 + 4 + 1 + 4
    shadow = 2 * (12 + 12 + 4 + 12)
    rows = sum(x.numel() * x.element_size() for x in (
        tables.mat, tables.light_tri, tables.light_mat, tables.light_w, tables.alias_prob,
        tables.alias_idx, env.image, env.rotation, env.pdf_table, env.alias_prob,
        env.alias_idx, *tables.rgl))
    expect = (n * every + (4 + 1) * int(st.active.sum()) + on_hit * int(hit.sum())
              + 12 * int((~hit).sum()) + 4 * int(weighted.sum())
              + (12 + 8) * int((hit & st.prev_random).sum()) + 12 * int(framed.sum())
              + n * (out + shadow) + rows + 16)
    n_bytes, flops = kc.k4_work(inp, "shade_lit", in_place=False)
    assert n_bytes == expect
    assert flops >= 330.0 * n + 900.0 * int((hit & (typ == MaterialType.RGL)).sum())

    # in place, by branch; the kinds of scatter from the plain version's bsdf sample
    from wurblpt_tpu_torch.core.rng import Salt, uniform4
    from wurblpt_tpu_torch.render.bsdf import ScatterKind, bsdf_sample, gather_material_rows

    pixel, sample = inp.shade[4], inp.shade[5]
    sr = bsdf_sample(hr, st.d, st.ior, uniform4(pixel, sample, st.bounce, Salt.BSDF),
                     *uniform4(pixel, sample, st.bounce, Salt.BSDF_AUX)[:, :2].T,
                     gather_material_rows(tables.mat, hr.mat), tables.mat_types, rgl=tables.rgl)
    random = hit & (sr.kind == ScatterKind.RANDOM) & (sr.pdf > 0.0)
    cont = random | (hit & (sr.kind == ScatterKind.EXPLICIT))
    escaped = st.active & (prim < 0)
    dead = ~st.active
    count = lambda m: int(m.sum())  # noqa: E731
    assert min(count(escaped), count(random), count(cont & ~random), count(hit & ~cont)) > 0
    idle = 2 * (4 + 12)
    expect = (n * 1 + count(dead) * (4 + 1 + idle)
              + count(st.active) * (4 + 8 + 12 + 12 + 16)
              + count(escaped) * ((1 + 16) + (12 + 8 + 1 + 4 + 1) + idle)
              + 4 * count(escaped & st.prev_random)
              + count(hit) * ((4 + 12 + 12 + 16 + 1 + 4 + 4 + 16 + 1 + 8 + 8)
                              + (12 + 8 + 12 + 16 + 1 + 4 + 4 + 1 + 4))
              + (4 + 12 + 8) * count(hit & st.prev_random) + 12 * count(framed)
              + (12 + 16 + 16) * count(cont) + 2 * (12 + 12 + 4 + 12) * count(random)
              + idle * count(hit & ~random) + rows + 16)
    assert kc.k4_work(inp, "shade_lit") == (expect, kc.k4_work(inp, "shade_lit")[1])
    assert kc.k4_work(inp, "shade_lit")[0] < n_bytes
    # a dead lane costs 38 B
    st_dead = st._replace(active=torch.zeros_like(st.active))
    dead_inp = inp._replace(shade=(*inp.shade[:3], st_dead, *inp.shade[4:]))
    assert kc.k4_work(dead_inp, "shade_lit") == (38 * n + rows + 16, 0.0)
    acc, pending, occluded, active, k_next, _ = inp.resolve
    n_open = int((~occluded).sum())
    assert kc.k4_work(inp, "nee_resolve") == (
        n * (12 + 1) + 2 * n + 12 * n_open + 8 * int((~active).sum()) + 12 * n + 4,
        3.0 * n_open)
    st, _, k_next, _, _, lanes, _, pending, occluded = inp.regen
    n_need = int(((~st.active) & (k_next < lanes.P) & lanes.valid).sum())
    pinhole_bytes = kc.k4_work(inp, "regen_pinhole")[0] - 4 * (2 + 2 + 3 + 4)
    n_open = int((~occluded).sum())      # the step before's deposits: two rows per lane
    assert n_need > 0 and kc.k4_work(inp, "regen_surround") == (
        pinhole_bytes + 4 * (3 + 4 + 3 + 1), 180.0 * n_need + 3.0 * n_open)
    added = wf.deposit_pending(st.acc, pending, occluded)
    changed = int((added.view(torch.int32) != st.acc.view(torch.int32)).sum())
    assert 0 < n_open < 2 * n and 0 < changed < 3 * n
    assert kc.k4_work(inp, "regen_surround")[0] - kc.k4_work(
        inp._replace(regen=(*inp.regen[:7], None, None)), "regen_surround")[0] == (
        n * (12 + 2) + 12 * n_open + 4 * changed)


@pytest.mark.cuda
@pytest.mark.parametrize("sensor", ["rgb", "tof"])
def test_lit_kernels_match_plain_on_the_city_block(gpu, sensor):
    """The surround regeneration, the lit shade (its equirect, RGL
    instantiation) and the two-deposit resolve against their plain versions
    on the city frame's first block after 2 steps (1048576 lanes), seen by
    each sensor the shade is built for: bit-equal on the H100 (every field
    0)."""
    inp = kc.k4_inputs(gpu, "city", sensor=SensorTofAmcw() if sensor == "tof" else None)
    before = {k: native.LAUNCHES[k] for k in ("regen_surround", "shade_lit", "nee_resolve")}
    res = kc.check_k4(inp)
    torch.cuda.synchronize()
    assert {k: native.LAUNCHES[k] - v for k, v in before.items()} == dict.fromkeys(before, 1)
    for name, fields in res.items():
        assert all(v == 0 for v in fields.values()), (name, fields)


@pytest.mark.cuda
def test_surround_regen_kernel_matches_plain_on_the_fresh_city_block(gpu):
    """The surround regeneration against its plain version on the city
    frame's first block as the frame starts it (1048576 lanes, every one
    regenerated through the 360-degree stereo camera): bit-equal on the
    H100."""
    inp = kc.k4_inputs(gpu, "city", steps=0)
    assert kc.regenerated_lanes(inp) == kc.CITY_LANES
    res = kc.check_k4(inp)
    torch.cuda.synchronize()
    for name, fields in res.items():
        assert all(v == 0 for v in fields.values()), (name, fields)


@pytest.mark.cuda
@pytest.mark.parametrize("sensor", ["rgb", "tof"])
def test_lit_kernels_match_plain_with_every_lobe(gpu, sensor):
    """The same on a 480 x 270 block of the city with every lobe of the class
    (`_mixed_lobes`: RGL ground, GGX, glass, mirror, see-through ModPhong) at
    4 spp, lanes regenerated: bit-equal on the H100."""
    scene = _mixed_lobes(scenes.city_night(seed=7, device=gpu))
    inp = kc.k4_inputs(gpu, "city", scene=scene, width=480, height=270, ssqrt=2, m=1,
                       sensor=SensorTofAmcw() if sensor == "tof" else None)
    res = kc.check_k4(inp)
    torch.cuda.synchronize()
    for name, fields in res.items():
        assert all(v == 0 for v in fields.values()), (name, fields)


@pytest.mark.cuda
def test_lit_kernels_match_plain_at_every_city_step(gpu):
    """The surround regeneration and the lit shade against their plain
    versions at each of the city frame's 8 steps (2 blocks of 1048576
    lanes) and the regeneration that ends each block, on the lanes each
    step gives (utils/k4_steps.py): bit-equal on the H100, the later steps'
    dead lanes and the step before's two deposits per lane included."""
    from wurblpt_tpu_torch.utils import k4_steps

    rows = k4_steps.frame_rows("city", gpu, n=1)
    expect = []
    for blk in range(2):
        expect += [(k, 4 * blk + s + (blk if k == "regen_surround" else 0))
                   for s in range(4) for k in ("regen_surround", "shade_lit")]
        expect.append(("regen_surround", 5 * blk + 4))
    assert [(r["kernel"], r["step"]) for r in rows] == expect
    assert all(r["max_abs_err"] == 0.0 and r["discrete_differ"] == 0 for r in rows), rows
    assert min(r["live"] for r in rows if r["live"] is not None) < kc.CITY_LANES // 4


@pytest.mark.cuda
def test_lit_k4_city_frame_gives_the_torch_op_bits_on_the_card(gpu, monkeypatch):
    """The city bench frame (1920 x 1080, 360-degree stereo, 1 spp, 4 path
    components, two blocks of 1048576 lanes) through K4's lit class and
    through the torch-op bounce on the card: the same image and counters,
    bit for bit."""
    render = kc.city_frame(gpu, scenes.city_night(seed=7, device=gpu))
    native.reset_launch_counts()
    img, stats = render()
    assert native.LAUNCHES["shade_lit"] == 8 and native.LAUNCHES["rgl_sample"] == 0
    monkeypatch.setattr(integrator, "lit_class", lambda *a: False)
    img_g, stats_g = render()
    assert native.LAUNCHES["shade_lit"] == 8 and native.LAUNCHES["rgl_sample"] > 0
    assert torch.equal(img, img_g) and torch.equal(stats, stats_g)
    kc.check_city_frame(img, stats)
