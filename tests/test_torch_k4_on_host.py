"""K4's in-place kernels (``csrc/wavefront.cu``: the lit shade's persistent
launch, which bins a block's live lanes by what they run, the diffuse and
env shades' tiled launch, which queues a tile's live lanes by bin, and the
pinhole and surround regenerations) compiled with g++ and
run on the CPU, held against their plain versions.

The kernels cannot run here, but their control flow can: ``tests/cuda_host``
stands in for the CUDA intrinsics (one std::thread per CUDA thread, the warp
sums through a barrier per warp, __syncthreads through a barrier per block),
so the lane counter, the dead lanes' writes, the bins and the lanes they
carry from round to round, the tiles and their queues and every branch of
a lane run as written, with the kernels' own arguments
(`wavefront.lit_args`, `diffuse_args`, `env_args`, `regen_args`). The
host's libm computes sinf, cosf, powf and the like, not
the card's nor PyTorch's, so floats are held to kernel_check's tolerances
(`check_call`); on the card the kernels are bit-equal (the CUDA tests).
The small city of tests/test_torch_wavefront_city.py at 48 x 24 pixels; the
Cornell, ToF, animated Cornell, envmap, rtiow and small mesh blocks of
tests/test_torch_wavefront*.py."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from test_torch_wavefront_city import SMALL, _mixed_lobes, _small_inputs
from wurblpt_tpu_torch import native
from wurblpt_tpu_torch.native import SRC_DIR
from wurblpt_tpu_torch.render import wavefront as wf
from wurblpt_tpu_torch.render.camera import CameraConfig, DistortionModel
from wurblpt_tpu_torch.render.sensor import SensorTofAmcw
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes
from wurblpt_tpu_torch.scene.ir import MaterialType

torch.set_num_threads(2)

HOST = Path(__file__).parent / "cuda_host"
CUT = "template <typename Kernel>\nvoid launch_lit("     # the first host code that launches


@pytest.fixture(scope="module")
def k4(tmp_path_factory):
    """The host build of wavefront.cu's kernels (tests/cuda_host/k4.cpp)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    src = (SRC_DIR / "wavefront.cu").read_text()
    assert CUT in src
    device = src[:src.index(CUT)] + "}  // namespace\n"
    out = tmp_path_factory.mktemp("k4")
    (out / "wavefront_device.cuh").write_text(device)
    lib = out / "libk4.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{out}", f"-I{HOST}", f"-I{SRC_DIR}", "-o", str(lib),
                    str(HOST / "k4.cpp")], check=True)
    lib = ctypes.CDLL(str(lib))
    # the entry points' own C signatures: host_shade_lit takes wpt_shade_lit's
    # arguments up to the pending deposits and the grid; the other shades
    # and the regenerations theirs but the stream
    sig = native._SIGNATURES
    lib.host_shade_lit.argtypes = sig["wpt_shade_lit"][:-2] + [ctypes.c_int]
    lib.host_shade_lit.restype = ctypes.c_int
    for name in ("shade_diffuse", "shade_env"):
        getattr(lib, f"host_{name}").argtypes = sig[f"wpt_{name}"][:-1]
        getattr(lib, f"host_{name}").restype = ctypes.c_int
    for name in ("regen_pinhole", "regen_surround"):
        getattr(lib, f"host_{name}").argtypes = sig[f"wpt_{name}"][:-1]
        getattr(lib, f"host_{name}").restype = ctypes.c_int
    return lib


def _host_shade(lib, grid=2):
    """shade_lit's contract through the host build: (st, shadow rows), the
    rows filled with NaN and -1 first, so that a row the kernel should
    write and does not shows."""
    def shade_lit(tables, sensor, params, st, pixel, sample, t, prim, hr):
        n = st.active.shape[0]
        rows = (torch.full((2 * n, 3), float("nan")), torch.full((2 * n, 3), float("nan")),
                torch.full((2 * n,), -1.0), torch.full((2 * n, sensor.n_acc), -1.0))
        args, keep = wf.lit_args(tables, sensor, params, st, pixel, sample, t, prim, hr, *rows)
        assert lib.host_shade_lit(*args, grid) == 0
        del keep
        return (st, *rows)
    return shade_lit


def _host_queued(lib, kind):
    """shade_diffuse's (`kind` "diffuse") or shade_env's ("env") contract
    through the host build: (st, shadow rows), the rows (where the shade
    casts any) filled with NaN and -1 first, so that a row the kernel
    should write and does not shows."""
    def shade(tables, sensor, params, st, pixel, sample, t, prim, hr):
        n = st.active.shape[0]
        rows = (None, None, None)
        if kind == "diffuse" or tables.env.importance:
            rows = (torch.full((n, 3), float("nan")), torch.full((n,), -1.0),
                    torch.full((n, sensor.n_acc), -1.0))
        make = wf.diffuse_args if kind == "diffuse" else wf.env_args
        args, keep = make(tables, sensor, params, st, pixel, sample, t, prim, hr, *rows)
        assert getattr(lib, f"host_shade_{kind}")(*args) == 0
        del keep
        return (st, None if rows[0] is None else hr.position, *rows)
    return shade


# The diffuse and env blocks of the host tests: kc.k4_inputs' frame and its
# small size (the mesh on tests/test_torch_wavefront_env.py's small
# terrain), the shade's kind.
BLOCK16 = dict(width=16, ssqrt=2, m=2)
QUEUED = {"cornell": ("cornell", dict(width=40, ssqrt=2, m=2), "diffuse"),
          "tof": ("tof", BLOCK16, "diffuse"),
          "cornell_animated": ("cornell_animated", BLOCK16, "diffuse"),
          "envmap": ("envmap", dict(width=24, height=16, ssqrt=2, m=2), "env"),
          "rtiow": ("rtiow", dict(width=24, height=16, ssqrt=2, m=2), "env"),
          "mesh": ("mesh", dict(width=16, height=12, ssqrt=2, m=2), "env")}


def _queued_inputs(case, sensor=None):
    frame, size, kind = QUEUED[case]
    scene = (scenes.terrain_city(seed=3, terrain_res=8, n_buildings=2, sphere_slices=4,
                                 device="cpu") if frame == "mesh" else None)
    return kc.k4_inputs("cpu", frame, scene=scene, sensor=sensor, **size), kind


def _host_regen(lib):
    """regen_pinhole's and regen_surround's contract through the host build
    (the step before's pending deposits added first, the loop flag)."""
    def regen(st, sample, k_next, cam, cam_cfg, lanes, randomize, pending=None, occluded=None):
        t_max = torch.full((st.active.shape[0],), -1.0)
        work = torch.full((1,), -1, dtype=torch.int32)
        n_pend = wf._check_pending("host regen", st.acc, pending, occluded)
        args, keep = wf.regen_args(st, sample, k_next, cam, cam_cfg, lanes, randomize, t_max,
                                   pending, occluded, n_pend, work)
        fn = lib.host_regen_surround if wf._surround(cam_cfg) else lib.host_regen_pinhole
        assert fn(*args) == 0
        del keep
        return st, sample, k_next, t_max, work
    return regen


def _held(res):
    """Every discrete field equal on every lane, every float within
    check_call's tolerance (it raised otherwise)."""
    assert all(v == 0 for f, v in res.items() if isinstance(v, int)), res


@pytest.mark.parametrize("case", ["bounce 0", "bounce 2", "bounce 3", "4 spp, regenerated",
                                  "ToF sensor", "every lobe"])
def test_host_lit_shade_matches_the_plain_shade(k4, case):
    """The lit shade's persistent launch on the small city's lanes: every
    lane shaded once by its branch (dead, escaped, hit, RGL hit), in place,
    its state, shadow rows, pending deposits and the counters those of
    shade_lit_plain; the inputs of the call stay as they were."""
    steps, ssqrt, scene, sensor = {
        "bounce 0": (0, 1, None, None), "bounce 2": (2, 1, None, None),
        "bounce 3": (3, 1, None, None), "4 spp, regenerated": (2, 2, None, None),
        "ToF sensor": (2, 1, None, SensorTofAmcw()),
        "every lobe": (1, 2, _mixed_lobes(scenes.city_night(seed=7, **SMALL, device="cpu")),
                       None)}[case]
    inp = _small_inputs(scene=scene, sensor=sensor, steps=steps, ssqrt=ssqrt)
    st = inp.shade[3]
    before = [x.clone() for x in st]
    if ssqrt == 1:          # at 1 spp no lane regenerates after the first step
        assert (int((~st.active).sum()) > 0) == (steps > 0)
    res = kc.check_call(_host_shade(k4), wf.shade_lit_plain, inp.shade, cast_rows=True,
                        exact_rows=False)
    _held(res)
    assert all(torch.equal(a, b) for a, b in zip(before, st))


def test_host_lit_shade_writes_only_what_the_contract_names(k4):
    """A dead lane writes only its previous sample's pdf and flag (the rest
    of its state keeps its bits: here NaN where the plain version would
    not touch them either); an escaped lane no origin, direction, ray IOR,
    throughput or path lengths; a lane that casts no shadow ray no shadow
    origin or direction (they keep their NaN)."""
    inp = _small_inputs(steps=2)
    args = list(kc.fresh_args(inp.shade))
    st, prim = args[3], args[7]
    dead, escaped = ~st.active, st.active & (prim < 0)
    assert int(dead.sum()) > 0 and int(escaped.sum()) > 0
    marked = st._replace(**{f: torch.where(dead.view(-1, *([1] * (getattr(st, f).dim() - 1))),
                                           float("nan"), getattr(st, f))
                            for f in ("o", "d", "ior", "throughput", "geom_len", "opt_len",
                                      "acc", "prev_light_pdf")})
    args[3] = marked
    keep = [x.clone() for x in marked]
    out, so, sd, stmax, pending = _host_shade(k4)(*args)
    for f, a, b in zip(wf.LoopState._fields, keep, out):
        if f in ("o", "d", "ior", "throughput", "geom_len", "opt_len", "acc",
                 "prev_light_pdf", "bounce", "active"):
            rows = dead if f not in ("o", "d", "ior", "throughput", "geom_len", "opt_len") \
                else dead | escaped
            assert torch.equal(a[rows].view(torch.int32) if a.is_floating_point() else a[rows],
                               b[rows].view(torch.int32) if b.is_floating_point() else b[rows]), f
    assert not out.prev_random[dead].any() and (out.prev_pdf[dead] == 0).all()
    idle = stmax == 0
    assert int(idle.sum()) > 0 and torch.isnan(so[idle]).all() and torch.isnan(sd[idle]).all()
    assert (pending[idle] == 0).all()


@pytest.mark.parametrize("case", ["cornell", "tof", "cornell_animated", "envmap", "rtiow", "mesh",
                                  "mesh, ToF sensor"])
def test_host_diffuse_and_env_shades_match_the_plain_shade(k4, case):
    """The diffuse and env shades' tiled launch on small blocks after 2
    plain steps (the Cornell block in four tiles over the two blocks one SM
    holds here, so a block takes two; the animated Cornell block with its
    moving light; envmap's cube sky and glass, rtiow's constant sky, the
    mesh's equirect sky with GGX and mirror): every lane shaded once by its
    branch (dead, escaped, hit), in place, its state, shadow rows where
    they cast, pending deposits and the counters those of the plain shade;
    the inputs of the call stay as they were."""
    inp, kind = _queued_inputs(case.split(",")[0],
                               SensorTofAmcw() if case.endswith("ToF sensor") else None)
    st, prim = inp.shade[3], inp.shade[7]
    assert int((st.active & (prim >= 0)).sum()) > 0
    if case != "tof":       # the closed ToF box: every lane still active, none escapes
        assert int((~st.active).sum()) > 0 and int((st.active & (prim < 0)).sum()) > 0
    if case == "cornell":
        assert st.active.shape[0] > 2 * 1024      # more tiles than blocks
    before = [x.clone() for x in st]
    plain = wf.shade_diffuse_plain if kind == "diffuse" else wf.shade_env_plain
    res = kc.check_call(_host_queued(k4, kind), plain, inp.shade, cast_rows=True,
                        exact_rows=False)
    _held(res)
    assert all(torch.equal(a, b) for a, b in zip(before, st))


@pytest.mark.parametrize("case", ["cornell", "mesh", "envmap", "rtiow"])
def test_host_diffuse_and_env_shades_write_only_what_the_contract_names(k4, case):
    """A dead lane writes only its previous sample's pdf and flag (and in
    the diffuse class its mixture pdf) and its idle shadow row: the rest of
    its state keeps its bits, here NaN; an escaped lane writes no origin,
    ray IOR or geometric path length (in the diffuse class also no
    direction, throughput or optical path length: it reads none); the env
    shade never writes the mixture pdf; a lane that casts no shadow ray
    writes no shadow direction (it keeps its NaN) and a zero pending
    deposit."""
    inp, kind = _queued_inputs(case)
    args = list(kc.fresh_args(inp.shade))
    tables, st, prim, hr = args[0], args[3], args[7], args[8]
    dead, escaped = ~st.active, st.active & (prim < 0)
    assert int(dead.sum()) > 0 and int(escaped.sum()) > 0
    unread = (("o", "d", "ior", "throughput", "geom_len", "opt_len") if kind == "diffuse"
              else ("o", "ior", "geom_len"))
    marks = {f: dead | escaped if f in unread else dead
             for f in ("o", "d", "ior", "throughput", "geom_len", "opt_len", "acc",
                       "prev_light_pdf")}
    if kind == "env":
        marks["prev_light_pdf"] = torch.ones_like(dead)     # passed through on every lane
    else:
        del marks["prev_light_pdf"]                          # 0 on every lane but RANDOM ones
    marked = st._replace(**{f: torch.where(m.view(-1, *([1] * (getattr(st, f).dim() - 1))),
                                           float("nan"), getattr(st, f))
                            for f, m in marks.items()},
                         bounce=torch.where(dead, -7, st.bounce))
    args[3] = marked
    keep = marked._asdict()
    keep = {f: x.clone() for f, x in keep.items()}
    out, so, sd, stmax, pending = _host_queued(k4, kind)(*args)
    for f, rows in (*marks.items(), ("bounce", dead), ("active", dead)):
        a, b = keep[f][rows], getattr(out, f)[rows]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    assert not out.prev_random[dead].any() and (out.prev_pdf[dead] == 0).all()
    if kind == "diffuse":
        assert (out.prev_light_pdf[dead | escaped] == 0).all()
    if stmax is None:
        assert kind == "env" and not tables.env.importance
        return
    idle = stmax == 0
    assert bool(idle[dead | escaped].all()) and not bool(idle.all())
    assert torch.isnan(sd[idle]).all() and not torch.isnan(sd[~idle]).any()
    assert (pending[idle] == 0).all()
    assert so is hr.position


@pytest.mark.parametrize("case", ["city, fresh block", "city, 4 spp", "rtiow lens, OPENCV",
                                  "rtiow lens, RADIAL_ONLY", "cornell", "rtiow thin lens",
                                  "rtiow thin lens, OPENCV"])
def test_host_regeneration_matches_the_plain_one(k4, case):
    """The regenerations in place: the step before's pending deposits
    added to acc (the city's two rows per lane, Cornell's one; none on the
    fresh block and rtiow), the loop flag, the thin lens of depth of field, the regenerated lanes' state,
    sample ids and next indices, every lane's t_max, the kept lanes
    untouched."""
    if case.startswith("city"):
        inp = _small_inputs(steps=0 if case.endswith("fresh block") else 2,
                            ssqrt=1 if case.endswith("fresh block") else 2)
    elif case == "cornell":
        inp, _ = _queued_inputs("cornell")
    elif case.startswith("rtiow thin lens"):   # depth of field: the lens sample by Salt.LENS
        opencv = case.endswith("OPENCV")
        inp = kc.k4_inputs("cpu", "rtiow_dof", width=24, height=16, ssqrt=2, m=2,
                           cfg=CameraConfig(dof=True, distortion=DistortionModel.OPENCV
                                            if opencv else DistortionModel.NONE,
                                            undistort_iters=8))
    else:
        model = DistortionModel.OPENCV if case.endswith("OPENCV") else DistortionModel.RADIAL_ONLY
        inp = kc.k4_inputs("cpu", "rtiow", width=24, height=16, ssqrt=2, m=2,
                           cfg=CameraConfig(distortion=model, undistort_iters=8))
    need = kc.regenerated_lanes(inp)
    assert need > 0
    pending = inp.regen[7]
    assert (pending is not None) == (case in ("city, 4 spp", "cornell"))
    if pending is not None:   # deposits that change acc, and occluded ones
        assert bool((pending != 0).any()) and bool(inp.regen[8].any())
    st = inp.regen[0]
    before = [x.clone() for x in st]
    _held(kc.check_call(_host_regen(k4), wf.regen_plain, inp.regen))
    assert all(torch.equal(a, b) for a, b in zip(before, st))
