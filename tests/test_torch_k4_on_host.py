"""K4's in-place kernels (``csrc/wavefront.cu``: the lit shade's persistent
launch, which bins a block's live lanes by what they run, and the pinhole
and surround regenerations) compiled with g++ and
run on the CPU, held against their plain versions.

The kernels cannot run here, but their control flow can: ``tests/cuda_host``
stands in for the CUDA intrinsics (one std::thread per CUDA thread, the warp
sums through a barrier per warp, __syncthreads through a barrier per block),
so the lane counter, the dead lanes' writes, the bins and the lanes they
carry from round to round and every branch of a lane run
as written, with the kernels' own arguments (`wavefront.lit_args`,
`regen_args`). The host's libm computes sinf, cosf, powf and the like, not
the card's nor PyTorch's, so floats are held to kernel_check's tolerances
(`check_call`); on the card the kernels are bit-equal (the CUDA tests).
The small city of tests/test_torch_wavefront_city.py at 48 x 24 pixels."""

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
    # arguments up to the pending deposits and the grid; the regenerations
    # theirs but the stream
    sig = native._SIGNATURES
    lib.host_shade_lit.argtypes = sig["wpt_shade_lit"][:-2] + [ctypes.c_int]
    lib.host_shade_lit.restype = ctypes.c_int
    for name in ("regen_pinhole", "regen_surround"):
        getattr(lib, f"host_{name}").argtypes = sig[f"wpt_{name}"][:-1]
        getattr(lib, f"host_{name}").restype = None
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


def _host_regen(lib):
    """regen_pinhole's and regen_surround's contract through the host build."""
    def regen(st, sample, k_next, cam, cam_cfg, lanes, randomize):
        t_max = torch.full((st.active.shape[0],), -1.0)
        args, keep = wf.regen_args(st, sample, k_next, cam, cam_cfg, lanes, randomize, t_max)
        fn = lib.host_regen_surround if wf._surround(cam_cfg) else lib.host_regen_pinhole
        fn(*args)
        del keep
        return st, sample, k_next, t_max
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
    res = kc.check_call(_host_shade(k4), wf.shade_lit_plain, inp.shade, lit_rows=True,
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


@pytest.mark.parametrize("case", ["city, fresh block", "city, 4 spp", "rtiow lens, OPENCV",
                                  "rtiow lens, RADIAL_ONLY"])
def test_host_regeneration_matches_the_plain_one(k4, case):
    """The regenerations in place: the regenerated lanes' state, sample ids
    and next indices, every lane's t_max, the kept lanes untouched."""
    if case.startswith("city"):
        inp = _small_inputs(steps=0 if case.endswith("fresh block") else 2,
                            ssqrt=1 if case.endswith("fresh block") else 2)
    else:
        model = DistortionModel.OPENCV if case.endswith("OPENCV") else DistortionModel.RADIAL_ONLY
        inp = kc.k4_inputs("cpu", "rtiow", width=24, height=16, ssqrt=2, m=2,
                           cfg=CameraConfig(distortion=model, undistort_iters=8))
    need = kc.regenerated_lanes(inp)
    assert need > 0
    st = inp.regen[0]
    before = [x.clone() for x in st]
    _held(kc.check_call(_host_regen(k4), wf.regen_plain, inp.regen))
    assert all(torch.equal(a, b) for a, b in zip(before, st))
