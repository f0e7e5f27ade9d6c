"""K7's device code (``csrc/rgl.cu``: eval and sample, a thread a lane, a
lane without an RGL material given zeros, the sample's warp form counting
its RGL lanes' CDF rows by the warp's ballots, ``rgl_common.cuh``
warp_row_count) compiled with g++ through ``tests/cuda_host`` and run on
the CPU (``tests/cuda_host/rgl.cpp``: the launch's blocks one after another,
each as its 128 threads, the warp votes and shuffles through a barrier per
warp).

Held bit for bit against the lane functions run one lane after another
(``host_rgl_lanes``: eval_lane and sample_lane<false>, each row counted by
its own lane, as the lit shade runs them; the same libm), built as the card
builds it (the warp's counts on padded rows at least WARP_COUNT_FROM wide,
here the 33- and 128-wide tables) and with ``-DWPT_RGL_WARP_COUNT_FROM=1``
(the warp's counts on every row), on: ids -1 (no RGL material: zeros, ok
false), in the stack and past it, mixed, every lane skipped, every lane
live, the first two warps skipped and the others live; rows 8, 16, 33 and
128 wide, and narrower materials in a wider stack (their rows masked by
their widths); CDF rows with flat runs, rows that are not monotone (a table
moved by a fit), and uniforms at both ends of a row and equal to CDF
entries. Then against the plain PyTorch version (``rgl_eval_plain`` /
``rgl_sample_plain``): the host's libm and PyTorch's CPU kernels round
atan2f, asinf, sinf, cosf and sqrtf apart in the last bit on some lanes,
and a sample's quadratic CDF inversions magnify that, so every lane without
an RGL material is held bit-equal (zeros) and the others to ok equal and
rtol 1e-4 on most lanes. The card holds kernel and plain version bit for
bit (``chip_smoke.py``).

K7T's device code (``backward_common.cuh``) skips a lane without an RGL
material as its plain version does (``host_rgl_bwd`` against
``rgl_bwd_plain``)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from wurblpt_tpu_torch import native
from wurblpt_tpu_torch.materials import rgl
from wurblpt_tpu_torch.native import SRC_DIR
from wurblpt_tpu_torch.utils import kernel_check as kc
from wurblpt_tpu_torch.utils import scenes

from test_torch_backward_on_host import _close, _host_k7t

torch.set_num_threads(2)

HOST = SRC_DIR.parent.parent / "tests" / "cuda_host"
_P = ctypes.c_void_p
_I = ctypes.c_int


def _build(out, name, src, *defines):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    lib = out / f"lib{name}.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", *defines, f"-I{out}", f"-I{HOST}", f"-I{SRC_DIR}", "-o", str(lib),
                    str(HOST / src)], check=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The host builds of rgl.cu's device code (cut at its C entry points):
    {"card": as the card builds it, "warp": the warp's counts on every
    row}."""
    out = tmp_path_factory.mktemp("rgl")
    src = (SRC_DIR / "rgl.cu").read_text()
    (out / "rgl_device.cuh").write_text(src[:src.index('extern "C"')])
    sig = native._SIGNATURES
    built = {}
    for key, defines in (("card", ()), ("warp", ("-DWPT_RGL_WARP_COUNT_FROM=1",))):
        lib = _build(out, f"rgl_{key}", "rgl.cpp", *defines)
        lib.host_rgl_eval.argtypes = sig["wpt_rgl_eval"][:-1]
        lib.host_rgl_eval.restype = None
        lib.host_rgl_sample.argtypes = sig["wpt_rgl_sample"][:-1]
        lib.host_rgl_sample.restype = None
        lib.host_rgl_warp_form.argtypes = [_P]
        lib.host_rgl_lanes.argtypes = [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P]
        built[key] = lib
    return built


@pytest.fixture(scope="module")
def bwd_lib(tmp_path_factory):
    """The host build of backward_common.cuh (tests/cuda_host/backward.cpp)."""
    lib = _build(tmp_path_factory.mktemp("bwd"), "bwd", "backward.cpp")
    lib.host_rgl_bwd.argtypes = native._SIGNATURES["wpt_rgl_bwd"][:-1] + [ctypes.c_longlong]
    return lib


def _fields(seed, P, T, hv, hl, hn=16, zero_rows=False):
    """A synthetic material from numpy `seed`: vndf hv x hv, luminance and
    rgb hl x hl over a P x T parameter grid; with `zero_rows`, luminance
    rows and vndf columns of zeros (CDF rows with flat runs, a marginal row
    flat across them)."""
    f = dict(phi_i=np.linspace(-np.pi, np.pi, P).astype(np.float32) if P > 1
             else np.zeros(1, np.float32),
             theta_i=np.linspace(0.0, np.pi / 2, T).astype(np.float32),
             ndf=scenes._smooth_positive((hn, hn), seed + 1),
             sigma=scenes._smooth_positive((hn, hn), seed + 2, 0.2, 0.4),
             vndf=scenes._smooth_positive((P, T, hv, hv), seed + 3),
             luminance=scenes._smooth_positive((P, T, hl, hl), seed + 4),
             rgb=scenes._smooth_positive((P, T, 3, hl, hl), seed + 5))
    if zero_rows:
        f["luminance"][..., 1:hl // 2, :] = 0.0
        f["vndf"][..., :, 2:hv // 2] = 0.0
    return f


def _stack(*fields):
    return rgl.stack_rgl_tables([rgl.load_rgl_material(f) for f in fields], "cpu")


def _not_monotone(t):
    """The tables with CDF rows that are not monotone (as a fit that moves
    them can leave them): entries of the luminance conditional rows and the
    vndf marginal rows raised and lowered past their neighbours."""
    lc, vm = t.lum_cond.clone(), t.vndf_marg.clone()
    lc[..., 2] += 0.4
    lc[..., 1, 3] -= 0.3
    vm[..., 3] += 0.5
    vm[..., 5] -= 0.2
    return t._replace(lum_cond=lc, vndf_marg=vm)


TABLES = {
    "8 and 16 (material_comparison's)": lambda: _stack(scenes.synthetic_rgl_fields(0),
                                                        scenes.synthetic_rgl_fields(1)),
    "33, four corners": lambda: _stack(_fields(40, 2, 3, 33, 33)),
    "128 with 33 and 16 masked": lambda: kc.wide_rgl_lanes("cpu", n=8)[0],
    "flat runs": lambda: _stack(_fields(50, 1, 4, 16, 8, zero_rows=True),
                                _fields(60, 2, 2, 33, 16, zero_rows=True)),
    "not monotone": lambda: _not_monotone(_stack(_fields(70, 1, 3, 16, 8),
                                                 _fields(80, 2, 2, 40, 12))),
}


def _lanes(t, n, ids, seed):
    """n lanes: ids ("mixed": -1, each material, one past the stack;
    "skipped": all -1; "live": all in the stack; "chunks": the first two
    warps' 64 lanes -1, the rest live), wi and wo on the sphere (a tenth
    below the surface), u2 uniform with its last 64 lanes at the ends of a
    row and on CDF entries of material 0."""
    rs = np.random.default_rng(seed)
    m = t.count
    if ids == "mixed":
        mid = rs.integers(-1, m + 1, n)
    elif ids == "skipped":
        mid = np.full(n, -1)
    elif ids == "live":
        mid = rs.integers(0, m, n)
    else:
        mid = np.where(np.arange(n) < 64, -1, rs.integers(0, m, n))

    def dirs():
        x = rs.standard_normal((n, 3))
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        x[:, 2] = np.abs(x[:, 2]) * np.where(rs.uniform(size=n) < 0.1, -1.0, 1.0)
        return x

    u2 = rs.uniform(size=(n, 2))
    ends = np.array([0.0, 1.0, 1e-9, 1.0 - 2 ** -24, 0.5])
    cdf = np.concatenate([t.lum_marg[0].numpy().ravel(), t.lum_cond[0].numpy().ravel(),
                          t.vndf_marg[0].numpy().ravel()])
    edge = np.concatenate([ends, rs.choice(cdf, 64 - len(ends))])
    u2[-64:] = np.stack([rs.permutation(edge), rs.permutation(edge)], -1)
    f32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32))  # noqa: E731
    return (torch.as_tensor(mid.astype(np.int32)), f32(dirs()), f32(dirs()), f32(u2))


def _host(lib, t, mid, wi, x, sample, lanes=False):
    """The kernel or, with `lanes`, the lane-by-lane reference: (f*cos,
    pdf) or (wo, f*cos, pdf, ok)."""
    n = mid.shape[0]
    wo = torch.full((n, 3), float("nan"))
    fcos, pdf = torch.full((n, 4), float("nan")), torch.full((n,), float("nan"))
    ok = torch.ones(n, dtype=torch.bool)
    ct = rgl.c_tables(t)
    p = lambda a: a.data_ptr()  # noqa: E731
    if lanes:
        lib.host_rgl_lanes(ctypes.addressof(ct), p(mid), p(wi), p(x), n, int(sample), p(wo),
                           p(fcos), p(pdf), p(ok))
    elif sample:
        lib.host_rgl_sample(ctypes.addressof(ct), p(mid), p(wi), p(x), n, p(wo), p(fcos),
                            p(pdf), p(ok))
    else:
        lib.host_rgl_eval(ctypes.addressof(ct), p(mid), p(wi), p(x), n, p(fcos), p(pdf))
    return (wo, fcos, pdf, ok) if sample else (fcos, pdf)


def _bit_equal(got, ref, what):
    for k, (a, b) in enumerate(zip(got, ref)):
        off = kc.lanes_differ(a, b)
        assert off == 0, f"{what}, output {k}: {off} lanes differ"


@pytest.mark.parametrize("ids", ["mixed", "skipped", "live", "chunks"])
@pytest.mark.parametrize("name", list(TABLES))
def test_k7_queue_and_warp_counts_keep_the_lanes_bits(libs, name, ids):
    """Both kernels, the sample as the card builds it and with the warp's
    counts on every row, bit-equal to the lane functions run lane by lane
    on every lane; the card's build takes the warp form exactly on the
    stacks with a padded row at least 32 wide."""
    t = TABLES[name]()
    n = 512 if ids == "chunks" else 320
    mid, wi, wo, u2 = _lanes(t, n, ids, seed=len(name) + len(ids))
    card = libs["card"]
    ref = _host(card, t, mid, wi, wo, False, lanes=True)
    _bit_equal(_host(card, t, mid, wi, wo, False), ref, f"eval {name} {ids}")
    ref = _host(card, t, mid, wi, u2, True, lanes=True)
    for key, lib in libs.items():
        _bit_equal(_host(lib, t, mid, wi, u2, True), ref, f"sample {name} {ids} ({key} build)")
    ct = rgl.c_tables(t)
    wide = max(t.vndf_data.shape[-2:] + t.lum_data.shape[-2:]) >= 32
    assert card.host_rgl_warp_form(ctypes.addressof(ct)) == int(wide), name
    skipped = mid < 0
    assert bool((ref[3][skipped] == 0).all()) and bool((ref[0][skipped] == 0).all())
    if ids != "skipped":
        assert int(ref[3].sum()) > 0


@pytest.mark.parametrize("name", list(TABLES))
def test_k7_device_code_against_its_plain_version(libs, name):
    """The kernels against rgl_eval_plain / rgl_sample_plain on mixed ids:
    every lane without an RGL material bit-equal (zeros, ok false), the
    others within the host's libm (ok equal on all but a few lanes, each
    output within rtol 1e-4 on 98 % of the lanes)."""
    t = TABLES[name]()
    mid, wi, wo, u2 = _lanes(t, 320, "mixed", seed=5)
    skipped = mid < 0
    for sample, x in ((False, wo), (True, u2)):
        got = _host(libs["card"], t, mid, wi, x, sample)
        ref = (rgl.rgl_sample_plain if sample else rgl.rgl_eval_plain)(t, mid, wi, x)
        for a, b in zip(got, ref):
            assert kc.lanes_differ(a[skipped], b[skipped]) == 0
            if a.dtype == torch.bool:
                assert int((a != b).sum()) <= 3
                continue
            close = torch.isclose(a, b, rtol=1e-4, atol=1e-6).reshape(a.shape[0], -1).all(-1)
            assert float(close.float().mean()) >= 0.98, float(close.float().mean())


@pytest.mark.parametrize("full", [False, True], ids=["tail", "full"])
@pytest.mark.parametrize("sample", [False, True], ids=["eval", "sample"])
def test_k7t_skips_lanes_without_an_rgl_material(bwd_lib, sample, full):
    """K7T on mixed ids with a cotangent on every lane: a lane with a
    negative id takes none (K7 gave it zeros), in the kernel as in its plain
    version; the cotangents equal those of the same lanes at id 0 with
    those lanes' cotangents zeroed, and are finite."""
    from wurblpt_tpu_torch.utils import grad_check as gc

    tables, mid, wi, wo, u2, g_f = gc.rgl_lanes("cpu", n=1024)
    g_pdf, g_wo = gc.rgl_full_cotangents(1024, "cpu")
    mid = torch.where(torch.arange(1024) % 3 == 0, -1, mid).to(torch.int32)
    x = u2 if sample else wo
    kw = dict(g_pdf=g_pdf, g_wo=g_wo) if full else {}
    out = _host_k7t(bwd_lib, tables, mid, wi, x, g_f, sample, full, **kw)
    off = mid < 0
    zeroed = {k: torch.where(off[:, None], 0.0, v) if v.dim() > 1 else torch.where(off, 0.0, v)
              for k, v in (("g_f", g_f), ("g_pdf", g_pdf), ("g_wo", g_wo))}
    kw0 = dict(g_pdf=zeroed["g_pdf"], g_wo=zeroed["g_wo"]) if full else {}
    ref = _host_k7t(bwd_lib, tables, torch.clamp_min(mid, 0), wi, x, zeroed["g_f"], sample,
                    full, **kw0)
    plain = rgl.rgl_bwd_plain(tables, mid, wi, x, g_f, sample, full=full,
                              **({"g_pdf": g_pdf, "g_wo": g_wo if sample else None}
                                 if full else {}))
    for k, v in out.items():
        _close(v, ref[k], k)   # the host's float atomics land in any order
        assert bool(torch.isfinite(plain[k]).all()), k
        if k in ("wi", "wo"):
            assert bool((v[off] == 0).all()) and bool((plain[k][off] == 0).all()), k
