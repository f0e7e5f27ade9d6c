"""The port's measured RGL BRDF (K7's plain version) against the JAX package.

The same tables and lanes, made with numpy from a seed, go through
``wurblpt_tpu.materials.rgl`` and ``wurblpt_tpu_torch.materials.rgl``: the
city's table (one material, P = 1, T = 4) and random tables of two materials
of different sizes (P = 2, T = 3 padded). eval's f*cos and pdf agree to f32
rounding on every lane (rtol 1e-5, atol 1e-6: XLA on the CPU contracts
a * b + c into an FMA and rounds atan2, asin and sin/cos differently in the
last bit). sample is held stage by stage on every lane: each of its two warps
on the same inputs, then the tail (wo, f*cos, pdf, ok) from the same warp
positions, at the same tolerance. A warp's quadratic CDF inversions
(r0 - disc) / (r0 - r1) magnify a last-bit difference by |r0| / |r0 - r1|,
so each lane's warp outputs may differ by 2 ulps times that factor more.
Chained, the two warps and the tail magnify such differences further, so
end to end only `ok` is held equal, and the BRDF evaluated by both packages
at the port's sampled directions to rtol 1e-5. Then the analogs of
tests/test_rgl.py: the warp round trip, sample/eval consistency and the pdf
as a density, on the port alone.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu.core.vecmath import dot as jdot
from wurblpt_tpu.materials import rgl as jrgl
from wurblpt_tpu_torch.materials import rgl
from wurblpt_tpu_torch.utils import scenes

torch.set_num_threads(2)


def _smooth_positive(rs, shape, lo=0.2, hi=1.0):
    a = rs.uniform(lo, hi, size=shape).astype(np.float32)
    for ax in (-1, -2):
        a = 0.5 * a + 0.25 * (np.roll(a, 1, ax) + np.roll(a, -1, ax))
    return a.astype(np.float32)


def _random_fields(seed, P, T, hv, wv, hl, wl, hn, wn):
    rs = np.random.default_rng(seed)
    return dict(phi_i=np.linspace(-np.pi, np.pi, P).astype(np.float32),
                theta_i=np.linspace(0.0, np.pi / 2, T).astype(np.float32),
                ndf=_smooth_positive(rs, (hn, wn)), sigma=_smooth_positive(rs, (hn, wn), 0.2, 0.4),
                vndf=_smooth_positive(rs, (P, T, hv, wv)),
                luminance=_smooth_positive(rs, (P, T, hl, wl)),
                rgb=_smooth_positive(rs, (P, T, 3, hl, wl)))


TABLES = {
    "city": lambda: [scenes.city_rgl_fields(7)],
    "two random": lambda: [_random_fields(1, 2, 3, 16, 16, 8, 8, 16, 16),
                           _random_fields(2, 1, 2, 12, 10, 6, 7, 10, 12)],
}


@functools.lru_cache(maxsize=None)
def _tables(name):
    fields = TABLES[name]()
    return (jrgl.stack_rgl_tables([jrgl.load_rgl_material(f) for f in fields]),
            rgl.stack_rgl_tables([rgl.load_rgl_material(f) for f in fields], "cpu"))


def _lanes(n, n_mat, seed=3):
    """mid, wi (a fifth below the horizon), wo, u2."""
    rs = np.random.default_rng(seed)

    def sphere():
        x = rs.normal(size=(n, 3))
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    wi = sphere()
    wi[:, 2] = np.abs(wi[:, 2]) * np.where(rs.uniform(size=n) < 0.2, -1, 1)
    return (rs.integers(0, n_mat, n).astype(np.int32), wi, sphere(),
            rs.uniform(size=(n, 2)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(TABLES))
def test_tables_equal_jax(name):
    jt, tt = _tables(name)
    for f in rgl.RGLTables._fields:
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)).astype(np.float32 if getattr(
                                          tt, f).dtype == torch.float32 else np.int32), err_msg=f)
    via_numpy = rgl.rgl_tables_from_numpy(jt, "cpu")
    for a, b in zip(tt, via_numpy):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(TABLES))
def test_eval_matches_jax(name):
    jt, tt = _tables(name)
    mid, wi, wo, _ = _lanes(4096, tt.count)
    jf, jp = jrgl.rgl_eval(jt, jnp.asarray(mid), jnp.asarray(wi), jnp.asarray(wo))
    f, p = rgl.rgl_eval(tt, _t(mid), _t(wi), _t(wo))
    _close(f, jf)
    _close(p, jp)
    assert float((p > 0).float().mean()) > 0.2


def _inversion_conditioning(warp, pos):
    """Per lane, how much the two quadratic CDF inversions of `warp.sample`
    that produced `pos` magnify a last-bit difference: r0 / |r0 - r1| for the
    row (the integrals of the cell's two rows) plus c0 / |c0 - c1| for the
    column (the cell's two column densities); 1 for an inversion that takes
    the linear branch (`is_const`)."""
    x0, y0, _, sy = warp._cell(pos)
    y1 = warp._next_row(y0)
    fr, last = warp.fr, torch.clamp_min(warp.w - 1, 0)
    r0, r1 = rgl._g(fr, warp.cond, y0, last), rgl._g(fr, warp.cond, y1, last)
    c0 = (1.0 - sy) * rgl._g(fr, warp.data, y0, x0) + sy * rgl._g(fr, warp.data, y1, x0)
    c1 = (1.0 - sy) * rgl._g(fr, warp.data, y0, x0 + 1) + sy * rgl._g(fr, warp.data, y1, x0 + 1)
    k = torch.zeros_like(r0)
    for a, b in ((r0, r1), (c0, c1)):
        k = k + torch.where(torch.abs(a - b) < 1e-4 * (a + b), 1.0, torch.abs(a) / torch.abs(a - b))
    return k.numpy()


def _jax_sample_tail(jfr, wi, lum, vndf):
    """JAX rgl_sample after its two warps (wurblpt_tpu/materials/rgl.py:659-676),
    from the given warp outputs (position, pdf)."""
    (sample, lum_pdf), (u_wm, ndf_pdf) = ((jnp.asarray(x.numpy()) for x in s) for s in (lum, vndf))
    phi_m = jnp.where(jfr.iso, jrgl._u2phi(u_wm[:, 1]) + jfr.phi_i, jrgl._u2phi(u_wm[:, 1]))
    theta_m = jrgl._u2theta(u_wm[:, 0])
    sin_t, cos_t = jnp.sin(theta_m), jnp.cos(theta_m)
    wm = jnp.stack([jnp.cos(phi_m) * sin_t, jnp.sin(phi_m) * sin_t, cos_t], -1)
    wo = 2.0 * jdot(wm, wi)[:, None] * wm - wi
    fval = jrgl._fr_common(jfr, wi, wm, sample, u_wm)
    pdf = ndf_pdf * lum_pdf / jrgl._jacobian(wi, wm, u_wm)
    ok = (wi[:, 2] > 0) & (wo[:, 2] > 0) & (pdf > 0) & jnp.all(jnp.isfinite(fval), -1)
    return wo, jnp.where(ok[:, None], fval, 0.0), jnp.where(ok, pdf, 0.0), ok


@pytest.mark.parametrize("name", list(TABLES))
def test_sample_matches_jax(name):
    jt, tt = _tables(name)
    mid, wi, _, u2 = _lanes(4096, tt.count, seed=4)
    n = len(mid)
    fr = rgl._prepare(tt, _t(mid), _t(wi))
    jfr = jrgl._prepare(jt, jnp.asarray(mid), jnp.asarray(wi))
    u = _t(u2[:, ::-1])
    warps = []
    for which in ("lum", "vndf"):
        warp = rgl._warp(tt, fr, which)
        pos, pdf = warp.sample(u)
        jpos, jpdf = jrgl._warp(jfr, which).sample(jnp.asarray(u.numpy()),
                                                   *getattr(jt, which + "_cond").shape[3:])
        slack = 1e-6 + 2 * 2.0 ** -24 * _inversion_conditioning(warp, pos)
        for a, b in ((pos, jpos), (pdf, jpdf)):
            a, b = a.numpy().reshape(n, -1), np.asarray(b).reshape(n, -1)
            off = (np.abs(a - b) > slack[:, None] + 1e-5 * np.abs(b)).any(-1)
            assert not off.any(), (which, np.nonzero(off)[0])
        warps.append((pos, pdf))
        u = pos
    wo, f, p, ok = rgl.rgl_sample(tt, _t(mid), _t(wi), _t(u2))
    jwo, jf, jp, jok = _jax_sample_tail(jfr, jnp.asarray(wi), *warps)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    for a, b in ((wo, jwo), (f, jf), (p, jp)):
        _close(a, b)
    jok = jrgl.rgl_sample(jt, jnp.asarray(mid), jnp.asarray(wi), jnp.asarray(u2))[3]
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert float(ok.float().mean()) > 0.4
    jf, jp = jrgl.rgl_eval(jt, jnp.asarray(mid), jnp.asarray(wi), jnp.asarray(wo.numpy()))
    f, p = rgl.rgl_eval(tt, _t(mid), _t(wi), wo)
    _close(f, jf)
    _close(p, jp)


def _upper(n, seed):
    rs = np.random.default_rng(seed)
    theta = rs.uniform(0.05, 1.4, n)
    phi = rs.uniform(-np.pi, np.pi, n)
    return _t(np.stack([np.cos(phi) * np.sin(theta), np.sin(phi) * np.sin(theta), np.cos(theta)],
                       -1).astype(np.float32))


def test_warp_sample_invert_roundtrip():
    """invert(sample(u)) gives back u and its density (Marginal2D identity)."""
    _, tt = _tables("city")
    n = 256
    fr = rgl._prepare(tt, torch.zeros(n, dtype=torch.int32), _upper(n, 1))
    warp = rgl._warp(tt, fr, "vndf")
    u = _t(np.random.default_rng(7).uniform(0.02, 0.98, (n, 2)).astype(np.float32))
    pos, pdf_s = warp.sample(u)
    u_back, pdf_i = warp.invert(pos)
    _close(u_back, u.numpy(), rtol=0, atol=2e-3)
    _close(pdf_i, pdf_s.numpy(), rtol=2e-3, atol=0)
    _close(warp.eval(pos), pdf_s.numpy(), rtol=2e-3, atol=0)


def test_sample_eval_consistency():
    """rgl_eval at a sampled direction gives the sample's f*cos and pdf."""
    _, tt = _tables("city")
    n = 512
    mid = torch.zeros(n, dtype=torch.int32)
    wi = _upper(n, 3)
    u2 = _t(np.random.default_rng(11).uniform(0.02, 0.98, (n, 2)).astype(np.float32))
    wo, f_s, pdf_s, ok = rgl.rgl_sample(tt, mid, wi, u2)
    f_e, pdf_e = rgl.rgl_eval(tt, mid, wi, wo)
    assert float(ok.float().mean()) > 0.5
    _close(pdf_e[ok], pdf_s[ok].numpy(), rtol=5e-3)
    _close(f_e[ok], f_s[ok].numpy(), rtol=5e-3)
    fs = f_s[ok].numpy()
    assert np.isfinite(f_s.numpy()).all() and (fs >= 0).all()
    np.testing.assert_allclose(fs[:, 3], fs[:, :3].mean(-1), rtol=1e-3, atol=1e-6)


def test_pdf_is_a_density():
    """Over the hemisphere the pdf integrates to rgl_sample's acceptance rate."""
    _, tt = _tables("city")
    n = 8192
    rs = np.random.default_rng(5)
    z = rs.uniform(1e-3, 1.0, n)
    r = np.sqrt(1 - z * z)
    ph = rs.uniform(-np.pi, np.pi, n)
    wo = _t(np.stack([r * np.cos(ph), r * np.sin(ph), z], -1).astype(np.float32))
    w = np.array([0.3, 0.1, 1.0], np.float32)
    wi = _t(np.tile(w / np.linalg.norm(w), (n, 1)).astype(np.float32))
    mid = torch.zeros(n, dtype=torch.int32)
    _, pdf = rgl.rgl_eval(tt, mid, wi, wo)
    integral = float(pdf.double().mean()) * 2.0 * np.pi
    u2 = _t(np.random.default_rng(17).uniform(0.001, 0.999, (n, 2)).astype(np.float32))
    accept = float(rgl.rgl_sample(tt, mid, wi, u2)[3].float().mean())
    assert abs(integral - accept) < 0.12, (integral, accept)
    assert 0.4 < integral <= 1.05, integral


def test_spectral_datasets_are_refused():
    fields = dict(scenes.city_rgl_fields(7))
    fields["spectra"] = fields.pop("rgb")
    with pytest.raises(NotImplementedError, match="spectral"):
        rgl.load_rgl_material(fields)


def test_wrappers_check_their_inputs():
    _, tt = _tables("city")
    mid, wi, wo, u2 = (_t(x) for x in _lanes(8, 1))
    with pytest.raises(ValueError, match="int32"):
        rgl.rgl_eval(tt, mid.long(), wi, wo)
    with pytest.raises(ValueError, match="float32"):
        rgl.rgl_sample(tt, mid, wi.double(), u2)
    with pytest.raises(ValueError, match=r"\(8, 2\)"):
        rgl.rgl_sample(tt, mid, wi, wo)


def _write_tensor_file(path, fields):
    """A tensor_file (powitacq_rgb.inl:729-801) holding `fields` as float32."""
    import struct

    header = [b"tensor_file\x00", bytes([1, 0]), struct.pack("<I", len(fields))]
    size = sum(len(h) for h in header) + sum(2 + len(k) + 3 + 8 + 8 * np.ndim(v)
                                             for k, v in fields.items())
    descs, blobs = [], []
    for k, v in fields.items():
        v = np.ascontiguousarray(v, np.float32)
        descs.append(struct.pack("<H", len(k)) + k.encode() + struct.pack("<HBQ", v.ndim, 10, size)
                     + struct.pack(f"<{v.ndim}Q", *v.shape))
        blobs.append(v.tobytes())
        size += v.nbytes
    path.write_bytes(b"".join(header + descs + blobs))


def test_tensor_file_reads_like_jax(tmp_path):
    fields = scenes.city_rgl_fields(7)
    _write_tensor_file(tmp_path / "city.bsdf", fields)
    ours = rgl.read_tensor_file(str(tmp_path / "city.bsdf"))
    ref = jrgl.read_tensor_file(str(tmp_path / "city.bsdf"))
    assert ours.keys() == ref.keys() == fields.keys()
    for k in fields:
        np.testing.assert_array_equal(ours[k], ref[k])
        np.testing.assert_array_equal(ours[k], fields[k])
    a = rgl.load_rgl_material(str(tmp_path / "city.bsdf"))
    b = rgl.load_rgl_material(fields)
    assert all(np.array_equal(a[k], b[k]) for k in a)
