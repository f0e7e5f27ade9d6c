"""K8's lane mask and its two pairs (``render/envmap.py``: `env_miss_lanes`,
radiance and pdf of given directions; `env_nee_lanes`, a sample and the
radiance of its direction; each one launch of ``csrc/envmap.cu``
`env_lanes_kernel<SAMPLE>`), the generic bounce's use of them
(``render/wavefront.py`` `env_miss`, `env_nee`), their autograd Functions
(``render/backward.py`` `EnvMiss`, `EnvNee`) and the sky-yaw step's lanes
(``utils/grad_check.py`` `sky_yaw_lanes`).

* The masked plain versions equal the JAX package's `env_radiance`,
  `env_sample` and `env_pdf` on the lanes in the mask (the tolerances of
  tests/test_torch_envmap.py: rtol 1e-5 / atol 1e-6 on the equirect map,
  rtol 1e-6 on the cube map, equal on the constant one; pdfs off on at most
  1e-3 of the lanes), and the fixed values elsewhere: radiance and pdf 0,
  the sampled direction the map's +z axis in the world. Equirect, cube and
  constant skies, masks and uniforms from numpy seeds.
* The pairs' plain versions equal the single ones in turn, bit for bit, and
  a mask of every lane gives the unmasked bits.
* The kernel's device code built with g++ (``tests/cuda_host/envmap.cpp``:
  envmap.cu cut at its C entry point) under a mask equals the plain version
  on every kind: bit for bit on the cube's and the constant sky's radiance
  of given directions, on the sample's pdfs and on every masked lane;
  elsewhere the directions within 4e-7 and the radiance within 1e-4 of its
  largest magnitude (the host's libm against PyTorch's atan2f, acosf, sinf
  and cosf: an ulp of a direction moves the bilinear weights).
  The pairs equal the kernel's single outputs launched in turn, bit for
  bit.
* The bounce's forward keeps its bits: the sky-yaw loss at 16 x 16, 4 spp
  equals the loss with the earlier env_miss and env_nee (each output over
  every lane, four launches a bounce), and its gradient agrees within rtol
  1e-5; the pairs' backward equals autograd through their plain versions
  (rtol 1e-4 of each output's largest), masked lanes add nothing and every
  cotangent is finite.
* `sky_yaw_lanes` at 32 x 32, 4 spp: each bounce's shares of active,
  escaped, env-NEE and cotangent-carrying lanes within 0.01 of the 64 x
  64, 4 spp step's (SHARES)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_envmap import _close, _cubes, _dirs, _envs, _pdf_agree
from wurblpt_tpu.render import envmap as jenvmap
from wurblpt_tpu.scene.builder import EnvironmentMapConstant as JConstant
from wurblpt_tpu_torch import native
from wurblpt_tpu_torch.core.sampler import power_heuristic
from wurblpt_tpu_torch.core.transform import quat_rotate
from wurblpt_tpu_torch.native import SRC_DIR
from wurblpt_tpu_torch.render import envmap, integrator
from wurblpt_tpu_torch.render.bsdf import bsdf_eval
from wurblpt_tpu_torch.render.intersect_brute import BIG
from wurblpt_tpu_torch.render.sensor import SensorEvent
from wurblpt_tpu_torch.utils import grad_check as gc

torch.set_num_threads(2)

HOST = SRC_DIR.parent.parent / "tests" / "cuda_host"
N = 8192
ROTATION = (0.1, 0.3, -0.2, 0.9)   # grad_check.SKY_ROTATION, normalized below
# The sky-yaw step's shares of all lanes at 64 x 64, 4 spp, bounces 0-7
# (ROADMAP B.2's measurement): active, escaped, env NEE, cotangent into
# K8T's sample backward.
SHARES = {"active": [1.0, 0.307, 0.097, 0.055, 0.018, 0.010, 0.004, 0.002],
          "escaped": [0.692, 0.209, 0.042, 0.037, 0.009, 0.004, 0.001, 0.0007],
          "env_nee": [0.244, 0.042, 0.034, 0.011, 0.006, 0.003, 0.002, 0.0005],
          "cotangent": [0.094, 0.012, 0.011, 0.0024, 0.0014, 0.0007, 0.0004, 0.0001]}
SHARE_TOL = 0.01


def _constant():
    jenv = jenvmap.build_envmap_arrays(JConstant(radiance=(0.7, 0.8, 1.0)))
    return jenv, envmap.build_envmap_arrays(envmap.EnvironmentMapConstant((0.7, 0.8, 1.0)), "cpu")


def _sky(kind):
    """(JAX sky, the port's) of `kind`; the JAX sky reads the port's
    importance tables (the cube's differ from JAX's own by rtol 4e-7,
    tests/test_torch_envmap.py), so that both sample the same cells."""
    jenv, env = {"equirect": _envs, "cube": _cubes, "constant": _constant}[kind]()
    if env.importance:
        jenv = jenv._replace(pdf_table=jnp.asarray(env.pdf_table.numpy()),
                             alias_prob=jnp.asarray(env.alias_prob.numpy()),
                             alias_idx=jnp.asarray(env.alias_idx.numpy()))
    return jenv, env


def _mask(n=N, share=0.3, seed=11):
    return torch.as_tensor(np.random.default_rng(seed).uniform(size=n) < share)


def _uniforms(n=N, seed=12):
    return torch.as_tensor(np.random.default_rng(seed).uniform(size=(n, 3)).astype(np.float32))


def _rotated(env):
    q = torch.tensor(ROTATION)
    return env._replace(rotation=q / torch.linalg.norm(q))


@pytest.mark.parametrize("kind", ["equirect", "cube", "constant"])
def test_masked_plain_versions_match_jax(kind):
    jenv, env = _sky(kind)
    d, active = torch.from_numpy(_dirs("random")), _mask()
    rtol = 1e-6 if kind == "cube" else 1e-5
    r = envmap.env_radiance_plain(env, d, active)
    _close(r[active], jenvmap.env_radiance(jenv, jnp.asarray(d[active].numpy())), rtol=rtol,
           atol=0.0 if kind == "cube" else 1e-6)
    assert not bool(r[~active].any())
    if kind == "constant":
        return
    p = envmap.env_pdf_plain(env, d, active)
    _pdf_agree(p[active], jenvmap.env_pdf(jenv, jnp.asarray(d[active].numpy())))
    assert not bool(p[~active].any())
    u3 = _uniforms()
    sd, spdf = envmap.env_sample_plain(env, u3, active)
    jd, jpdf = jenvmap.env_sample(jenv, jnp.asarray(u3[active].numpy()))
    _close(sd[active], jd)
    np.testing.assert_array_equal(spdf[active].numpy(), np.asarray(jpdf))
    assert not bool(spdf[~active].any())
    assert torch.equal(sd[~active], torch.tensor([[0.0, 0.0, 1.0]]).expand(int((~active).sum()), 3))


def test_skipped_direction_is_the_maps_z_axis_and_a_constant():
    _, env = _envs()
    env = _rotated(env)._replace(rotation=_rotated(env).rotation.requires_grad_(True))
    d, _ = envmap.env_sample_plain(env, _uniforms(64), torch.zeros(64, dtype=torch.bool))
    z = quat_rotate(env.rotation.detach(), torch.tensor([[0.0, 0.0, 1.0]]))
    assert torch.equal(d, z.expand(64, 3))
    if d.requires_grad:   # the masked lanes carry no cotangent to the rotation
        g = torch.autograd.grad(d.sum(), env.rotation, allow_unused=True)[0]
        assert g is None or not bool(g.any())


@pytest.mark.parametrize("masked", [False, True], ids=["every lane", "masked"])
@pytest.mark.parametrize("kind", ["equirect", "cube", "constant"])
def test_pairs_equal_the_single_plain_versions(kind, masked):
    _, env = _sky(kind)
    d = torch.from_numpy(_dirs("random"))
    active = _mask() if masked else None
    importance = env.importance
    rad, pdf = envmap.env_miss_plain(env, d, active, importance)
    assert torch.equal(rad, envmap.env_radiance_plain(env, d, active))
    if importance:
        assert torch.equal(pdf, envmap.env_pdf_plain(env, d, active))
        u3 = _uniforms()
        sd, spdf, srad = envmap.env_nee_plain(env, u3, active)
        ed, epdf = envmap.env_sample_plain(env, u3, active)
        assert torch.equal(sd, ed) and torch.equal(spdf, epdf)
        assert torch.equal(srad, envmap.env_radiance_plain(env, ed, active))
    else:
        assert pdf is None


@pytest.mark.parametrize("kind", ["equirect", "cube"])
def test_a_mask_of_every_lane_keeps_the_unmasked_bits(kind):
    _, env = _sky(kind)
    d, u3 = torch.from_numpy(_dirs("random")), _uniforms()
    every = torch.ones(N, dtype=torch.bool)
    for a, b in zip(envmap.env_miss_plain(env, d), envmap.env_miss_plain(env, d, every)):
        assert torch.equal(a, b)
    for a, b in zip(envmap.env_nee_plain(env, u3), envmap.env_nee_plain(env, u3, every)):
        assert torch.equal(a, b)


def test_wrappers_take_the_plain_version_on_cpu_and_check_the_mask():
    _, env = _envs()
    d, u3, active = torch.from_numpy(_dirs("random")), _uniforms(), _mask()
    counts = dict(native.LAUNCHES)
    for a, b in zip(envmap.env_miss_lanes(env, d, active), envmap.env_miss_plain(env, d, active)):
        assert torch.equal(a, b)
    for a, b in zip(envmap.env_nee_lanes(env, u3, active), envmap.env_nee_plain(env, u3, active)):
        assert torch.equal(a, b)
    assert torch.equal(envmap.env_radiance(env, d, active),
                       envmap.env_radiance_plain(env, d, active))
    assert native.LAUNCHES == counts           # no kernel ran
    for bad in (active.to(torch.uint8), active[:-1], active[None]):
        with pytest.raises(ValueError, match="mask"):
            envmap.env_miss_lanes(env, d, bad)
    with pytest.raises(ValueError, match="importance"):
        envmap.env_nee_lanes(_constant()[1], u3, active)


# ---------------------------------------------------------------------------
# The kernel's device code built with g++
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The host build of envmap.cu's device code (tests/cuda_host/envmap.cpp)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("envmap")
    src = (SRC_DIR / "envmap.cu").read_text()
    (out / "envmap_device.cuh").write_text(src[:src.index('extern "C"')])
    so = out / "libenvmap.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{out}", f"-I{HOST}", f"-I{SRC_DIR}", "-o", str(so),
                    str(HOST / "envmap.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.host_env_lanes.argtypes = native._SIGNATURES["wpt_env_lanes"][:-1]
    return lib


def _host_lanes(lib, env, sample, x, active, pdf=True, rad=True):
    n = x.shape[0]
    out = (torch.full((n, 3), float("nan")) if sample else None,
           torch.full((n,), float("nan")) if pdf else None,
           torch.full((n, 4), float("nan")) if rad else None)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    tables = sample or pdf
    assert lib.host_env_lanes(int(sample), x.data_ptr(), ptr(active), n, env.kind,
                              env.image.data_ptr(), env.image.shape[-3], env.image.shape[-2],
                              env.rotation.data_ptr(), env.const_radiance.data_ptr(),
                              ptr(env.pdf_table if tables else None),
                              ptr(env.alias_prob if sample else None),
                              ptr(env.alias_idx if sample else None),
                              env.pdf_table.shape[0] if tables else 0, *map(ptr, out)) == 0
    return out


def _held(got, ref, active, name, exact):
    """The host build's output against the plain version's: bit for bit on
    the masked lanes (and everywhere where `exact`); else the pdfs off on at
    most 1e-3 of the lanes (an ulp across a cell edge), the sampled
    directions within 4e-7 (a few ulps of a unit vector) and the radiance
    within 1e-4 of its largest magnitude: the host's libm against
    PyTorch's (atan2f, acosf, sinf, cosf: ~10 % of the sampled directions
    an ulp apart), whose ulp moves the bilinear weights, which the sun's
    edge in the sky magnifies to 3e-4 of a lane's own value."""
    assert torch.equal(got[~active], ref[~active]), f"{name}: masked lanes"
    if exact:
        assert torch.equal(got, ref), f"{name} not bit-equal"
    elif name == "pdf":
        assert float((got != ref).float().mean()) <= 1e-3, name
    else:
        err = float((got - ref).abs().max())
        tol = 4e-7 if name == "direction" else 1e-4 * float(ref.abs().max()) + 1e-6
        assert err <= tol, f"{name}: {err} beyond {tol}"


@pytest.mark.parametrize("rotated", [False, True], ids=["identity", "rotated"])
@pytest.mark.parametrize("kind", ["equirect", "cube", "constant"])
def test_kernel_device_code_under_a_mask(lib, kind, rotated):
    """env_lanes_kernel<false> (radiance and pdf) and <true> (sample and its
    radiance) under a mask (~30 % of the lanes, scattered; also every lane
    and none), and without one, against the plain versions."""
    _, env = _sky(kind)
    env = _rotated(env) if rotated else env
    d, u3 = torch.from_numpy(_dirs("random")), _uniforms()
    for active in (_mask(), torch.ones(N, dtype=torch.bool), torch.zeros(N, dtype=torch.bool),
                   None):
        mask = torch.ones(N, dtype=torch.bool) if active is None else active
        pdf = env.importance
        got = _host_lanes(lib, env, False, d, active, pdf=pdf)
        ref = envmap.env_miss_plain(env, d, active, pdf)
        _held(got[2], ref[0], mask, "radiance", kind != "equirect")
        if pdf:
            _held(got[1], ref[1], mask, "pdf", False)
        if not env.importance:
            continue
        got = _host_lanes(lib, env, True, u3, active)
        ref = envmap.env_nee_plain(env, u3, active)
        for name, a, b in zip(("direction", "pdf", "radiance"), got, ref):
            _held(a, b, mask, name, name == "pdf")


def test_kernel_device_code_pair_equals_its_single_outputs(lib):
    """The pairs' outputs equal the kernel's single outputs launched in turn
    (the sample's radiance looked up from the world direction it wrote),
    bit for bit, on the host's libm too."""
    _, env = _envs()
    env = _rotated(env)
    u3, active = _uniforms(), _mask()
    d, p, r = _host_lanes(lib, env, True, u3, active)
    d1, p1, _ = _host_lanes(lib, env, True, u3, active, rad=False)
    _, _, r1 = _host_lanes(lib, env, False, d1, active, pdf=False)
    assert torch.equal(d, d1) and torch.equal(p, p1) and torch.equal(r, r1)


# ---------------------------------------------------------------------------
# The bounce and the backward
# ---------------------------------------------------------------------------

def _env_miss_all_lanes(sensor, acc, st, env, prim, importance):
    """env_miss as it was: radiance and pdf over every lane, two launches."""
    L_env = envmap.env_radiance(env, st.d)
    if importance:
        w_env = torch.where(st.prev_random,
                            power_heuristic(st.prev_pdf, envmap.env_pdf(env, st.d)), 1.0)
    else:
        w_env = torch.ones_like(st.prev_pdf)
    return sensor.accumulate(acc, SensorEvent(
        radiance=st.throughput * L_env * w_env[:, None], path_component=st.bounce,
        geom_path_length=st.geom_len, optical_path_length=st.opt_len,
        distance_to_light=torch.zeros_like(st.geom_len), active=st.active & (prim < 0)))


def _env_nee_all_lanes(sensor, env, st, hr, mrow, mat_types, rgl, ue, is_random, geom_len,
                       opt_len):
    """env_nee as it was: a sample and its radiance over every lane."""
    edir, epdf = envmap.env_sample(env, ue)
    f_e, pdf_be = bsdf_eval(hr, st.d, edir, mrow, mat_types, rgl=rgl)
    w_e = power_heuristic(epdf, pdf_be)
    contrib_e = (st.throughput * f_e * envmap.env_radiance(env, edir)
                 * (w_e / torch.clamp_min(epdf, 1e-12))[:, None])
    dep, ok = sensor.deposit(SensorEvent(
        radiance=contrib_e, path_component=st.bounce, geom_path_length=geom_len,
        optical_path_length=opt_len, distance_to_light=torch.zeros_like(geom_len),
        active=is_random & (epdf > 1e-12)))
    return edir, torch.where(is_random, BIG, 0.0), torch.where(ok[:, None], dep, 0.0)


def _yaw_step(width=16, ssqrt=2):
    yaw = torch.tensor(gc.SKY_YAW, requires_grad=True)
    value = gc.sky_yaw_loss("cpu", width, ssqrt)(yaw)
    value.backward()
    return value.detach(), yaw.grad


def test_sky_yaw_step_keeps_its_forward_bits_and_its_gradient(monkeypatch):
    value, grad = _yaw_step()
    monkeypatch.setattr(integrator, "env_miss", _env_miss_all_lanes)
    monkeypatch.setattr(integrator, "env_nee", _env_nee_all_lanes)
    value_all, grad_all = _yaw_step()
    assert torch.equal(value, value_all)
    assert torch.isfinite(grad) and float(grad) != 0.0
    torch.testing.assert_close(grad, grad_all, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("kind", ["equirect", "cube", "constant"])
def test_pair_functions_backward_equals_autograd_through_the_plain_versions(kind):
    """EnvMiss and EnvNee (K8T's radiance backward, then its sample backward
    on the directions' cotangent plus K8T's) against autograd through
    env_miss_plain / env_nee_plain under the same mask, with the image, the
    constant radiance and the rotation (turned by ROTATION) on the tape:
    each cotangent within 1e-4 of its largest, every entry finite."""
    _, env = _sky(kind)
    env = _rotated(env)
    d, u3, active = torch.from_numpy(_dirs("random")), _uniforms(), _mask()
    rs = np.random.default_rng(13)
    w_rad = torch.as_tensor(rs.normal(size=(N, 4)).astype(np.float32))
    w_dir = torch.as_tensor(rs.normal(size=(N, 3)).astype(np.float32))

    def grads(fn, nee):
        leaves = [x.clone().requires_grad_(True)
                  for x in (env.image, env.const_radiance, env.rotation)]
        e = env._replace(image=leaves[0], const_radiance=leaves[1], rotation=leaves[2])
        dd = d.clone().requires_grad_(True)
        if nee:
            sd, _, rad = fn(e, u3, active)
            loss = (w_rad * rad).sum() + (w_dir * sd).sum()
        else:
            rad, _ = fn(e, dd, active, e.importance)
            loss = (w_rad * rad).sum()
        out = torch.autograd.grad(loss, leaves + ([] if nee else [dd]), allow_unused=True)
        return [torch.zeros(()) if g is None else g for g in out]

    pairs = [(envmap.env_miss_lanes, envmap.env_miss_plain, False)]
    if env.importance:
        pairs.append((envmap.env_nee_lanes, envmap.env_nee_plain, True))
    for fn, plain, nee in pairs:
        got, ref = grads(fn, nee), grads(plain, nee)
        for g, r in zip(got, ref):
            assert bool(torch.isfinite(g).all())
            scale = float(r.abs().max()) if r.numel() else 0.0
            assert float((g - r).abs().max()) <= 1e-4 * scale + 1e-6
        if not nee:   # the masked lanes' direction cotangent is zero
            assert not bool(got[3][~active].any())


def test_sky_yaw_lanes_shares():
    lanes = gc.sky_yaw_lanes("cpu", 32, 2)
    n = 32 * 32 * 4
    assert len(lanes["miss"]) == len(lanes["nee"]) == len(lanes["sample_bwd"]) == gc.GRAD_DEPTH
    shares = gc.sky_yaw_shares(lanes)
    for key, want in SHARES.items():
        np.testing.assert_allclose(shares[key], want, rtol=0, atol=SHARE_TOL, err_msg=key)
    for (u3, g), (ue, rnd) in zip(lanes["sample_bwd"], lanes["nee"]):
        assert u3.shape == (n, 3) and torch.equal(u3, ue)
        assert not bool(g[~rnd].any())         # a lane without env NEE carries none
    env = lanes["env"]
    assert env.kind == 1 and env.importance and not env.rotation.requires_grad
