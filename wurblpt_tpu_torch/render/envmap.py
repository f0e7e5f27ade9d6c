"""Environment maps: radiance lookup and importance sampling (port of
``wurblpt_tpu/render/envmap.py``: the equirect, cube and constant maps).

K8 is three entry points of one hand-written CUDA source
(``csrc/envmap.cu``): `env_radiance` (the equirect map's bilinear lookup,
wrap in u, clamp in v; the cube map's face pick and per-face bilinear lookup
with edge clamp; the constant map's radiance), `env_sample` (alias-table
pick of a cell of the R x R equal-area grid, then a uniform point in it)
and `env_pdf` (the pdf table at a direction's cell). Sampling and pdf do not
depend on the map's parameterization. Each wrapper launches the kernel on
CUDA tensors and runs its plain PyTorch version (`*_plain`, the JAX formulas
op for op) on CPU tensors. Where the direction, the image, the constant
radiance or the map's rotation requires grad, `env_radiance` runs on the
tape through `backward.EnvRadiance` (its backward is K8T); where the
rotation requires grad, so does `env_sample`'s direction
(`backward.EnvSample`). The pdfs carry no gradient: the sample's is a
lookup in the importance tables, which are not re-derived inside a loss
(nor are the JAX package's), and `env_pdf` is piecewise constant in its
direction.

The JAX package reads the four bilinear taps from a 16-channel "patch image"
so that one TPU gather serves them; the kernel and the plain versions read
the four texels directly (the same texels: the patch image's neighbours are
the clamped or wrapped ones read here).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..core.transform import quat_rotate
from ..core.vecmath import safe_sqrt
from ..core.color import vec4
from ..scene.ir import EnvMapArrays

_TWO_PI = 2.0 * math.pi
_FOUR_PI = 4.0 * math.pi


class EnvironmentMapEquiRect(NamedTuple):
    """Host descriptor of an equirect map (builder.EnvironmentMapEquiRect).

    `x_convention_surround` takes the surround-video x convention
    (envmap.hpp:235-242): u turned by half a revolution, a cyclic roll of
    the image by half its width, which needs an even width (an odd one
    raises ValueError, as in the JAX package). `rotation` is the map's
    world-from-map quaternion (x, y, z, w)."""

    image: np.ndarray                 # [H, W, 3|4] linear radiance
    importance_resolution: int = 0    # R of the R x R grid; 0: no importance sampling
    x_convention_surround: bool = False
    rotation: Optional[Sequence[float]] = None   # None: the identity


class EnvironmentMapCube(NamedTuple):
    """Host descriptor of a cube map (builder.EnvironmentMapCube)."""

    faces: Sequence[np.ndarray]       # 6 x [F, F, 3|4], order +x, -x, +y, -y, +z, -z
    importance_resolution: int = 0    # R of the R x R grid; 0: no importance sampling
    rotation: Optional[Sequence[float]] = None   # world-from-map quaternion; None: the identity


class EnvironmentMapConstant(NamedTuple):
    """Host descriptor of a constant sky (builder.EnvironmentMapConstant)."""

    radiance: Sequence[float] = (1.0, 1.0, 1.0)


def quat_conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], -1)


def _div(x, c):
    """x / c as a true division on every device (PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal instead, which K8 does not)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _fmod1(x):
    """x mod 1 with the sign of the divisor (jnp.mod): fmod, then + 1 below zero."""
    r = torch.fmod(x, 1.0)
    return torch.where((r != 0.0) & (r < 0.0), r + 1.0, r)


def square_to_sphere(uv):
    """[0,1]^2 to the unit sphere, equal-area (cylindrical); y is the polar axis."""
    phi = _TWO_PI * uv[..., 0]
    y = 2.0 * uv[..., 1] - 1.0
    r = safe_sqrt(1.0 - y * y)
    return torch.stack([r * torch.cos(phi), y, r * torch.sin(phi)], -1)


def sphere_to_square(d):
    """Inverse of square_to_sphere for unit directions."""
    u = _fmod1(_div(torch.atan2(d[..., 2], d[..., 0]), _TWO_PI))
    v = 0.5 * (torch.clamp(d[..., 1], -1.0, 1.0) + 1.0)
    return torch.stack([u, v], -1)


def _equirect_uv(d):
    """Mitsuba-convention equirect mapping: u = atan2(x, -z) / 2pi mod 1 (the
    round-5 form, +z at the centre column), v = acos(y) / pi (top = +y)."""
    u = _fmod1(_div(torch.atan2(d[..., 0], -d[..., 2]), _TWO_PI))
    v = _div(torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)), math.pi)
    return u, v


def _bilinear_wrap(img, u, v):
    """Bilinear lookup of img [H, W, 4], wrap in u, clamp in v."""
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = torch.remainder(x0.long(), w)
    y0i = torch.clamp(y0.long(), 0, h - 1)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    c00, c01 = img[y0i, x0i], img[y0i, x1i]
    c10, c11 = img[y1i, x0i], img[y1i, x1i]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def _cube_lookup(img, d):
    """Bilinear cube-map lookup of img [6, H, W, 4] (faces +x, -x, +y, -y, +z,
    -z) with edge clamp, as envmap.py:118-163 computes it: the face of the
    largest |component| (ties to x, then y), the standard per-face (sc, tc),
    texel coordinates clamped at 0 before the truncation."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)))
    ma = torch.clamp_min(torch.where(is_x, ax, torch.where(is_y, ay, az)), 1e-20)
    sc = torch.where(is_x, torch.where(x > 0, -z, z),
                     torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_x, -y, torch.where(is_y, torch.where(y > 0, z, -z), -y))
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    h, w = img.shape[1], img.shape[2]
    us = torch.clamp_min(u * w - 0.5, 0.0)
    vs = torch.clamp_min(v * h - 0.5, 0.0)
    x0 = torch.clamp(us.to(torch.int32), 0, w - 1)
    y0 = torch.clamp(vs.to(torch.int32), 0, h - 1)
    a = (us - x0.to(torch.float32))[:, None]
    b = (vs - y0.to(torch.float32))[:, None]
    face, x0, y0 = face.long(), x0.long(), y0.long()
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    c00, c10 = img[face, y0, x0], img[face, y0, x1]
    c01, c11 = img[face, y1, x0], img[face, y1, x1]
    return (c00 * (1 - a) + c10 * a) * (1 - b) + (c01 * (1 - a) + c11 * a) * b


def env_radiance_plain(env: EnvMapArrays, d):
    """Plain version of K8 radiance: [N, 4] radiance arriving from world directions d [N, 3]."""
    if env.kind == 3:
        return env.const_radiance.expand(d.shape[0], 4).contiguous()
    dm = quat_rotate(quat_conjugate(env.rotation), d)
    if env.kind == 2:
        return _cube_lookup(env.image, dm)
    u, v = _equirect_uv(dm)
    return _bilinear_wrap(env.image, u, v)


def env_sample_plain(env: EnvMapArrays, u3):
    """Plain version of K8 sample: (world direction [N, 3], solid-angle pdf [N])
    from uniforms u3 [N, 3] (cell pick by u3[:, 0], position in it by the rest)."""
    res = env.pdf_table.shape[0]
    n = res * res
    pdf_flat = env.pdf_table.reshape(n)
    cell = torch.clamp((u3[:, 0] * n).to(torch.int32), 0, n - 1).long()
    accept = u3[:, 0] * n - cell.to(torch.float32)
    take_alias = accept > env.alias_prob[cell]
    cell = torch.where(take_alias, env.alias_idx[cell].long(), cell)
    pdf = pdf_flat[cell]
    ci = cell // res
    cj = cell % res
    u = _div(cj.to(torch.float32) + u3[:, 1], float(res))
    v = _div(ci.to(torch.float32) + u3[:, 2], float(res))
    return quat_rotate(env.rotation, square_to_sphere(torch.stack([u, v], -1))), pdf


def env_pdf_plain(env: EnvMapArrays, d):
    """Plain version of K8 pdf: solid-angle pdf [N] of env_sample giving direction d."""
    res = env.pdf_table.shape[0]
    uv = sphere_to_square(quat_rotate(quat_conjugate(env.rotation), d))
    cj = torch.clamp((uv[:, 0] * res).to(torch.int32), 0, res - 1).long()
    ci = torch.clamp((uv[:, 1] * res).to(torch.int32), 0, res - 1).long()
    return env.pdf_table[ci, cj]


def _check(name, env: EnvMapArrays, x, cols):
    n = x.shape[0]
    if x.dtype != torch.float32 or tuple(x.shape) != (n, cols) or not x.is_contiguous():
        raise ValueError(f"{name}: need contiguous float32 ({n}, {cols}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    shapes = {1: "[H, W, 4] equirect", 2: "[6, H, W, 4] cube", 3: "[1, 1, 4] constant"}
    img = env.image
    ok = {1: img.ndim == 3, 2: img.ndim == 4 and img.shape[0] == 6, 3: True}.get(env.kind)
    if not ok or img.shape[-1] != 4:
        raise ValueError(f"{name}: kind {env.kind} needs a {shapes.get(env.kind, 'known kind')} "
                         f"image, got {tuple(img.shape)}")
    if env.image.device != x.device:
        raise ValueError(f"{name}: envmap on {env.image.device}, rays on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def env_radiance(env: EnvMapArrays, d):
    """Radiance [N, 4] from world directions d [N, 3] (K8). Where d, the
    image, the constant radiance or the rotation requires grad (and grad
    mode is on), the lookup is on the tape: its backward is K8T
    (render/backward.py `EnvRadiance`)."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (d, env.image, env.const_radiance, env.rotation)):
        from .backward import EnvRadiance

        return EnvRadiance.apply(env, d, env.image, env.const_radiance, env.rotation)
    return env_radiance_raw(env, d)


def env_radiance_raw(env: EnvMapArrays, d):
    """K8 radiance without a tape: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check("env_radiance", env, d, 3)
    if d.device.type == "cpu":
        return env_radiance_plain(env, d)
    lib = native.load_kernels()
    n = d.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=d.device)
    h, w = env.image.shape[-3], env.image.shape[-2]
    code = lib.wpt_env_radiance(d.data_ptr(), n, env.kind, env.image.data_ptr(), h, w,
                                env.rotation.data_ptr(), env.const_radiance.data_ptr(),
                                out.data_ptr(), native.stream_ptr(d))
    native.check(code, "env_radiance")
    native.LAUNCHES["env_radiance"] += 1
    return out


def env_sample(env: EnvMapArrays, u3):
    """Importance-sampled world direction [N, 3] and its pdf [N] from uniforms
    u3 [N, 3] (K8). Where the rotation requires grad (and grad mode is on),
    the direction R(q) d_map is on the tape: its backward is K8T's sample
    backward (render/backward.py `EnvSample`); the pdf carries none."""
    if torch.is_grad_enabled() and env.rotation.requires_grad:
        from .backward import EnvSample

        return EnvSample.apply(env, u3, env.rotation)
    return env_sample_raw(env, u3)


def env_sample_raw(env: EnvMapArrays, u3):
    """K8 sample without a tape: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check("env_sample", env, u3, 3)
    if not env.importance:
        raise ValueError("env_sample: the envmap has no importance tables")
    if u3.device.type == "cpu":
        return env_sample_plain(env, u3)
    lib = native.load_kernels()
    n = u3.shape[0]
    d = torch.empty((n, 3), dtype=torch.float32, device=u3.device)
    pdf = torch.empty((n,), dtype=torch.float32, device=u3.device)
    code = lib.wpt_env_sample(u3.data_ptr(), n, env.pdf_table.data_ptr(),
                              env.alias_prob.data_ptr(), env.alias_idx.data_ptr(),
                              env.pdf_table.shape[0], env.rotation.detach().contiguous().data_ptr(),
                              d.data_ptr(),
                              pdf.data_ptr(), native.stream_ptr(u3))
    native.check(code, "env_sample")
    native.LAUNCHES["env_sample"] += 1
    return d, pdf


def env_pdf(env: EnvMapArrays, d):
    """Solid-angle pdf [N] of env_sample having produced world directions d
    [N, 3] (K8). Piecewise constant in d (the pdf table at d's cell), so it
    carries no gradient to d or to the rotation, in either package: never
    on the tape."""
    _check("env_pdf", env, d, 3)
    if not env.importance:
        raise ValueError("env_pdf: the envmap has no importance tables")
    if d.device.type == "cpu":
        return env_pdf_plain(env, d)
    lib = native.load_kernels()
    n = d.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=d.device)
    code = lib.wpt_env_pdf(d.data_ptr(), n, env.pdf_table.data_ptr(), env.pdf_table.shape[0],
                           env.rotation.data_ptr(), out.data_ptr(), native.stream_ptr(d))
    native.check(code, "env_pdf")
    native.LAUNCHES["env_pdf"] += 1
    return out


def _build_alias_table(weights: np.ndarray):
    """Vose's O(n) alias method. weights: flat nonnegative, sum > 0."""
    n = weights.size
    prob = weights * n / weights.sum()
    alias = np.zeros(n, np.int32)
    accept = np.ones(n, np.float64)
    small = [i for i in range(n) if prob[i] < 1.0]
    large = [i for i in range(n) if prob[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        accept[s] = prob[s]
        alias[s] = g
        prob[g] = prob[g] - (1.0 - prob[s])
        (small if prob[g] < 1.0 else large).append(g)
    for rest in (small, large):
        for i in rest:
            accept[i] = 1.0
            alias[i] = i
    return accept.astype(np.float32), alias


def build_envmap_arrays(desc, device) -> EnvMapArrays:
    """Equirect, cube or constant descriptor -> EnvMapArrays on `device`
    (envmap.build_envmap_arrays).

    The importance grid evaluates the plain radiance lookup, the map's
    rotation included, at the cell centres of the equal-area map, on the
    CPU, as the JAX package does on its backend. The constant map gets no
    tables."""
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0])
    no_tables = (torch.zeros((0, 0)), torch.zeros((0,)), torch.zeros((0,), dtype=torch.int32))
    if isinstance(desc, EnvironmentMapConstant):
        return EnvMapArrays(3, torch.zeros((1, 1, 4)), *no_tables, ident,
                            torch.as_tensor(vec4(desc.radiance))).to(device)

    def rgbn(a):
        a = np.asarray(a, np.float32)
        return np.concatenate([a, a.mean(-1, keepdims=True)], -1) if a.shape[-1] == 3 else a

    if isinstance(desc, EnvironmentMapCube):
        kind, img = 2, np.stack([rgbn(f) for f in desc.faces], 0)
    elif isinstance(desc, EnvironmentMapEquiRect):
        kind, img = 1, rgbn(desc.image)
        if desc.x_convention_surround:
            # A half-turn u offset from the Mitsuba default, not a mirror: a
            # cyclic roll by half the width, exact for even widths as u wraps.
            if img.shape[1] % 2:
                raise ValueError("x_convention_surround needs an even-width equirect image")
            img = np.roll(img, img.shape[1] // 2, axis=1)
    else:
        raise TypeError(f"unknown envmap descriptor {desc!r}")
    rot = ident if desc.rotation is None else torch.as_tensor(np.asarray(desc.rotation,
                                                                         np.float32))
    base = EnvMapArrays(kind, torch.as_tensor(img), *no_tables, rot, torch.zeros((4,)))
    res = desc.importance_resolution
    if not res:
        return base.to(device)
    ii, jj = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    uv = np.stack([(jj + 0.5) / res, (ii + 0.5) / res], -1).astype(np.float32)
    dirs = square_to_sphere(torch.as_tensor(uv)).reshape(-1, 3)
    rad = env_radiance_plain(base, dirs).numpy().reshape(res, res, 4)
    lum = 0.2126 * rad[..., 0] + 0.7152 * rad[..., 1] + 0.0722 * rad[..., 2] + 1e-12
    cell_prob = lum / lum.sum()
    pdf_table = (cell_prob / (_FOUR_PI / (res * res))).astype(np.float32)
    accept, alias = _build_alias_table(cell_prob.reshape(-1).astype(np.float64))
    return base._replace(pdf_table=torch.as_tensor(pdf_table), alias_prob=torch.as_tensor(accept),
                         alias_idx=torch.as_tensor(alias)).to(device)
