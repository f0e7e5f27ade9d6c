"""Environment maps: radiance lookup and importance sampling (port of
``wurblpt_tpu/render/envmap.py``: the equirect, cube and constant maps).

K8 is one hand-written CUDA kernel (``csrc/envmap.cu`` `env_lanes_kernel`)
behind five entry points: `env_radiance` (the equirect map's bilinear
lookup, wrap in u, clamp in v; the cube map's face pick and per-face
bilinear lookup with edge clamp; the constant map's radiance), `env_sample`
(alias-table pick of a cell of the R x R equal-area grid, then a uniform
point in it) and `env_pdf` (the pdf table at a direction's cell), and the
two pairs that a bounce of the generic path asks for: `env_miss_lanes`
(radiance and pdf of given directions) and `env_nee_lanes` (a sample and
the radiance of its direction), one launch each. Sampling and pdf do not
depend on the map's parameterization. Each takes an optional `active` mask
[N]: a lane outside it does no lookup, its radiance is 0, its pdf 0 and its
sampled direction `skipped_direction` (the map's +z axis), a constant under
autograd; without a mask every lane is computed. Each wrapper launches the kernel on CUDA
tensors and runs its plain PyTorch version (`*_plain`, the JAX formulas op
for op, the pairs the single versions in turn) on CPU tensors. Where the
direction, the image, the constant radiance or the map's rotation requires
grad, a radiance is on the tape through `backward.EnvRadiance`, `EnvMiss`
or `EnvNee` (its backward is K8T); where the rotation requires grad, so is
a sampled direction (`backward.EnvSample`, `EnvNee`: K8T's sample
backward). The pdfs carry no gradient: the sample's is a lookup in the
importance tables, which are not re-derived inside a loss (nor are the JAX
package's), and `env_pdf` is piecewise constant in its direction.

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
# The sampled direction of a lane outside a sample's `active` mask: the
# map's +z axis, turned into the world by its rotation (`skipped_direction`).
SKIPPED_MAP_DIRECTION = (0.0, 0.0, 1.0)


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


def env_radiance_plain(env: EnvMapArrays, d, active=None):
    """Plain version of K8 radiance: [N, 4] radiance arriving from world
    directions d [N, 3]; 0 on the lanes outside `active` [N] (bool) where
    given."""
    if active is not None:
        out = torch.zeros((d.shape[0], 4), dtype=torch.float32, device=d.device)
        out[active] = env_radiance_plain(env, d[active])
        return out
    if env.kind == 3:
        return env.const_radiance.expand(d.shape[0], 4).contiguous()
    dm = quat_rotate(quat_conjugate(env.rotation), d)
    if env.kind == 2:
        return _cube_lookup(env.image, dm)
    u, v = _equirect_uv(dm)
    return _bilinear_wrap(env.image, u, v)


def env_sample_plain(env: EnvMapArrays, u3, active=None):
    """Plain version of K8 sample: (world direction [N, 3], solid-angle pdf [N])
    from uniforms u3 [N, 3] (cell pick by u3[:, 0], position in it by the
    rest); on the lanes outside `active` where given, skipped_direction and
    pdf 0."""
    if active is not None:
        n = u3.shape[0]
        d = skipped_direction(env).repeat(n, 1)
        pdf = torch.zeros((n,), dtype=torch.float32, device=u3.device)
        d[active], pdf[active] = env_sample_plain(env, u3[active])
        return d, pdf
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


def skipped_direction(env: EnvMapArrays):
    """[1, 3]: the sampled direction of a lane outside a sample's mask, the
    map's +z axis in the world (quat_rotate(q, (0, 0, 1)), q detached: a
    constant under autograd). A lookup there has a regular backward (no
    pole of the equirect map, whatever q), so a masked lane's zero
    cotangent stays finite."""
    z = torch.tensor([SKIPPED_MAP_DIRECTION], dtype=torch.float32, device=env.rotation.device)
    return quat_rotate(env.rotation.detach(), z)


def env_pdf_plain(env: EnvMapArrays, d, active=None):
    """Plain version of K8 pdf: solid-angle pdf [N] of env_sample giving
    direction d; 0 on the lanes outside `active` where given."""
    if active is not None:
        out = torch.zeros((d.shape[0],), dtype=torch.float32, device=d.device)
        out[active] = env_pdf_plain(env, d[active])
        return out
    res = env.pdf_table.shape[0]
    uv = sphere_to_square(quat_rotate(quat_conjugate(env.rotation), d))
    cj = torch.clamp((uv[:, 0] * res).to(torch.int32), 0, res - 1).long()
    ci = torch.clamp((uv[:, 1] * res).to(torch.int32), 0, res - 1).long()
    return env.pdf_table[ci, cj]


def env_miss_plain(env: EnvMapArrays, d, active=None, pdf: bool = True):
    """Plain version of `env_miss_lanes`: (env_radiance_plain, env_pdf_plain
    or None without `pdf`) of the same lanes."""
    return (env_radiance_plain(env, d, active),
            env_pdf_plain(env, d, active) if pdf else None)


def env_nee_plain(env: EnvMapArrays, u3, active=None):
    """Plain version of `env_nee_lanes`: env_sample_plain's (direction, pdf),
    then env_radiance_plain of that direction on the same lanes."""
    d, pdf = env_sample_plain(env, u3, active)
    return d, pdf, env_radiance_plain(env, d, active)


def _check(name, env: EnvMapArrays, x, cols, active=None):
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
    if active is not None and (active.dtype != torch.bool or tuple(active.shape) != (n,)
                               or not active.is_contiguous() or active.device != x.device):
        raise ValueError(f"{name}: need a contiguous bool mask ({n},) on {x.device}, got "
                         f"{active.dtype} {tuple(active.shape)} on {active.device}")


def _check_tables(name, env: EnvMapArrays):
    if not env.importance:
        raise ValueError(f"{name}: the envmap has no importance tables")


def _on_tape(env: EnvMapArrays, *xs) -> bool:
    return torch.is_grad_enabled() and any(
        x.requires_grad for x in (*xs, env.image, env.const_radiance, env.rotation))


def _lanes(name, env: EnvMapArrays, sample: bool, x, active, pdf: bool, rad: bool):
    """One launch of K8's kernel (`wpt_env_lanes`) on CUDA tensors, counted
    under `name`: (directions [N, 3] where `sample`, pdf [N] where `pdf`,
    radiance [N, 4] where `rad`; None for each output not asked for)."""
    lib = native.load_kernels()
    n, dev = x.shape[0], x.device
    d_out = torch.empty((n, 3), dtype=torch.float32, device=dev) if sample else None
    pdf_out = torch.empty((n,), dtype=torch.float32, device=dev) if pdf else None
    rad_out = torch.empty((n, 4), dtype=torch.float32, device=dev) if rad else None
    tables = sample or pdf
    rot = env.rotation.detach().contiguous()
    code = lib.wpt_env_lanes(int(sample), x.data_ptr(), _ptr(active), n, env.kind,
                             env.image.data_ptr(), env.image.shape[-3], env.image.shape[-2],
                             rot.data_ptr(), env.const_radiance.data_ptr(),
                             _ptr(env.pdf_table if tables else None),
                             _ptr(env.alias_prob if sample else None),
                             _ptr(env.alias_idx if sample else None),
                             env.pdf_table.shape[0] if tables else 0, _ptr(d_out),
                             _ptr(pdf_out), _ptr(rad_out), native.stream_ptr(x))
    native.check(code, name)
    native.LAUNCHES[name] += 1
    return d_out, pdf_out, rad_out


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def env_radiance(env: EnvMapArrays, d, active=None):
    """Radiance [N, 4] from world directions d [N, 3] (K8); 0 outside the
    mask `active` [N] where given. Where d, the image, the constant radiance
    or the rotation requires grad (and grad mode is on), the lookup is on
    the tape: its backward is K8T (render/backward.py `EnvRadiance`)."""
    if _on_tape(env, d):
        from .backward import EnvRadiance

        return EnvRadiance.apply(env, d, active, env.image, env.const_radiance, env.rotation)
    return env_radiance_raw(env, d, active)


def env_radiance_raw(env: EnvMapArrays, d, active=None):
    """K8 radiance without a tape: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check("env_radiance", env, d, 3, active)
    if d.device.type == "cpu":
        return env_radiance_plain(env, d, active)
    return _lanes("env_radiance", env, False, d, active, False, True)[2]


def env_sample(env: EnvMapArrays, u3, active=None):
    """Importance-sampled world direction [N, 3] and its pdf [N] from uniforms
    u3 [N, 3] (K8); outside the mask `active` [N] where given,
    `skipped_direction` and pdf 0. Where the rotation requires grad (and grad
    mode is on), the direction R(q) d_map is on the tape: its backward is
    K8T's sample backward (render/backward.py `EnvSample`); the pdf carries
    none."""
    if torch.is_grad_enabled() and env.rotation.requires_grad:
        from .backward import EnvSample

        return EnvSample.apply(env, u3, active, env.rotation)
    return env_sample_raw(env, u3, active)


def env_sample_raw(env: EnvMapArrays, u3, active=None):
    """K8 sample without a tape: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check("env_sample", env, u3, 3, active)
    _check_tables("env_sample", env)
    if u3.device.type == "cpu":
        return env_sample_plain(env, u3, active)
    return _lanes("env_sample", env, True, u3, active, True, False)[:2]


def env_pdf(env: EnvMapArrays, d, active=None):
    """Solid-angle pdf [N] of env_sample having produced world directions d
    [N, 3] (K8); 0 outside the mask `active` [N] where given. Piecewise
    constant in d (the pdf table at d's cell), so it carries no gradient to
    d or to the rotation, in either package: never on the tape."""
    _check("env_pdf", env, d, 3, active)
    _check_tables("env_pdf", env)
    if d.device.type == "cpu":
        return env_pdf_plain(env, d, active)
    return _lanes("env_pdf", env, False, d, active, True, False)[1]


def env_miss_lanes(env: EnvMapArrays, d, active=None, pdf: bool = True):
    """The radiance [N, 4] of world directions d [N, 3] and, with `pdf`, their
    pdf [N] (else None) in one launch of K8 (counter env_miss): a bounce's
    escaped rays, `active` [N] marking the lanes whose results are read
    (radiance and pdf 0 elsewhere). The radiance is on the tape as
    `env_radiance`'s (render/backward.py `EnvMiss`); the pdf carries none."""
    if _on_tape(env, d):
        from .backward import EnvMiss

        return EnvMiss.apply(env, d, active, pdf, env.image, env.const_radiance, env.rotation)
    return env_miss_raw(env, d, active, pdf)


def env_miss_raw(env: EnvMapArrays, d, active=None, pdf: bool = True):
    """`env_miss_lanes` without a tape: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check("env_miss", env, d, 3, active)
    if pdf:
        _check_tables("env_miss", env)
    if d.device.type == "cpu":
        return env_miss_plain(env, d, active, pdf)
    _, p, rad = _lanes("env_miss", env, False, d, active, pdf, True)
    return rad, p


def env_nee_lanes(env: EnvMapArrays, u3, active=None):
    """An importance-sampled world direction [N, 3], its pdf [N] and the
    radiance [N, 4] arriving from it, from uniforms u3 [N, 3], in one launch
    of K8 (counter env_nee; the direction stays in registers): a bounce's
    env NEE, `active` [N] marking the lanes that take it (`skipped_direction`,
    pdf 0 and radiance 0 elsewhere). Direction and radiance are on the tape
    as `env_sample`'s and `env_radiance`'s (render/backward.py `EnvNee`)."""
    if _on_tape(env):
        from .backward import EnvNee

        return EnvNee.apply(env, u3, active, env.image, env.const_radiance, env.rotation)
    return env_nee_raw(env, u3, active)


def env_nee_raw(env: EnvMapArrays, u3, active=None):
    """`env_nee_lanes` without a tape: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check("env_nee", env, u3, 3, active)
    _check_tables("env_nee", env)
    if u3.device.type == "cpu":
        return env_nee_plain(env, u3, active)
    return _lanes("env_nee", env, True, u3, active, True, True)


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
