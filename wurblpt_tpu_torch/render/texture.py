"""Texture evaluation (port of ``wurblpt_tpu/render/texture.py``).

The reference's virtual ``Texture::value(texcoords, t)`` (texture.hpp:47-158)
becomes masked evaluation over the texture table's type codes: constant,
checker (texture.hpp:182-205), image (bilinear or nearest filtering with
fract-wrap addressing and the v flip, texture_image.hpp:182-212, on the
float16 image stack widened to float32) and the hash-based noises of
texture_noise.hpp (value and gradient noise as fBm sums, Worley, signed
Perlin and Perlin turbulence), each followed by the flattened transformer's
value affine (texture.hpp:207-246).

These are PyTorch ops, not a kernel (ROADMAP B.1: the lookups stay inside
the bounce), so a texel's gradient is autograd's gather backward. The
lattice hashes are the port's PCG4D on int64 words masked to 32 bits, where
negative lattice coordinates wrap as the JAX package's uint32 casts do;
`torch.remainder` and `torch.round` are jnp.mod's floor-mod and jnp.round's
half to even.

`apply_textures` folds a lane's textured colours into its material row
(albedo, emission, ModPhong's specular colour and opacity), once per
bounce, so every reader of the row sees the shade-time values.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core.rng import hash4
from ..scene.ir import TextureTable, TextureType
from .gather import row_gather

_MAX_OCTAVES = 8
_NOISE = frozenset({TextureType.VALUE_NOISE, TextureType.GRADIENT_NOISE,
                    TextureType.WORLEY_NOISE, TextureType.PERLIN_NOISE})


class TextureStatic(NamedTuple):
    """Host facts of a scene's textures that select code: the types in its
    texture table, whether it has images, the most noise octaves of any
    texture (the octaves past it add zeros to the JAX package's fixed
    8-octave sums), and which of the materials' texture-id columns name a
    texture (`MaterialTable.tex_ids` order: albedo, emissive, normal,
    opacity, spec)."""

    kinds: frozenset
    has_images: bool
    octaves: int
    columns: frozenset

    @staticmethod
    def of(tt: TextureTable, mt) -> "TextureStatic":
        kinds = frozenset(tt.typ.tolist())
        noise = [o for k, o in zip(tt.typ.tolist(), tt.params[:, 0].tolist()) if k in _NOISE]
        octaves = min(_MAX_OCTAVES, max([math.ceil(o) for o in noise], default=0))
        columns = frozenset(name for name, ids in zip(TEX_COLUMNS, mt.tex_ids)
                            if bool((ids >= 0).any()))
        return TextureStatic(kinds, tt.img_data.shape[0] > 0, max(octaves, 0), columns)


TEX_COLUMNS = ("albedo", "emissive", "normal", "opacity", "spec")
TEX_ID_WORDS = 8   # the five texture ids and three -1 pads: two of P0's 16-byte vectors


def pack_texture_ids(mt) -> Optional[torch.Tensor]:
    """[M, 8] int32 bit patterns as f32: the materials' albedo, emissive,
    normal, opacity and spec texture ids, padded with -1 (the JAX package
    packs them into its one material row; here they sit apart, so the
    23-word row that K4's shades read inline and P0T scatters keeps its
    layout). None where no material names a texture."""
    if mt.albedo_tex is None or not any(bool((x >= 0).any()) for x in mt.tex_ids):
        return None
    ids = torch.stack(mt.tex_ids, -1).to(torch.int32)
    pad = torch.full((ids.shape[0], TEX_ID_WORDS - ids.shape[1]), -1, dtype=torch.int32,
                     device=ids.device)
    return torch.cat([ids, pad], -1).view(torch.float32).contiguous()


class TexCtx(NamedTuple):
    """A textured scene's textures as the bounce reads them: the packed
    texture-id rows and descriptor rows that P0 gathers per lane, the
    texture table (its image stack) and its static facts."""

    ids: torch.Tensor         # [M, 8] (pack_texture_ids)
    desc: torch.Tensor        # [NT, 24] (pack_texture_descriptors)
    table: TextureTable
    static: TextureStatic

    @staticmethod
    def of(scene) -> Optional["TexCtx"]:
        """None for a scene whose materials name no texture."""
        ids = pack_texture_ids(scene.materials)
        if ids is None:
            return None
        tt = scene.textures
        return TexCtx(ids, pack_texture_descriptors(tt), tt,
                      TextureStatic.of(tt, scene.materials))

    def sample(self, tex_id, uv):
        """sample_texture with this scene's table, descriptor rows and facts."""
        return sample_texture(self.table, tex_id, uv, self.static, self.desc)


def _hash01(ix, iy, seed):
    v0 = hash4(ix, iy, seed, 0x9E3779B9)[0]
    return (v0 >> 8).to(torch.float32) * (1.0 / 16777216.0)


# The noises below evaluate every lattice corner (and every octave) of a
# lookup in one batch along a new leading axis: the lanes' values are
# independent, so a batch gives each the same bits as one call per corner,
# in a few hundred PyTorch launches instead of ten thousand.
_DX = (0, 1, 0, 1)    # the four corners (0, 0), (1, 0), (0, 1), (1, 1)
_DY = (0, 0, 1, 1)


def _cell(u, v):
    iu, iv = torch.floor(u), torch.floor(v)
    return u - iu, v - iv, iu.to(torch.int32), iv.to(torch.int32)


def _corner_hashes(iu, iv, seed, dx=_DX, dy=_DY):
    """[len(dx), ...] hashes of the lattice points (iu + dx, iv + dy)."""
    return _hash01(torch.stack([iu + x for x in dx]), torch.stack([iv + y for y in dy]), seed)


def _lerp2(a, b, c, d, su, sv):
    return (a * (1 - su) + b * su) * (1 - sv) + (c * (1 - su) + d * su) * sv


def _value_noise(u, v, seed):
    fu, fv, iu, iv = _cell(u, v)
    su = fu * fu * (3.0 - 2.0 * fu)
    sv = fv * fv * (3.0 - 2.0 * fv)
    return _lerp2(*_corner_hashes(iu, iv, seed).unbind(0), su, sv)


def _grad_corners(fu, fv, iu, iv, seed):
    """The four corners' unit gradients, dotted with the offsets to them."""
    ang = _corner_hashes(iu, iv, seed) * (2.0 * math.pi)
    gx, gy = torch.cos(ang), torch.sin(ang)
    return [gx[k] * (fu - _DX[k]) + gy[k] * (fv - _DY[k]) for k in range(4)]


def _gradient_noise(u, v, seed):
    fu, fv, iu, iv = _cell(u, v)
    su = fu * fu * fu * (fu * (fu * 6.0 - 15.0) + 10.0)
    sv = fv * fv * fv * (fv * (fv * 6.0 - 15.0) + 10.0)
    n = _lerp2(*_grad_corners(fu, fv, iu, iv, seed), su, sv)
    return 0.5 + 0.5 * n * 1.4142  # remapped to about [0, 1]


_CELLS = [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _worley_noise(u, v, seed):
    fu, fv, iu, iv = _cell(u, v)
    dx, dy = [c[0] for c in _CELLS], [c[1] for c in _CELLS]
    # the feature point of each of the 9 cells: x hashed with seed, y with seed + 77
    h = _corner_hashes(torch.stack([iu, iu]), torch.stack([iv, iv]),
                       torch.stack([seed + torch.zeros_like(iu), seed + 77 + torch.zeros_like(iu)]),
                       dx, dy)
    dmin = torch.full_like(u, 8.0)
    for k, (cx, cy) in enumerate(_CELLS):
        d2 = (h[k, 0] + cx - fu) ** 2 + (h[k, 1] + cy - fv) ** 2
        dmin = torch.minimum(dmin, d2)
    return torch.sqrt(dmin)


def _perlin_signed(u, v, seed):
    """Signed single-octave Perlin (texture_noise.hpp:192-237), roughly
    [-0.7, 0.7]; lattice gradients from the hash, not permutation tables."""
    fu, fv, iu, iv = _cell(u, v)
    su = fu * fu * (3.0 - 2.0 * fu)
    sv = fv * fv * (3.0 - 2.0 * fv)
    return _lerp2(*_grad_corners(fu, fv, iu, iv, seed), su, sv)


def _octaves(noise_fn, u, v, seed, n_oct):
    """noise_fn at the octaves 0..n_oct-1, batched: [n_oct, N] of
    noise(2^o u, 2^o v, seed + o)."""
    scale = torch.tensor([2.0 ** o for o in range(n_oct)], device=u.device)[:, None]
    octs = torch.arange(n_oct, dtype=torch.int32, device=u.device)[:, None]
    return noise_fn(u * scale, v * scale, seed + octs)


def _perlin_turbulence(u, v, octaves_f, gain, seed, n_oct):
    """|sum_i gain^i perlin(2^i uv)| (texture_noise.hpp:239-251; not normalized)."""
    noise = _octaves(_perlin_signed, u, v, seed, n_oct)
    total = torch.zeros_like(u)
    amp = torch.ones_like(u)
    for o in range(n_oct):
        active = (octaves_f > o).to(u.dtype)
        total = total + active * amp * noise[o]
        amp = amp * gain
    return torch.abs(total)


def _fbm(noise_fn, u, v, octaves_f, gain, seed, n_oct):
    """The fractal sum over the lanes' active octaves, normalized."""
    noise = _octaves(noise_fn, u, v, seed, n_oct)
    total = torch.zeros_like(u)
    norm = torch.zeros_like(u)
    amp = torch.ones_like(u)
    for o in range(n_oct):
        active = (octaves_f > o).to(u.dtype)
        total = total + active * amp * noise[o]
        norm = norm + active * amp
        amp = amp * gain
    return total / torch.clamp_min(norm, 1e-8)


def _bilinear_stack(img, image_id, u, v, linear, h, w):
    """Per-lane lookup in the padded image stack: fract wrap, row 0 at the
    top (the v flip), bilinear (`linear`) or nearest, texels widened to
    float32 before the blend."""
    uu = u - torch.floor(u)
    vv = 1.0 - (v - torch.floor(v))
    x = uu * w - 0.5
    y = vv * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx = torch.where(linear, x - x0, torch.round(x - x0))[:, None]
    fy = torch.where(linear, y - y0, torch.round(y - y0))[:, None]
    wi, hi = w.to(torch.int32), h.to(torch.int32)
    x0i = torch.remainder(x0.to(torch.int32), wi)
    x1i = torch.remainder(x0i + 1, wi)
    y0i = torch.remainder(y0.to(torch.int32), hi)
    y1i = torch.remainder(y0i + 1, hi)
    img_id = image_id.long()

    def tap(yy, xx):
        return img[img_id, yy.long(), xx.long()].to(torch.float32)

    return ((tap(y0i, x0i) * (1 - fx) + tap(y0i, x1i) * fx) * (1 - fy)
            + (tap(y1i, x0i) * (1 - fx) + tap(y1i, x1i) * fx) * fy)


def pack_texture_descriptors(tt: TextureTable) -> torch.Tensor:
    """[NT, 24] f32, one row per texture for P0 (the JAX package's
    texture.py:174-182 packing): params (8) | uv_scale (2) | uv_offset (2) | val_scale (4) |
    val_offset (4) | typ and image id (max(id, 0); int32 bit patterns) |
    the image's h and w (floats; 1 without images)."""
    iid = torch.clamp_min(tt.image_id, 0)
    if tt.img_data.shape[0] > 0:
        hw = tt.img_hw[torch.clamp(iid, 0, tt.img_hw.shape[0] - 1).long()].to(torch.float32)
    else:
        hw = torch.ones((tt.count, 2), dtype=torch.float32, device=tt.typ.device)
    ints = torch.stack([tt.typ, iid], -1).to(torch.int32).view(torch.float32)
    return torch.cat([tt.params, tt.uv_scale, tt.uv_offset, tt.val_scale, tt.val_offset, ints,
                      hw], -1).contiguous()


def sample_texture(tt: TextureTable, tex_id, uv, ts: TextureStatic, desc: torch.Tensor):
    """Texture values [N, 4] (RGB + NIR, after the value affine) of texture
    ids tex_id [N] (clipped to the table) at texcoords uv [N, 2]: one row
    gather (P0) of the packed descriptors `desc` (`pack_texture_descriptors`),
    the texels by PyTorch indexing; `ts` (`TextureStatic.of`) skips the
    branches of types the table lacks. `TexCtx.sample` passes a scene's."""
    tid = torch.clamp(tex_id, 0, tt.count - 1).to(torch.int32).contiguous()
    row = row_gather(desc, tid)
    params, uv_scale, uv_offset = row[:, 0:8], row[:, 8:10], row[:, 10:12]
    ints = row[:, 20:22].view(torch.int32)
    typ = ints[:, 0]
    u = uv[:, 0] * uv_scale[:, 0] + uv_offset[:, 0]
    v = uv[:, 1] * uv_scale[:, 1] + uv_offset[:, 1]
    out = params[:, 0:4]
    if TextureType.CHECKER in ts.kinds:
        cell = (torch.floor(u) + torch.floor(v)).to(torch.int32)
        checker = torch.where((torch.remainder(cell, 2) == 0)[:, None], params[:, 0:4],
                              params[:, 4:8])
        out = torch.where((typ == TextureType.CHECKER)[:, None], checker, out)
    if ts.has_images and TextureType.IMAGE in ts.kinds:
        img_val = _bilinear_stack(tt.img_data, ints[:, 1], u, v, params[:, 0] > 0.5,
                                  row[:, 22], row[:, 23])
        out = torch.where((typ == TextureType.IMAGE)[:, None], img_val, out)
    if ts.kinds & _NOISE:
        octaves, freq, gain = params[:, 0], params[:, 1], params[:, 2]
        seed = params[:, 3].to(torch.int32)
        nu, nv = u * freq, v * freq
        noise = torch.zeros_like(u)
        n_oct = ts.octaves
        if TextureType.VALUE_NOISE in ts.kinds:
            noise = torch.where(typ == TextureType.VALUE_NOISE,
                                _fbm(_value_noise, nu, nv, octaves, gain, seed, n_oct), noise)
        if TextureType.GRADIENT_NOISE in ts.kinds:
            noise = torch.where(typ == TextureType.GRADIENT_NOISE,
                                _fbm(_gradient_noise, nu, nv, octaves, gain, seed, n_oct), noise)
        if TextureType.WORLEY_NOISE in ts.kinds:
            noise = torch.where(typ == TextureType.WORLEY_NOISE, _worley_noise(nu, nv, seed),
                                noise)
        if TextureType.PERLIN_NOISE in ts.kinds:
            perlin = torch.where(params[:, 4] > 0.5,
                                 _perlin_turbulence(nu, nv, octaves, gain, seed, n_oct),
                                 _perlin_signed(nu, nv, seed))
            noise = torch.where(typ == TextureType.PERLIN_NOISE, perlin, noise)
        any_noise = (typ >= TextureType.VALUE_NOISE) & (typ <= TextureType.PERLIN_NOISE)
        out = torch.where(any_noise[:, None], noise[:, None], out)
    return out * row[:, 12:16] + row[:, 16:20]


def apply_textures(mrow, tex: Optional[TexCtx], uv,
                   columns=("albedo", "emissive", "opacity", "spec")):
    """The material rows with their textured colours at texcoords uv [N, 2]
    (texture.py material_albedo / material_emissive, bsdf.py _modphong_ks and
    ModPhong's opacity map): albedo and emission are the texture times the
    row's constant (1 for a textured colour), ModPhong's specular colour
    (p1) the map_Ks texture, its opacity (p0.y) the opacity map's .r.
    `columns` names the colours to texture (a light's sample takes the
    emission alone). Every colour in use is looked up in one
    `sample_texture` call over the lanes stacked per colour (the lanes are
    independent: the same values as one call each). Unchanged where the
    scene has no texture (`tex` None)."""
    if tex is None:
        return mrow
    used = [c for c in columns if c in tex.static.columns]
    if not used:
        return mrow
    n = uv.shape[0]
    ids = {"albedo": mrow.albedo_tex, "emissive": mrow.emissive_tex,
           "opacity": mrow.opacity_tex, "spec": mrow.spec_tex}
    vals = tex.sample(torch.cat([ids[c] for c in used]), uv.repeat(len(used), 1))
    val = dict(zip(used, vals.split(n)))

    def textured(c, const, scale):
        if c not in val:
            return const
        return torch.where((ids[c] >= 0)[:, None], val[c] * const if scale else val[c], const)

    p0 = mrow.p0
    if "opacity" in val:
        opacity = textured("opacity", p0[:, 1:2], False)[:, 0:1]
        p0 = torch.cat([p0[:, :1], opacity, p0[:, 2:]], -1)
    return mrow._replace(albedo=textured("albedo", mrow.albedo, True),
                         emissive=textured("emissive", mrow.emissive, True), p0=p0,
                         p1=textured("spec", mrow.p1, False))


def material_albedo(mrow):
    """Per-lane albedo [N, 4] of the material rows (textured by `apply_textures`)."""
    return mrow.albedo


def material_emissive(mrow):
    """Per-lane emitted radiance [N, 4] of the material rows (textured by `apply_textures`)."""
    return mrow.emissive
