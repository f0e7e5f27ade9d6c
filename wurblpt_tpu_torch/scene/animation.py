"""Keyframe animation at ray time (port of ``wurblpt_tpu/scene/animation.py``).

The reference moves animated vertices to the ray's time through its
AnimationCache (animation.hpp:52-125). The JAX package, and the port after
it, move the ray instead: each cast takes the ray into every animation's
object space (`AnimCtx.ray_to_object`), each primitive tests the ray of its
own animation (row 0 is the static identity), and the hit distance t is the
same in both spaces. The hit record is built in the winner's object space
and its frame pushed back to world with the forward and normal matrices
(`anim_forward_frames`).

On the card the casts (KS1, KS2) and the hit assembly (K3a) read the
animations' frames at the frame's one instant as rows of `anim_frames`
and move each ray themselves; their plain versions compute the same rows
the same way. `AnimCtx` and `make_anim_ctx` keep the JAX package's form
(a batch of ray times) for the comparisons with it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.transform import Transformation, quat_slerp, quat_to_mat3
from .ir import AnimTable

# anim_frames row: r_inv (row major) | t_inv | m_fwd (row major) | m_nrm (row major)
FRAME_WIDTH = 30


def eval_animation(anims: AnimTable, aid, t) -> Transformation:
    """Evaluate animation `aid` [...] at time `t` [...] -> Transformation batch.

    Clamps outside the keyframe range, as the reference does: the key index
    is the number of keys at or before t, less one, held in [0, nkeys - 1]."""
    aid = aid.long()
    times = anims.times[aid]                                   # [..., K] (+inf padded)
    k = (times <= t[..., None]).to(torch.int32).sum(-1, dtype=torch.int32) - 1
    kmax = anims.nkeys[aid] - 1
    k0 = torch.minimum(torch.clamp_min(k, 0), kmax).long()
    k1 = torch.minimum(torch.clamp_min(k + 1, 0), kmax).long()
    t0 = torch.gather(times, -1, k0[..., None])[..., 0]
    t1 = torch.gather(times, -1, k1[..., None])[..., 0]
    denom = torch.clamp_min(t1 - t0, 1e-12)
    alpha = torch.clamp((t - t0) / denom, 0.0, 1.0)

    def g(table, idx):
        rows = table[aid]                                      # [..., K, C]
        idx = idx[..., None, None].expand(idx.shape + (1, rows.shape[-1]))
        return torch.gather(rows, -2, idx)[..., 0, :]

    tr0, tr1 = g(anims.trans, k0), g(anims.trans, k1)
    ro0, ro1 = g(anims.rot, k0), g(anims.rot, k1)
    sc0, sc1 = g(anims.scale, k0), g(anims.scale, k1)
    a = alpha[..., None]
    return Transformation(translation=tr0 + (tr1 - tr0) * a,
                          rotation=quat_slerp(ro0, ro1, alpha),
                          scale=sc0 + (sc1 - sc0) * a)


def matvec(m, v):
    """m [..., 3, 3] times v [..., 3], each row summed left to right (the
    order of the kernels' object rays)."""
    return m[..., 0] * v[..., 0:1] + m[..., 1] * v[..., 1:2] + m[..., 2] * v[..., 2:3]


class AnimCtx(NamedTuple):
    """Every animation's inverse frame at each ray's time (the wavefront
    AnimationCache). The batch B is the number of rays, or 1 when all rays
    share one instant (a frame without motion blur): the rows then broadcast."""

    r_inv: torch.Tensor                    # [B, A, 3, 3] diag(1/s) R^T
    t_inv: torch.Tensor                    # [B, A, 3] world translation (subtracted first)
    time: torch.Tensor                     # [B]
    m_fwd: Optional[torch.Tensor] = None   # [B, A, 3, 3] forward map R diag(s) (animated lights)

    def ray_to_object(self, o, d):
        """World rays [N, 3] -> object-space rays per animation [N, A, 3]."""
        o_a = matvec(self.r_inv, o[:, None, :] - self.t_inv)
        d_a = matvec(self.r_inv, d[:, None, :].expand(o_a.shape))
        return o_a, d_a


def _inverse(r3, scale):
    """diag(1/s) R^T: row i of R^T divided by s_i."""
    return r3.transpose(-1, -2) / torch.clamp_min(scale[..., :, None], 1e-20)


def make_anim_ctx(anims: AnimTable, time, with_forward: bool = False) -> AnimCtx:
    """Evaluate all A animations at each time [B] (A is small; row 0 identity)."""
    n, a = time.shape[0], anims.count
    aid = torch.arange(a, dtype=torch.int32, device=time.device)[None, :].expand(n, a)
    tf = eval_animation(anims, aid, time[:, None])
    r3 = quat_to_mat3(tf.rotation)                            # [B, A, 3, 3]
    m_fwd = r3 * tf.scale[..., None, :] if with_forward else None
    return AnimCtx(r_inv=_inverse(r3, tf.scale), t_inv=tf.translation, time=time, m_fwd=m_fwd)


def anim_forward_frames(anims: AnimTable, aid, time):
    """Forward map M = R diag(s) and normal matrix R diag(1/s) of animation
    `aid` [...] at `time` [...], with the Transformation: what assemble_hit
    uses to push object-space normals and tangents back to world."""
    tf = eval_animation(anims, aid, time)
    r3 = quat_to_mat3(tf.rotation)
    return r3 * tf.scale[..., None, :], r3 / torch.clamp_min(tf.scale[..., None, :], 1e-20), tf


def anim_frames(anims: AnimTable, time: float) -> torch.Tensor:
    """[A, 30] f32 rows of every animation at one instant `time`: the
    inverse frame (r_inv, t_inv) that moves a ray to object space, then the
    forward and normal matrices (m_fwd, m_nrm) that move a hit's frame back.
    The casts and the hit assembly read them, and NEE places a moving light
    by its animation's t_inv and m_fwd (render/lights.py light_frames)."""
    a = anims.count
    aid = torch.arange(a, dtype=torch.int32, device=anims.times.device)
    m, mn, tf = anim_forward_frames(anims, aid, torch.full((a,), time, dtype=torch.float32,
                                                           device=aid.device))
    r_inv = _inverse(quat_to_mat3(tf.rotation), tf.scale)
    return torch.cat([r_inv.reshape(a, 9), tf.translation, m.reshape(a, 9),
                      mn.reshape(a, 9)], -1).contiguous()


def frames_ray_to_object(frames, aid, o, d):
    """The object-space rays of animation `aid` [N] (or [N, P]) from the rows
    of `anim_frames` [A, 30]: o_a = r_inv (o - t_inv), d_a = r_inv d, as the
    kernels compute them; also the rows."""
    rows = frames[aid.long()]
    r = rows[..., 0:9].reshape(rows.shape[:-1] + (3, 3))
    while o.dim() < rows.dim():
        o, d = o[:, None, :], d[:, None, :]
    return matvec(r, o - rows[..., 9:12]), matvec(r, d.expand(rows.shape[:-1] + (3,))), rows
