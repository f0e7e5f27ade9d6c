"""Cameras (port of ``wurblpt_tpu/render/camera.py``: the pinhole with the
three lens distortion models, and the equirect surround cameras, mono or
stereo, each with an optional thin lens (depth of field) and an optional
keyframe-animated pose).

`CameraConfig` keeps the JAX package's switches; :func:`check_camera`
refuses a distortion model it does not know.

Where the JAX package divides by a Python constant, XLA multiplies by the
float32 reciprocal of the constant; `_recip` gives that factor, so the port
rounds as the reference does on every device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import math

import numpy as np
import torch

from ..core import sampler
from ..core.transform import Transformation, quat_conjugate, quat_mul, quat_rotate
from ..core.vecmath import normalize


class SurroundMode:
    OFF = 0
    S180 = 1
    S360 = 2


class DistortionModel:
    NONE = 0
    RADIAL_AND_PLANAR = 1
    RADIAL_ONLY = 2
    OPENCV = 3


@dataclass(frozen=True)
class CameraConfig:
    """Static camera switches (camera.CameraConfig)."""

    surround: int = SurroundMode.OFF
    stereo: bool = False
    distortion: int = DistortionModel.NONE
    dof: bool = False
    undistort_iters: int = 32
    anim_id: int = -1


class CameraParams(NamedTuple):
    transformation: Transformation    # camera-to-world pose
    center_px: torch.Tensor           # [2] principal point (cx, cy) in pixels
    focal_px: torch.Tensor            # [2] focal length (fx, fy) in pixels
    dist_k: torch.Tensor              # [6] radial coefficients
    dist_p: torch.Tensor              # [2] tangential coefficients
    eye_distance: torch.Tensor        # [] stereo interocular distance
    focus_distance: torch.Tensor      # [] DoF focus plane distance
    aperture_diameter: torch.Tensor   # [] DoF lens diameter


def make_camera(
    transformation: Optional[Transformation] = None,
    vfov_deg: Optional[float] = None,
    width: int = 1,
    height: int = 1,
    center_px=None,
    focal_px=None,
    dist_k=(0.0,) * 6,
    dist_p=(0.0, 0.0),
    eye_distance: float = 0.0635,
    focus_distance: float = 1.0,
    aperture_diameter: float = 0.0,
    device="cuda",
) -> CameraParams:
    """CameraParams from a vertical field of view (optics.hpp:58-65) or raw intrinsics."""
    if transformation is None:
        transformation = Transformation(torch.zeros(3), torch.tensor([0.0, 0.0, 0.0, 1.0]),
                                        torch.ones(3))
    if focal_px is None:
        if vfov_deg is None:
            raise ValueError("need vfov_deg or focal_px")
        fy = 0.5 * height / np.tan(np.deg2rad(vfov_deg) / 2.0)
        focal_px = (fy, fy)
    if center_px is None:
        center_px = (width / 2.0, height / 2.0)

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return CameraParams(transformation.to(device), f32(center_px), f32(focal_px),
                        f32(dist_k), f32(dist_p), f32(eye_distance), f32(focus_distance),
                        f32(aperture_diameter))


def camera_from_numpy(c, device) -> CameraParams:
    """The JAX package's CameraParams, with numpy leaves, on `device`."""
    t = c.transformation
    tf = Transformation(*(torch.as_tensor(np.array(x, np.float32)) for x in
                          (t.translation, t.rotation, t.scale)))
    return make_camera(tf, center_px=c.center_px, focal_px=c.focal_px, dist_k=c.dist_k,
                       dist_p=c.dist_p, eye_distance=c.eye_distance,
                       focus_distance=c.focus_distance,
                       aperture_diameter=c.aperture_diameter, device=device)


def check_camera(cfg: CameraConfig) -> None:
    """Raise NotImplementedError for a distortion model the port does not know."""
    if cfg.distortion not in (DistortionModel.NONE, DistortionModel.RADIAL_AND_PLANAR,
                              DistortionModel.RADIAL_ONLY, DistortionModel.OPENCV):
        raise NotImplementedError(f"camera features outside the ported slice: "
                                  f"['distortion model {cfg.distortion}']")


def animated_pose(tf: Transformation, anims, anim_id: int, time) -> Transformation:
    """The pose of an animated camera at each ray's time [N] (camera.py:201-230,
    camera.hpp:56-111): animation `anim_id` evaluated at `time`, composed
    with the static pose `tf` as its local offset (world <- animation <-
    camera), each rotation, translation and scale [N, ...]."""
    from ..scene.animation import eval_animation   # scene imports render: bind late

    aid = torch.full(time.shape, anim_id, dtype=torch.int32, device=time.device)
    atf = eval_animation(anims, aid, time)
    return Transformation(
        translation=atf.translation + quat_rotate(atf.rotation, tf.translation * atf.scale),
        rotation=quat_mul(atf.rotation, tf.rotation.expand(atf.rotation.shape)),
        scale=atf.scale * tf.scale)


def static_pose(cam: CameraParams, cfg: CameraConfig, anims, time: float):
    """(cam, cfg) of an animated camera at one instant `time`: the pose
    composed once (`animated_pose` of one ray), and the config without the
    animation; a camera without animation as given. The K4 regenerations
    take a static pose."""
    if cfg.anim_id < 0:
        return cam, cfg
    tf = animated_pose(cam.transformation, anims, cfg.anim_id,
                       torch.full((1,), float(time), dtype=torch.float32,
                                  device=cam.focal_px.device))
    pose = Transformation(*(x[0].contiguous() for x in tf))
    return cam._replace(transformation=pose), dataclasses.replace(cfg, anim_id=-1)


def _recip(c) -> float:
    """float32(1) / float32(c): the factor XLA multiplies by for `x / c`."""
    return float(np.float32(1.0) / np.float32(c))


def distort_normalized(cam: CameraParams, cfg: CameraConfig, xy):
    """Forward lens distortion of normalized image coordinates xy [N, 2]
    (camera.py:122-137, optics.hpp:227-246): RADIAL_ONLY scales by the radial
    polynomial; RADIAL_AND_PLANAR and OPENCV add the tangential terms."""
    if cfg.distortion == DistortionModel.NONE:
        return xy
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    k = cam.dist_k
    p1, p2 = cam.dist_p[0], cam.dist_p[1]
    radial = 1.0 + k[0] * r2 + k[1] * r2 * r2 + k[2] * r2 * r2 * r2
    if cfg.distortion == DistortionModel.RADIAL_ONLY:
        return xy * radial[..., None]
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([x * radial + dx, y * radial + dy], -1)


def undistort_normalized(cam: CameraParams, cfg: CameraConfig, xy):
    """Inverse lens distortion of normalized image coordinates xy [N, 2]
    (camera.py:140-180): RADIAL_AND_PLANAR by its closed-form first-order
    inverse (optics.hpp:251-268), RADIAL_ONLY by the Drap-Lefevre inverse
    series to 4 terms (optics.hpp:269-278), OPENCV by `undistort_iters`
    fixed-point steps und <- xy - (distort(und) - und) from und = xy."""
    if cfg.distortion == DistortionModel.NONE:
        return xy
    k = cam.dist_k
    if cfg.distortion == DistortionModel.RADIAL_AND_PLANAR:
        x, y = xy[..., 0], xy[..., 1]
        p1, p2 = cam.dist_p[0], cam.dist_p[1]
        r2 = x * x + y * y
        r4 = r2 * r2
        d1 = k[0] * r2 + k[1] * r4
        d2 = 1.0 / (4.0 * k[0] * r2 + 6.0 * k[1] * r4 + 8.0 * p1 * y + 8.0 * p2 * x + 1.0)
        ux = x - d2 * (d1 * x + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x))
        uy = y - d2 * (d1 * y + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)
        return torch.stack([ux, uy], -1)
    if cfg.distortion == DistortionModel.RADIAL_ONLY:
        # Powers in the product order of JAX's integer_pow: k^3 = k (k k),
        # k^4 = (k k)(k k).
        k1, k2, k3 = k[0], k[1], k[2]
        k1k1 = k1 * k1
        b1 = -k1
        b2 = 3.0 * k1k1 - k2
        b3 = -12.0 * (k1 * k1k1) + 8.0 * k1 * k2 - k3
        b4 = 55.0 * (k1k1 * k1k1) - 55.0 * k1 * k1 * k2 + 5.0 * k2 * k2 + 10.0 * k1 * k3
        r2 = (xy * xy).sum(-1)
        r4 = r2 * r2
        radial = 1.0 + b1 * r2 + b2 * r4 + b3 * (r2 * r4) + b4 * (r4 * r4)
        return xy * radial[..., None]
    und = xy
    for _ in range(cfg.undistort_iters):
        und = xy - (distort_normalized(cam, cfg, und) - und)
    return und


def camera_rays(cam: CameraParams, cfg: CameraConfig, pixel_xy, width: int, height: int,
                t0=0.0, t1=0.0, u_time=None, u_lens=None, anims=None):
    """World-space rays through pixel coords [N, 2] (camera.hpp:123-185), with
    the JAX package's signature (camera.py:187-270).

    Stereo packs the left eye into the top half of the image and the right
    eye into the bottom half. A surround camera maps the width to [-pi, pi]
    (S360) or [-pi/2, pi/2] (S180) and the (half) height to [pi/2, -pi/2];
    its stereo eyes sit on a circle of diameter `eye_distance`, offset
    perpendicular to each viewing column (ODS, camera.hpp:74-79). The
    pinhole undistorts its normalized image coordinates with the lens model
    of `cfg`. Each ray's time is t0 + u_time (t1 - t0) (u_time [N]; None:
    every ray at t0). With `cfg.dof` the thin lens (optics.hpp:312-335)
    moves the origin to `u_lens` [N, 2] mapped to the lens disk of diameter
    `aperture_diameter` and aims the ray at the pixel's point on the focus
    plane at `focus_distance`; with `cfg.anim_id` >= 0 the pose is that
    animation of `anims` at each ray's time composed with the static pose
    (`animated_pose`). Returns (origin [N, 3], direction [N, 3], time [N])."""
    check_camera(cfg)
    px, py = pixel_xy[..., 0], pixel_xy[..., 1]
    if u_time is None:
        time = torch.full(px.shape, float(t0), dtype=torch.float32, device=px.device)
    else:
        time = t0 + u_time * (t1 - t0)
    eff_height = height // 2 if cfg.stereo else height
    if cfg.stereo:
        top = py < eff_height
        py = torch.where(top, py, py - eff_height)
        eye_sign = torch.where(top, -1.0, 1.0)
    else:
        eye_sign = torch.zeros_like(px)
    if cfg.surround == SurroundMode.OFF:
        nx = (px - cam.center_px[0]) / cam.focal_px[0]
        cy = cam.center_px[1] * (eff_height / height) if cfg.stereo else cam.center_px[1]
        ny = (py - cy) / cam.focal_px[1]
        und = undistort_normalized(cam, cfg, torch.stack([nx, ny], -1))
        d_cam = torch.stack([und[..., 0], -und[..., 1], -torch.ones_like(nx)], -1)
        zero = torch.zeros_like(nx)
        o_cam = torch.stack([zero + eye_sign * 0.5 * cam.eye_distance, zero, zero], -1)
    else:
        span = math.pi if cfg.surround == SurroundMode.S360 else math.pi / 2.0
        phi = (px * _recip(width) * 2.0 - 1.0) * span
        theta = (0.5 - py * _recip(eff_height)) * math.pi
        ct = torch.cos(theta)
        d_cam = torch.stack([ct * torch.sin(phi), torch.sin(theta), -ct * torch.cos(phi)], -1)
        offset_dir = torch.stack([torch.cos(phi), torch.zeros_like(phi), torch.sin(phi)], -1)
        o_cam = eye_sign[..., None] * 0.5 * cam.eye_distance * offset_dir
    if cfg.dof:
        lens = sampler.in_unit_disk(u_lens) * 0.5 * cam.aperture_diameter
        focus_pt = o_cam + d_cam * (cam.focus_distance
                                    / torch.clamp_min(-d_cam[..., 2:3], 1e-6))
        o_cam = o_cam + torch.cat([lens, torch.zeros_like(lens[..., :1])], -1)
        d_cam = focus_pt - o_cam
    tf = cam.transformation
    if cfg.anim_id >= 0:
        if anims is None:
            raise ValueError("camera_rays: an animated camera needs the scene's AnimTable")
        tf = animated_pose(tf, anims, cfg.anim_id, time)
    d_world = quat_rotate(tf.rotation, normalize(d_cam))
    o_world = quat_rotate(tf.rotation, o_cam * tf.scale) + tf.translation
    return o_world, d_world, time


def camera_space_to_image_space(cam: CameraParams, cfg: CameraConfig, p_cam, width: int,
                                height: int):
    """Pixel coordinates [N, 2] of camera-space points p_cam [N, 3]
    (camera.py:273-294, camera.hpp:205-217), off-screen ones too: the
    pinhole through the lens model's forward distortion, or the equirect
    surround camera's angles."""
    if cfg.surround == SurroundMode.OFF:
        z = torch.clamp_max(p_cam[..., 2], -1e-6)
        # the inverse of camera_rays: normalized image coordinates (-x / z, y / z)
        xy = torch.stack([-p_cam[..., 0] / z, p_cam[..., 1] / z], -1)
        dist = distort_normalized(cam, cfg, xy)
        return torch.stack([dist[..., 0] * cam.focal_px[0] + cam.center_px[0],
                            dist[..., 1] * cam.focal_px[1] + cam.center_px[1]], -1)
    span = math.pi if cfg.surround == SurroundMode.S360 else math.pi / 2.0
    d = normalize(p_cam)
    phi = torch.atan2(d[..., 0], -d[..., 2])
    theta = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0))
    return torch.stack([(phi * _recip(span) + 1.0) * 0.5 * width,
                        (0.5 - theta * _recip(math.pi)) * height], -1)


def world_to_camera(cam: CameraParams, p_world):
    """World points [N, 3] in the camera's frame (camera.py:297-299)."""
    tf = cam.transformation
    return quat_rotate(quat_conjugate(tf.rotation), p_world - tf.translation) / tf.scale
