"""Cameras (port of ``wurblpt_tpu/render/camera.py``: the pinhole and the
equirect surround cameras, mono or stereo).

`CameraConfig` keeps the JAX package's switches so that a configuration
outside the slice (distortion, depth of field, an animated pose) is refused
by :func:`check_camera` instead of rendered wrong.

Where the JAX package divides by a Python constant, XLA multiplies by the
float32 reciprocal of the constant; `_recip` gives that factor, so the port
rounds as the reference does on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import math

import numpy as np
import torch

from ..core.transform import Transformation, quat_rotate
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
    """Static camera switches (the slice renders the default: a pinhole)."""

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
    device="cpu",
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
    """Raise NotImplementedError for any camera feature outside the ported slice."""
    off = {
        "distortion": cfg.distortion != DistortionModel.NONE,
        "depth of field": cfg.dof,
        "animated camera": cfg.anim_id >= 0,
    }
    bad = [k for k, v in off.items() if v]
    if bad:
        raise NotImplementedError(f"camera features outside the ported slice: {bad}")


def _recip(c) -> float:
    """float32(1) / float32(c): the factor XLA multiplies by for `x / c`."""
    return float(np.float32(1.0) / np.float32(c))


def camera_rays(cam: CameraParams, cfg: CameraConfig, pixel_xy, width: int, height: int):
    """World-space rays through pixel coords [N, 2] (camera.hpp:123-185).

    Stereo packs the left eye into the top half of the image and the right
    eye into the bottom half. A surround camera maps the width to [-pi, pi]
    (S360) or [-pi/2, pi/2] (S180) and the (half) height to [pi/2, -pi/2];
    its stereo eyes sit on a circle of diameter `eye_distance`, offset
    perpendicular to each viewing column (ODS, camera.hpp:74-79). Returns
    (origin [N, 3], direction [N, 3]); the JAX version's ray time is left out
    (no motion blur, no animation in the slice)."""
    check_camera(cfg)
    px, py = pixel_xy[..., 0], pixel_xy[..., 1]
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
        d_cam = torch.stack([nx, -ny, -torch.ones_like(nx)], -1)
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
    tf = cam.transformation
    d_world = quat_rotate(tf.rotation, normalize(d_cam))
    o_world = quat_rotate(tf.rotation, o_cam * tf.scale) + tf.translation
    return o_world, d_world
