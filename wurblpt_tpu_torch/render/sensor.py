"""Sensors (port of ``wurblpt_tpu/render/sensor.py``): SensorRGB and SensorTofAmcw.

A sensor turns a radiance event along a path into a deposit into the lane's
accumulator. `deposit(ev)` gives the deposit and the lanes that take it;
`accumulate(acc, ev)` adds it, ``acc + where(ok, deposit, 0)``. The
wavefront step of the diffuse class (:mod:`.wavefront`, K4) computes the
same deposits inside its kernel, with the sensor's numbers as parameters,
and keeps the NEE deposit pending until its shadow ray is resolved.

* SensorRGB: RGB with optional windows on the optical path length (R
  channel) and the distance to the light, for light-in-flight imaging
  (sensor_rgb.hpp:33-100).
* SensorTofAmcw: the amplitude-modulated continuous-wave time-of-flight
  sensor (sensor_tof_amcw.hpp:52-265). One render is one phase image: the
  accumulator holds the two correlation buckets (a, b) and the NIR energy,
  from the NIR radiance and the NIR optical path length of each event.
  `phase` converts energies to electrons with shot noise and saturation,
  `result` reconstructs distance, amplitude and intensity from 4 phases.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.constants import SPEED_OF_LIGHT
from ..core.rng import _to_unit_float, hash4


def _recip(c) -> float:
    """float32(1) / float32(c): the factor XLA multiplies by for `x / c`."""
    return float(np.float32(1.0) / np.float32(c))


class SensorEvent(NamedTuple):
    """One radiance deposit along a path (argument set of accumulateRadiance)."""

    radiance: torch.Tensor            # [N, 4] throughput-weighted RGB + NIR
    path_component: torch.Tensor      # [N] bounce index
    geom_path_length: torch.Tensor    # [N]
    optical_path_length: torch.Tensor  # [N, 4]
    distance_to_light: torch.Tensor   # [N] last-segment length (0 if none)
    active: torch.Tensor              # [N] bool: lanes that deposit


@dataclass(frozen=True)
class SensorRGB:
    """RGB sensor with optional light-in-flight windows (sensor_rgb.hpp:63-80)."""

    opl_min: float = 0.0
    opl_max: float = float("inf")
    dtl_min: float = 0.0
    dtl_max: float = float("inf")

    n_acc: int = 3

    def deposit(self, ev: SensorEvent):
        """(deposit [N, 3], lanes that take it [N])."""
        opl = ev.optical_path_length[..., 0]  # R channel drives the window
        ok = (
            ev.active
            & (opl >= self.opl_min)
            & (opl <= self.opl_max)
            & (ev.distance_to_light >= self.dtl_min)
            & (ev.distance_to_light <= self.dtl_max)
        )
        return ev.radiance[..., :3], ok

    def accumulate(self, acc, ev: SensorEvent):
        dep, ok = self.deposit(ev)
        return acc + torch.where(ok[..., None], dep, 0.0)

    def finish(self, acc_image, inv_samples):
        return acc_image * inv_samples


@dataclass(frozen=True)
class SensorTofAmcw:
    """AMCW ToF sensor (IEEE Sensors 2015 model; sensor_tof_amcw.hpp).

    One render is one phase image, `phase_index` i in 0..3 with tau_i =
    i pi / 2. The phase shift of an event is phi = 2 pi * opl.w * f / c
    (sensor_tof_amcw.hpp:243-251), evaluated in float32 as the JAX package
    does: times float32(2 pi), then times float32(f / c); tau + phi is a
    float32 add."""

    modulation_frequency: float = 20e6
    phase_index: int = 0
    contrast: float = 0.75
    # Timing model (sensor_tof_amcw.hpp:117-138)
    fps: float = 30.0
    exposure_time: float = 1e-3          # seconds per phase image
    readout_time: float = 1e-3
    pause_time: float = 0.0
    duty_cycle: float = 0.5
    # Radiometric conversion
    pixel_area: float = (12e-6) ** 2     # m^2
    aperture_factor: float = 1.0         # lumped lens / solid-angle factor
    quantum_efficiency: float = 0.8
    energy_per_electron: float = 1.3e-19  # J at ~850 nm (h c / lambda)
    max_electrons: float = 100000.0

    n_acc: int = 3

    # -- per-frame timing (host) ---------------------------------------------
    def phase_image_duration(self) -> float:
        return self.exposure_time + self.readout_time

    def frame_duration(self) -> float:
        return 1.0 / self.fps

    def phase_start_time(self, i: int) -> float:
        return i * self.phase_image_duration()

    # -- accumulation ----------------------------------------------------------
    def deposit(self, ev: SensorEvent):
        """((a, b, energy) [N, 3], lanes that take it [N]): NIR irradiance ->
        power -> energy (sensor_tof_amcw.hpp:238-241), split into the two
        correlation buckets by the event's phase."""
        irradiance = ev.radiance[..., 3]
        power = irradiance * self.pixel_area * self.aperture_factor
        energy = power * self.exposure_time * self.duty_cycle
        phi = (2.0 * math.pi * ev.optical_path_length[..., 3]
               * (self.modulation_frequency / SPEED_OF_LIGHT))
        c = torch.cos(self.phase_index * (math.pi / 2.0) + phi)
        a = 0.5 * energy * (1.0 + self.contrast * c)
        b = 0.5 * energy * (1.0 - self.contrast * c)
        return torch.stack([a, b, energy], -1), ev.active

    def accumulate(self, acc, ev: SensorEvent):
        dep, ok = self.deposit(ev)
        return acc + torch.where(ok[..., None], dep, 0.0)

    def finish(self, acc_image, inv_samples):
        return acc_image * inv_samples

    # -- post-processing ---------------------------------------------------------
    def phase(self, acc_image, shot_noise_factor: float = 0.0, seed: int = 0):
        """Energy buckets [H, W, 3] -> electron counts (a_e, b_e, intensity_e)
        with shot noise and saturation (sensor_tof_amcw.hpp:147-169). The
        noise is a standard normal per pixel and channel by Box-Muller from
        hash4(pixel, channel, seed, 0xBEEF), as the JAX package draws it."""
        electrons = acc_image * (self.quantum_efficiency / self.energy_per_electron)
        if shot_noise_factor > 0.0:
            h, w = electrons.shape[0], electrons.shape[1]
            dev = electrons.device
            pix = (torch.arange(h, device=dev)[:, None] * w
                   + torch.arange(w, device=dev)[None, :])
            out = []
            for c in range(electrons.shape[-1]):
                v0, v1, _, _ = hash4(pix, c, seed, 0xBEEF)
                u1, u2 = _to_unit_float(v0), _to_unit_float(v1)
                g = (torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, 1e-12)))
                     * torch.cos(2.0 * math.pi * u2))
                e = electrons[..., c]
                out.append(e + g * torch.sqrt(torch.clamp_min(e, 0.0)) * shot_noise_factor)
            electrons = torch.stack(out, -1)
        return torch.clamp(electrons, 0.0, self.max_electrons)

    def result(self, phases):
        """4 phase images (a, b, intensity electrons, [H, W, 3], phase indices
        0..3) -> (distance, amplitude, intensity) [H, W]
        (sensor_tof_amcw.hpp:171-213): I/Q demodulation, phase =
        atan2(d3 - d1, d0 - d2) with d_i = a_i - b_i, wrapped to [0, 2 pi)."""
        d = [p[..., 0] - p[..., 1] for p in phases]
        q = d[3] - d[1]
        i = d[0] - d[2]
        phi = torch.atan2(q, i)
        phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        # x / constant as XLA evaluates it: times the float32 reciprocal.
        distance = phi * SPEED_OF_LIGHT * _recip(4.0 * math.pi * self.modulation_frequency)
        amplitude = 0.5 * torch.sqrt(i * i + q * q) * _recip(max(self.contrast, 1e-6))
        intensity = 0.25 * sum(p[..., 2] for p in phases)
        return distance, amplitude, intensity
