"""The port's colour module (wurblpt_tpu_torch/core/color.py) on the six
tests of tests/test_color.py, on torch tensors and on numpy arrays, and
held to the JAX package's functions on the same inputs: equal but for the
last bits of exp and pow (rtol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wurblpt_tpu.core import color as jcolor
from wurblpt_tpu_torch.core import color


@pytest.fixture(params=["torch", "numpy"])
def arr(request):
    return torch.tensor if request.param == "torch" else (lambda x: np.asarray(x, np.float32))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_xyz_rgb_roundtrip(arr):
    rgb = np.random.default_rng(0).random((64, 3)).astype(np.float32)
    back = color.xyz_to_rgb(color.rgb_to_xyz(arr(rgb)))
    np.testing.assert_allclose(_np(back), rgb, atol=1e-4)
    np.testing.assert_allclose(_np(color.rgb_to_xyz(arr(rgb))),
                               np.asarray(jcolor.rgb_to_xyz(jnp.asarray(rgb))), rtol=1e-6,
                               atol=1e-7)


def test_srgb_roundtrip_and_anchors(arr):
    x = np.linspace(0, 1, 64, dtype=np.float32)
    np.testing.assert_allclose(_np(color.srgb_to_rgb(color.rgb_to_srgb(arr(x)))), x, atol=1e-5)
    assert abs(float(color.rgb_to_srgb(arr(0.0)))) <= 1e-7
    assert abs(float(color.rgb_to_srgb(arr(1.0))) - 1.0) <= 1e-6
    for f in ("rgb_to_srgb", "srgb_to_rgb"):
        np.testing.assert_allclose(_np(getattr(color, f)(arr(x))),
                                   np.asarray(getattr(jcolor, f)(jnp.asarray(x))), rtol=1e-6,
                                   atol=1e-7)


def test_cmf_peaks_and_support(arr):
    lam = np.arange(380.0, 741.0, 1.0, dtype=np.float32)
    xyz = _np(color.color_matching_function(arr(lam)))
    assert abs(lam[xyz[:, 1].argmax()] - 555) < 15
    assert abs(lam[xyz[:, 0].argmax()] - 600) < 15
    assert abs(lam[xyz[:, 2].argmax()] - 450) < 15
    assert np.abs(_np(color.color_matching_function(arr([300.0, 830.0])))).max() < 0.02
    np.testing.assert_allclose(xyz, np.asarray(jcolor.color_matching_function(jnp.asarray(lam))),
                               rtol=1e-6, atol=1e-7)


def test_d65_is_normalized_near_560(arr):
    assert 90.0 < float(color.d65(arr(560.0))) < 110.0
    assert float(color.d65(arr(460.0))) > float(color.d65(arr(700.0)))
    lam = np.arange(380.0, 781.0, 5.0, dtype=np.float32)
    np.testing.assert_allclose(_np(color.d65(arr(lam))), np.asarray(jcolor.d65(jnp.asarray(lam))),
                               rtol=2e-6)


def test_luminance_weights(arr):
    for rgb, y in (([1.0, 0, 0], 0.2126), ([0, 1.0, 0], 0.7152), ([1.0, 1.0, 1.0], 1.0)):
        assert abs(float(color.rgb_luminance(arr(rgb))) - y) < 1e-3


def test_byte_float_quantization(arr):
    b = np.arange(256, dtype=np.int32)
    f = color.byte_to_float(torch.tensor(b) if arr is torch.tensor else b)
    np.testing.assert_array_equal(_np(color.float_to_byte(f)), np.arange(256))
    # half to even, as jnp.round
    half = arr([0.5 / 255, 1.5 / 255, 2.5 / 255])
    np.testing.assert_array_equal(_np(color.float_to_byte(half)),
                                  np.asarray(jcolor.float_to_byte(jnp.asarray(_np(half)))))
