"""The port's two resizes (sanerf_hq_tpu_torch/utils/resize.py) against
what the JAX package calls: OpenCV's cv2.resize INTER_LINEAR on uint8
(set_image) and jax.image.resize "bilinear" (set_features, _upscale, and
the rel-pos resize).

Tolerances: the uint8 resize is bitwise equal to cv2's; the float resize
within max abs 1e-6 (fp32 weights, a different summation order) on unit
normal inputs.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_hq_tpu_torch.utils.resize import (bilinear_weights,
                                              resize_bilinear,
                                              resize_uint8_linear)


@pytest.mark.parametrize("src,dst", [
    ((512, 512), (1024, 1024)),    # a 512 view up to the encoder's input
    ((2048, 2048), (1024, 1024)),  # a 2048 view down: OpenCV's 2x box path
    ((300, 500), (614, 1024)),     # non-square, up
    ((2048, 1536), (1024, 768)),   # non-square, down by 2
    ((777, 1001), (795, 1024)),    # odd sizes
    ((1024, 500), (1024, 1000)),   # one axis unchanged
    ((48, 60), (51, 64)),          # the tiny SAM's input
    ((64, 64), (64, 64)),          # identity
])
def test_uint8_linear_equals_cv2(src, dst):
    img = np.random.default_rng(sum(src)).integers(0, 256, (*src, 3),
                                                   dtype=np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_uint8_linear(torch.as_tensor(img), *dst)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_uint8_linear_equals_cv2_on_a_smooth_image():
    """A rendered view is smooth, where rounding ties are common."""
    yy, xx = np.mgrid[0:512, 0:384]
    img = np.stack([(xx * 255 // 383), (yy * 255 // 511),
                    ((xx + yy) % 256)], -1).astype(np.uint8)
    want = cv2.resize(img, (768, 1024), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(
        resize_uint8_linear(torch.as_tensor(img), 1024, 768).numpy(), want)


@pytest.mark.parametrize("src,dst", [
    ((3, 256, 256), (3, 1024, 1024)),      # _upscale's first resize
    ((3, 1024, 1024), (3, 512, 512)),      # _upscale to a 512 view
    ((3, 512, 683), (3, 384, 512)),        # non-square, shrinking
    ((4, 256, 256), (4, 64, 64)),          # 4x shrink: the widest kernel
    ((2, 683, 1024), (2, 77, 115)),        # uneven factors
    ((1, 48, 64, 8), (1, 16, 21, 8)),      # set_features, channels last
    ((1, 64, 48, 16), (1, 64, 48, 16)),    # unchanged: returned as is
    ((5, 7), (13, 3)),                     # rel-pos tables: one axis each
])
def test_bilinear_equals_jax_image_resize(src, dst):
    x = np.random.default_rng(len(src) + src[-1]).normal(size=src).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    got = resize_bilinear(torch.as_tensor(x), dst).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


def test_bilinear_weights_rows_sum_to_one():
    for n_in, n_out in ((256, 1024), (1024, 77), (7, 13)):
        w = bilinear_weights(n_in, n_out)
        assert w.shape == (n_out, n_in)
        np.testing.assert_allclose(w.sum(1).numpy(), 1.0, atol=1e-6)
