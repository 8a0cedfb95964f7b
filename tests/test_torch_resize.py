"""The port's ``ops/resize.py`` against the JAX package's, on the CPU.

  * ``resize_trilinear`` against ``jax.image.resize(trilinear)``,
    which antialiases when it downsamples: both compute in float32 with
    the same per-axis weights and contract them in another order, so
    the results agree within 1e-5 of the largest value. Cases:
    downsampling as classify_tumor and whole_volume do it (240->128,
    155->128, on the small stand-ins 30->16 and 31->16), upsampling
    (the logits back to the input size), odd sizes, mixed axes, one
    axis unchanged, bf16 in and out.
  * ``adaptive_avg_pool``: bit-exact against JAX on bf16 inputs, both
    on divisible sizes (block means) and on torch's uneven bins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.ops import resize as J
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops import resize as T


@pytest.mark.parametrize("shape,size", [
    ((2, 30, 31, 17, 3), (16, 16, 16)),     # downsample, as 240/155 -> 128
    ((1, 16, 16, 16, 4), (30, 30, 19)),     # upsample, as 128 -> 240/155
    ((1, 5, 7, 9, 2), (11, 3, 9)),          # odd sizes, mixed, W unchanged
    ((1, 9, 8, 13, 1), (4, 17, 6)),
    ((2, 6, 6, 6, 4), (6, 6, 6)),           # identity
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_trilinear_matches_jax(shape, size, dtype):
    rng = np.random.default_rng(sum(shape) + sum(size))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        getattr(torch, dtype))
    ref = J.resize_trilinear(jnp.asarray(x.float().numpy(), dtype), size)
    got = T.resize_trilinear(x, size)
    assert got.dtype == x.dtype and tuple(got.shape) == tuple(ref.shape)
    ref = np.asarray(ref.astype(jnp.float32))
    d = np.abs(got.float().numpy() - ref).max()
    if dtype == "float32":
        assert d <= 1e-5 * np.abs(ref).max(), d
    else:   # one bf16 rounding of the same f32 value, ties aside
        assert d <= 2.0 ** -7 * np.abs(ref).max(), d


def test_trilinear_weights_antialias():
    """Downsampling widens the triangle (every input sample is used and
    each column sums to 1); upsampling interpolates between two."""
    w = T.trilinear_weights(240, 128)
    np.testing.assert_allclose(w.sum(0), 1.0, rtol=1e-6)
    assert (w > 0).any(axis=1).all()
    assert (w > 0).sum(0).max() >= 3           # wider than 2 taps
    u = T.trilinear_weights(128, 240)
    np.testing.assert_allclose(u.sum(0), 1.0, rtol=1e-6)
    assert (u > 0).sum(0).max() <= 2


@pytest.mark.parametrize("shape,out", [
    ((2, 8, 8, 8, 5), (4, 4, 4)),            # block means (classifier)
    ((1, 16, 8, 4, 3), (4, 4, 4)),
    ((2, 6, 7, 9, 5), (4, 4, 4)),            # torch's uneven bins
    ((1, 5, 9, 3, 2), (2, 4, 3)),
])
def test_adaptive_avg_pool_matches_jax(shape, out):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)
    ref = J.adaptive_avg_pool(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              out)
    got = T.adaptive_avg_pool(x, out)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
