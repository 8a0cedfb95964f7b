"""The port's train BatchNorm (``ops/norm.py::batch_norm_train``, the
UNet's head BN at train) against flax ``nn.BatchNorm`` as the JAX
package's UNet builds it (``use_running_average=False, momentum=0.9,
epsilon=1e-5``, f32), on the same f32 array, on the CPU.

The output and the new running mean and variance are held within 1e-6
relative of the largest reference value. The batches are small (N of
16 to 96 per channel), so keeping the unbiased batch variance, as
``F.batch_norm`` does, would move the running variance by
0.1 * v / (N - 1): 1e-3 of the variance or more, far outside the bound.
The test checks that too, so it sees that fault.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.ops.norm import (
    batch_norm_train)

REL = 1e-6


def flax_bn(x, gamma, beta, mean, var):
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                      epsilon=1e-5, dtype=jnp.float32)
    variables = {"params": {"scale": gamma, "bias": beta},
                 "batch_stats": {"mean": mean, "var": var}}
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    st = upd["batch_stats"]
    return np.asarray(y), np.asarray(st["mean"]), np.asarray(st["var"])


def close(got, want, what):
    d = np.abs(got - want).max()
    assert d <= REL * np.abs(want).max(), (what, d, np.abs(want).max())


@pytest.mark.parametrize("shape,offset", [((2, 2, 2, 2, 8), 0.0),
                                          ((2, 3, 2, 2, 16), 0.5),
                                          ((1, 4, 4, 6, 8), -1.0)])
def test_batch_norm_train_matches_flax(shape, offset):
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 2.0, c)
         + offset).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    mean = rng.standard_normal(c).astype(np.float32) * 0.1
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    y_ref, mean_ref, var_ref = flax_bn(x, gamma, beta, mean, var)
    y, (new_mean, new_var) = batch_norm_train(
        torch.from_numpy(x), torch.from_numpy(gamma),
        torch.from_numpy(beta), torch.from_numpy(mean),
        torch.from_numpy(var))
    assert y.dtype == new_mean.dtype == new_var.dtype == torch.float32
    close(y.numpy(), y_ref, "y")
    close(new_mean.numpy(), mean_ref, "running mean")
    close(new_var.numpy(), var_ref, "running var")
    # the unbiased batch variance (F.batch_norm's) is outside the bound
    n = int(np.prod(shape[:-1]))
    xt = torch.from_numpy(x).reshape(n, c)
    unbiased = 0.9 * var + 0.1 * xt.var(0, unbiased=True).numpy()
    assert np.abs(unbiased - var_ref).max() > 100 * REL * np.abs(
        var_ref).max()
    # no gradient reaches the running statistics
    assert not new_mean.requires_grad and not new_var.requires_grad


def test_batch_norm_train_gradient_matches_flax():
    """The gradient of the output through the batch statistics."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 2, 2, 3, 8)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    beta = rng.standard_normal(8).astype(np.float32)
    zeros, ones = np.zeros(8, np.float32), np.ones(8, np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(xj):
        bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                          epsilon=1e-5, dtype=jnp.float32)
        y, _ = bn.apply({"params": {"scale": gamma, "bias": beta},
                         "batch_stats": {"mean": zeros, "var": ones}},
                        xj, mutable=["batch_stats"])
        return jnp.sum(y * r)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = batch_norm_train(xt, torch.from_numpy(gamma),
                            torch.from_numpy(beta), torch.from_numpy(zeros),
                            torch.from_numpy(ones))
    (y * torch.from_numpy(r)).sum().backward()
    d = np.abs(xt.grad.numpy() - want).max()
    assert d <= 1e-5 * np.abs(want).max(), d
