"""``boundary_loss`` and ``combined_loss3d`` on D slabs, on the CPU: two
gloo ranks (``tests/_torch_parallel_workers.py``, bounded waits), each on
its 4-plane slab of a (1, 8, 5, 4, 3) volume, against the JAX package's
functions on the whole volume.

Bounds: each value (and each part) within 1e-6 relative of JAX's (the
slabs' sums meet in another order than the whole volume's; the volume is
small because the f32 means themselves drift with size: at (2, 8, 6, 6,
4) JAX's own boundary mean lies 1.24e-6 from its float64 value), the
gradient assembled from the ranks' slabs at a cosine of at least
0.999999 with JAX's. Without a group both functions are the whole
volume's as before: bit-equal to the former formula (each axis's
difference of the softmax and of the one-hot taken apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_workers import World
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu import (
    losses as JL)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch import (
    losses as L)


def _inputs():
    rng = np.random.default_rng(11)
    logits = (rng.normal(size=(1, 8, 5, 4, 3)) * 2).astype(np.float32)
    targets = rng.integers(0, 3, size=(1, 8, 5, 4)).astype(np.int64)
    return logits, targets


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    logits, targets = _inputs()
    world = World("loss3d_slabs", (logits, targets),
                  tmp_path_factory.mktemp("loss3d"))
    jt = jnp.asarray(targets)
    want = {}
    for name, fn in (("boundary", lambda lg: (JL.boundary_loss(lg, jt), {})),
                     ("combined3d", lambda lg: JL.combined_loss3d(lg, jt))):
        (v, parts), gr = jax.value_and_grad(fn, has_aux=True)(
            jnp.asarray(logits))
        want[name] = (float(v), {k: float(p) for k, p in parts.items()},
                      np.asarray(gr))
    return world.results(), want


@pytest.mark.parametrize("name", ["boundary", "combined3d"])
def test_slab_loss_matches_jax_whole_volume(ranks, name):
    got, want = ranks
    v, parts, _ = want[name]
    for r in got:
        rv, rparts, _ = r[name]
        assert abs(rv - v) <= 1e-6 * abs(v), (rv, v)
        assert rparts.keys() == parts.keys()
        for k in parts:
            assert abs(rparts[k] - parts[k]) <= 1e-6 * abs(parts[k]), k


@pytest.mark.parametrize("name", ["boundary", "combined3d"])
def test_slab_gradient_matches_jax_whole_volume(ranks, name):
    got, want = ranks
    g = np.concatenate([r[name][2] for r in got], axis=1).ravel()
    w = want[name][2].ravel()
    cos = float(g @ w / np.linalg.norm(g) / np.linalg.norm(w))
    assert cos >= 0.999999, cos
    # the planes beside the slab seam carry the neighbour's plane
    gs = np.concatenate([r[name][2] for r in got], axis=1)
    np.testing.assert_allclose(gs[:, 3:5], want[name][2][:, 3:5],
                               rtol=1e-4, atol=1e-7)


def _former_boundary(logits, targets):
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = L._one_hot(targets, logits.shape[-1])

    def grad_mag(t):
        total = torch.zeros_like(t)
        for ax in L.SPATIAL:
            d = torch.diff(t, dim=ax).abs()
            pad = [0, 0] * (t.ndim - 1 - ax) + [0, 1]
            total = total + torch.nn.functional.pad(d, pad)
        return total
    return (grad_mag(probs) - grad_mag(onehot)).square().mean()


def test_without_a_group_as_before():
    logits, targets = _inputs()
    lg, tg = torch.from_numpy(logits), torch.from_numpy(targets)
    assert torch.equal(L.boundary_loss(lg, tg), _former_boundary(lg, tg))
    total, parts = L.combined_loss3d(lg, tg)
    assert torch.equal(parts["boundary_loss"], _former_boundary(lg, tg))
    assert torch.equal(parts["dice_loss"], L.softmax_dice_loss(lg, tg, 1e-5))
    assert torch.equal(parts["focal_loss"],
                       L.focal_loss(lg, tg, alpha=0.25, gamma=2.0))
