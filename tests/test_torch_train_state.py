"""The port's optimizer, schedule and train state against the JAX
package's ``train/state.py`` (optax), on the CPU.

  * SGDR: ``cosine_warm_restarts`` at every step of many epochs, t_mult
    1, 2 and 3, within 1e-6 relative or 1e-6 of the peak rate (JAX
    evaluates it in float32, whose rounding of 1 + cos near a cycle's
    end is a few 1e-8 of the peak: 1.4e-6 of the rate itself there);
  * AdamW updates, with and without ``clip_by_global_norm``, on
    identical f32 parameters and gradients: the new parameters within
    1e-6 relative of each tensor's largest value (torch decays the
    parameter before the Adam step, optax adds wd * p to the direction:
    the same update to f32 rounding, which on an element near zero is
    ~2e-9 absolute, a few 1e-6 of that element);
  * the EMA of the parameters and ``current_lr``;
  * the weight bridge's arrays do not alias the model's parameters.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.config import (
    OptimizerConfig as JOptimizerConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu.train import state as JS
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.config import (
    Config, OptimizerConfig)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.models import (
    UNet3D, to_flax_variables)
from segmentation_and_classification_of_brain_tumor_using_3d_unet_tpu_torch.train import state as TS


@pytest.mark.parametrize("t_0,t_mult,spe", [(10, 2, 1), (10, 2, 3),
                                            (5, 1, 2), (3, 3, 4)])
def test_sgdr_matches_jax(t_0, t_mult, spe):
    ours = TS.cosine_warm_restarts(1e-4, t_0, t_mult, 1e-6, spe)
    ref = JS.cosine_warm_restarts(1e-4, t_0, t_mult, 1e-6, spe)
    for step in range(0, 140 * spe, max(spe // 2, 1)):
        want = float(ref(step))
        assert ours(step) == pytest.approx(want, rel=1e-6,
                                           abs=1e-6 * 1e-4), step
    # constant within an epoch, a restart at the cycle's end
    assert ours(spe - 1) == ours(0) == pytest.approx(1e-4)
    assert ours(t_0 * spe) == pytest.approx(1e-4)
    assert ours(t_0 * spe - 1) < ours(0)


def _params(seed):
    rng = np.random.default_rng(seed)
    shapes = [(3, 3, 3, 4, 8), (8,), (16, 4), (1,)]
    p = [rng.normal(size=s).astype(np.float32) * 0.1 for s in shapes]
    g = [rng.normal(size=s).astype(np.float32) * 0.01 for s in shapes]
    return p, g


@pytest.mark.parametrize("clip", [0.0, 0.05, 10.0])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_optax(clip, steps):
    """``steps`` updates with the default config (SGDR at 1e-4, weight
    decay 1e-4) from the same parameters and gradients; a clip of 0.05
    is below the gradients' norm (clipping acts), 10 above it."""
    p0, g = _params(steps)
    jcfg = dataclasses.replace(JOptimizerConfig(), grad_clip_norm=clip)
    tx = JS.build_optimizer(jcfg, steps_per_epoch=2)
    jp = [np.array(a) for a in p0]
    opt_state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in p0]
    opt = TS.build_optimizer(OptimizerConfig(grad_clip_norm=clip), params,
                             steps_per_epoch=2)
    for k in range(steps):
        gk = [a * (1.0 + 0.5 * k) for a in g]
        upd, opt_state = tx.update(gk, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([torch.from_numpy(a) for a in gk], k)
    for got, want, start in zip(params, jp, p0):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
        # the parameters did move (lr 1e-4 a step)
        assert np.abs(want - start).max() > 1e-5


def test_train_state_ema_and_current_lr():
    torch.manual_seed(0)
    model = UNet3D(features=(8,), device="cpu")
    cfg = Config(ema_decay=0.9)
    state = TS.create_train_state(model, cfg, steps_per_epoch=2)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert all(torch.equal(state.ema_params[n], start[n]) for n in start)
    grads = [torch.randn_like(p) * 0.01 for p in model.parameters()]
    mean = torch.full((4,), 0.5)
    var = torch.full((4,), 2.0)
    state = state.apply_gradients(grads, batch_stats=(mean, var))
    assert state.step == 1
    assert torch.equal(model.head_bn.mean, mean)
    assert torch.equal(model.head_bn.var, var)
    for n, p in model.named_parameters():
        want = 0.9 * start[n] + 0.1 * p.detach()
        torch.testing.assert_close(state.ema_params[n], want, rtol=0,
                                   atol=1e-7)
    view = TS.ema_eval_state(state)
    assert view.model is not model
    for n, p in view.model.named_parameters():
        assert torch.equal(p, state.ema_params[n])
    assert TS.ema_eval_state(TS.create_train_state(model, Config())) \
        .model is model
    # current_lr: the schedule at the count of updates made
    ocfg = cfg.optimizer
    for steps in (1, 2, 21):
        state.step = steps
        want = float(JS.cosine_warm_restarts(
            ocfg.learning_rate, ocfg.t_0, ocfg.t_mult, ocfg.eta_min, 2)(steps))
        assert TS.current_lr(state, ocfg, 2) == pytest.approx(want, rel=1e-6)
    with pytest.raises(ValueError, match="ema_decay"):
        TS.create_train_state(model, Config(ema_decay=1.0))


def test_flax_variables_do_not_alias_the_model():
    """The weight bridge's arrays are copies: the optimizer's in-place
    step leaves a tree taken before it (and so a JAX state made from it,
    which may still be reading it) as it was."""
    model = UNet3D(features=(8,), device="cpu")
    tree = to_flax_variables(model.state_dict())
    before = jax.tree_util.tree_map(np.copy, tree)
    state = TS.create_train_state(model, Config(), steps_per_epoch=2)
    state.apply_gradients([torch.ones_like(p) for p in model.parameters()],
                          batch_stats=(torch.full((4,), 0.5),
                                       torch.full((4,), 2.0)))
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree, before)
    moved = to_flax_variables(model.state_dict())
    assert not np.array_equal(moved["batch_stats"]["head_bn"]["var"],
                              tree["batch_stats"]["head_bn"]["var"])
    assert not np.array_equal(moved["params"]["head_out"]["kernel"],
                              tree["params"]["head_out"]["kernel"])
