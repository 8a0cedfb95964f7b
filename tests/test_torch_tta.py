"""The port's mirror TTA (``segment_with_confidence(tta=True)`` and
``segment_tumor(tta=True)``) against the JAX package's, in ``cropped``
mode (8 flipped volumes, each cropped and blended) and in
``whole_volume`` mode (one batch-8 forward), on the trained fixture.
The ps2d region is off here: TTA is the same code over either forward,
and the region's parity is held by test_torch_unet.py,
test_torch_level1.py and test_torch_confidence.py. Bounds as stated in
test_torch_predictor.py: labels agree at >= 0.99, confidences within
twice half the unflipped run's largest logit drift. The volume is small
(its crop is one 16^3 window), which keeps 8 flips x 2 packages cheap;
the flips still move the crop window, so each flip pastes elsewhere.
"""

import numpy as np
import pytest

from test_torch_predictor import _drift, _pair


def _volume():
    """(20, 26, 22, 4): a small off-centre brain with a tumour blob,
    exact zeros outside (the fixture's blob task)."""
    rng = np.random.default_rng(10)
    zz, yy, xx = np.ogrid[:20, :26, :22]
    brain = (((zz - 8) / 6) ** 2 + ((yy - 14) / 7) ** 2
             + ((xx - 9) / 6) ** 2) < 1
    vol = np.zeros((20, 26, 22, 4), np.float32)
    vol[brain] = rng.normal(0.0, 0.3, (int(brain.sum()), 4))
    blob = (((zz - 8) ** 2 + (yy - 12) ** 2 + (xx - 9) ** 2) < 9) & brain
    vol[blob] += np.asarray([1.0, 0.4, 0.4, 0.0], np.float32)
    return vol


@pytest.mark.parametrize("mode", ["cropped", "whole_volume"])
def test_tta_matches_jax(mode):
    jp, tp = _pair("fixture-levels1", ps2d=False)
    vol = _volume()
    ref_l, ref_c = jp.segment_with_confidence(vol, mode=mode, tta=True)
    got_l, got_c = tp.segment_with_confidence(vol, mode=mode, tta=True)
    assert got_l.shape == got_c.shape == vol.shape[:3]
    assert got_l.dtype == np.int8 and got_c.dtype == np.float32
    d, _ = _drift(jp, tp, vol, mode)
    assert (got_l == ref_l).mean() >= 0.99, (got_l != ref_l).mean()
    assert np.abs(got_c - ref_c).max() <= d + 1e-6, (
        np.abs(got_c - ref_c).max(), d)
    np.testing.assert_array_equal(tp.segment_tumor(vol, mode, tta=True),
                                  got_l)
