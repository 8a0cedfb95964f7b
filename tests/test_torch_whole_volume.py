"""The port's ``whole_volume`` mode (resize to the model size, one
forward, logits resized back) against the JAX package's, through the
level-1 region (``ps2d_levels=2``, seeded random weights, model size
16^3). Bounds as stated in test_torch_predictor.py.
"""

import numpy as np

from test_torch_predictor import _drift, _pair, _volume


def test_whole_volume_matches_jax():
    jp, tp = _pair("random-levels2", image_size=(16, 16, 16))
    assert tp.seg_model.halo_levels((16, 16, 16)) == 2
    vol = _volume()
    ref_l, ref_c = jp.segment_with_confidence(vol, mode="whole_volume")
    got_l, got_c = tp.segment_with_confidence(vol, mode="whole_volume")
    assert got_l.shape == got_c.shape == vol.shape[:3]
    assert got_l.dtype == np.int8 and got_c.dtype == np.float32
    d, margin = _drift(jp, tp, vol, "whole_volume")
    assert (got_l == ref_l).mean() >= 0.99, (got_l != ref_l).mean()
    assert not ((got_l != ref_l) & (margin > 2 * d)).any()
    assert np.abs(got_c - ref_c).max() <= 0.5 * d + 1e-6, (
        np.abs(got_c - ref_c).max(), d)
    np.testing.assert_array_equal(tp.segment_tumor(vol, "whole_volume"),
                                  got_l)
