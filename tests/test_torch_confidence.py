"""The port's ``Predictor.segment_with_confidence`` in ``cropped`` mode
(the server's segmentation call) against the JAX package's, with the
level-0 region on the trained fixture and the level-1 region
(``ps2d_levels=2``) on seeded random weights. Bounds as stated in
test_torch_predictor.py: margin contract on the labels, confidence
within half the largest logit drift, background with confidence 1.0
outside the crop window.
"""

import numpy as np
import pytest

from test_torch_predictor import CASES, _crop_mask, _drift, _pair, _volume


@pytest.mark.parametrize("case", list(CASES))
def test_segment_with_confidence_cropped_matches_jax(case):
    jp, tp = _pair(case)
    vol = _volume()
    ref_l, ref_c = jp.segment_with_confidence(vol, mode="cropped")
    got_l, got_c = tp.segment_with_confidence(vol, mode="cropped")
    assert got_l.shape == got_c.shape == vol.shape[:3]
    assert got_l.dtype == np.int8 and got_c.dtype == np.float32
    inside, win, src = _crop_mask(vol)
    assert (got_l[~inside] == 0).all() and (ref_l[~inside] == 0).all()
    assert (got_c[~inside] == 1.0).all() and (ref_c[~inside] == 1.0).all()
    d, margin = _drift(jp, tp, vol, "cropped")
    assert (got_l == ref_l).mean() >= 0.99, (got_l != ref_l).mean()
    dis = (got_l != ref_l)[win]
    assert not (dis & (margin[src] > 2 * d)).any(), (margin[src][dis].max(),
                                                      d)
    assert np.abs(got_c - ref_c).max() <= 0.5 * d + 1e-6, (
        np.abs(got_c - ref_c).max(), d)
