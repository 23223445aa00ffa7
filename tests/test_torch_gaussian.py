"""tpu_ac_torch.ops.gaussian against scipy.ndimage.gaussian_filter (sigma 4,
truncate 4, mode "reflect": radius 16), on the CPU and, marked ``cuda``, on
the card.  It imports nothing of tpu_ac.detect, whose sklearn import the
card's machine cannot satisfy.

Tolerance: 1e-5 relative (the port sums 33 f32 taps a side; scipy sums in
float64 and rounds once).
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from tpu_ac_torch.ops.gaussian import gaussian_blur


def _planes(shape, seed):
    return np.random.default_rng(seed).uniform(0, 3, size=shape).astype(
        np.float32)


def _scipy(x):
    return np.stack([ndimage.gaussian_filter(m, sigma=4.0) for m in x])


@pytest.mark.parametrize("shape", [(3, 20, 20), (2, 5, 7), (1, 1, 3),
                                   (2, 40, 2), (1, 56, 56)])
def test_blur_matches_scipy(shape):
    """Sides of 1-7 are smaller than the radius of 16: the mirror indices
    repeat with period 2n, as scipy's "reflect" does."""
    x = _planes(shape, 14)
    got = gaussian_blur(torch.from_numpy(x), 4.0).numpy()
    want = _scipy(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_blur_on_card_matches_scipy():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the segmentor's card path)")
    x = _planes((4, 224, 224), 16)
    got = gaussian_blur(torch.from_numpy(x).cuda(), 4.0).cpu().numpy()
    want = _scipy(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
