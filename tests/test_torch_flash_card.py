"""The flash kernel at head dims over 64, on the card, against its plain
version (no tpu_ac import: the card's machine runs these with
``-m cuda``).  Head dims over 64 run the wide kernels: one launch a call
up to 256 columns, one per 256-column slice of V above; the check is
element by element within ``flash_tolerance``, as for Dh = 64."""

import numpy as np
import pytest
import torch

from tpu_ac_torch.kernels import attention as tattn


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [80, 128, 200, 256, 320])
@pytest.mark.parametrize("s,n_valid", [(785, None), (130, 100), (1, None)])
def test_wide_head_dim_on_card(dtype, dh, s, n_valid):
    """The strided q/k/v views of a packed qkv (they go in without a
    copy); one launch a call of the wide kernel, two at Dh 320."""
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(dh + s)
    qkv = torch.from_numpy(rng.standard_normal((2, s, 3, 4, dh)).astype(
        np.float32)).to("cuda", dtype).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    bias = None
    if n_valid is not None:
        bias = torch.zeros(1, 1, 1, s, device="cuda")
        bias[..., n_valid:] = -1e9
    scale = dh ** -0.5
    before = (tattn.LAUNCHES, tattn.LAUNCHES_WIDE)
    got = tattn.flash_attention_impl(q, k, v, scale, bias)
    torch.cuda.synchronize()
    n = -(-dh // tattn.WIDE_SLICE)
    assert (tattn.LAUNCHES, tattn.LAUNCHES_WIDE) == (before[0] + n,
                                                      before[1] + n)
    assert got.shape == (2, 4, s, dh) and got.dtype == dtype
    ids = tattn.bias_to_segment_ids(bias, s)
    want = tattn.flash_attention_plain(q, k, v, scale, ids)
    tol = tattn.flash_tolerance(q, k, v, scale, ids, want)
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= tol).all()), float((gap / tol).max())
