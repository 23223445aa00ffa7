"""The flash kernel at head dims over 64, on the card, against its plain
version (no tpu_ac import: the card's machine runs these with
``-m cuda``).  Head dims over 64 are zero-padded to a multiple of 64 and
run as one launch per 64-column slice of V; the check is element by
element within ``flash_tolerance``, as for Dh = 64."""

import numpy as np
import pytest
import torch

from tpu_ac_torch.kernels import attention as tattn


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [80, 128, 200])
@pytest.mark.parametrize("s,n_valid", [(785, None), (130, 100), (1, None)])
def test_wide_head_dim_on_card(dtype, dh, s, n_valid):
    """The strided q/k/v views of a packed qkv (Dh = 128 goes in without a
    copy); ceil(Dh / 64) launches a call."""
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
    before = tattn.LAUNCHES
    got = tattn.flash_attention_impl(q, k, v, scale, bias)
    torch.cuda.synchronize()
    assert tattn.LAUNCHES == before + -(-dh // 64)
    assert got.shape == (2, 4, s, dh) and got.dtype == dtype
    ids = tattn.bias_to_segment_ids(bias, s)
    want = tattn.flash_attention_plain(q, k, v, scale, ids)
    tol = tattn.flash_tolerance(q, k, v, scale, ids, want)
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= tol).all()), float((gap / tol).max())
