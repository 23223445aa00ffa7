"""tpu_ac_torch.kernels.attention vs tpu_ac.kernels.attention on the CPU:
the wrapper's mask contract, the plain version's segment semantics
(padded query rows included), the layout checks of the CUDA path, and the
launch counter.

The JAX wrapper calls JAX's stock Pallas TPU flash kernel, which has no CPU
mode.  As in tests/test_seq_pad_packed.py, that kernel is monkeypatched to
its own module's pure-jnp ``mha_reference`` (f32 on the CPU), so the
wrapper's bias -> segment-id conversion and head-dim padding run as they
are.  Tolerance: rtol/atol 1e-5 (f32 on both sides, differently ordered
sums).  The CUDA kernel is held against the plain version on the card by
chip_smoke.py and by the ``cuda``-marked test below.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu import flash_attention as pallas_fa

from tpu_ac.kernels import attention as jattn
from tpu_ac.models.vit import _attention_xla
from tpu_ac_torch.kernels import attention as tattn

SCALE = 0.125


@pytest.fixture
def jax_flash(monkeypatch):
    """tpu_ac's flash_attention_impl with the TPU kernel replaced by
    mha_reference."""

    def reference(q, k, v, ab=None, segment_ids=None, *, causal=False,
                  sm_scale=1.0, block_sizes=None, debug=False):
        return pallas_fa.mha_reference(q, k, v, None, segment_ids,
                                       sm_scale=sm_scale)

    monkeypatch.setattr(pallas_fa, "flash_attention", reference)
    return jattn.flash_attention_impl


def _qkv(s, dh, b=2, h=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, dh)).astype(np.float32)
            for _ in range(3)]


def _key_mask(s, n_valid):
    """tpu_ac's seq_pad bias: 0 on the real tokens, -1e9 on the padding."""
    return np.where(np.arange(s) < n_valid, 0.0, -1e9).astype(
        np.float32)[None, None, None, :]


CASES = [(17, None), (26, None), (200, None), (200, 128)]


@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s,n_valid", CASES)
def test_matches_tpu_ac_wrapper(jax_flash, s, n_valid, dh):
    q, k, v = _qkv(s, dh)
    bias = None if n_valid is None else _key_mask(s, n_valid)
    want = np.asarray(jax_flash(
        *(jnp.asarray(x) for x in (q, k, v)), SCALE,
        None if bias is None else jnp.asarray(bias)))
    got = tattn.flash_attention_impl(
        *(torch.from_numpy(x) for x in (q, k, v)), SCALE,
        None if bias is None else torch.from_numpy(bias))
    assert got.shape == want.shape == (2, 3, s, dh)
    assert got.dtype == torch.float32
    # every row, the padded ones too (they attend to the padded keys only)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,n_valid", CASES)
def test_matches_dense_attention_on_valid_rows(s, n_valid):
    """Against tpu_ac's dense _attention_xla at HIGHEST: equal on the real
    rows (on the padded rows the two differ by design: the dense path lets
    them see the real keys)."""
    q, k, v = _qkv(s, 64, seed=1)
    bias = None if n_valid is None else _key_mask(s, n_valid)
    want, _ = _attention_xla(*(jnp.asarray(x) for x in (q, k, v)), SCALE,
                             jax.lax.Precision.HIGHEST,
                             None if bias is None else jnp.asarray(bias))
    got = tattn.flash_attention_impl(
        *(torch.from_numpy(x) for x in (q, k, v)), SCALE,
        None if bias is None else torch.from_numpy(bias))
    rows = s if n_valid is None else n_valid
    np.testing.assert_allclose(got.numpy()[:, :, :rows],
                               np.asarray(want)[:, :, :rows], rtol=1e-5,
                               atol=1e-5)


def test_padded_rows_see_only_padded_keys():
    """The stock kernel's segment semantics, pinned directly: a padded query
    row is the softmax average of the padded keys' values alone."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(40, 16, b=1, h=1, seed=2))
    ids = torch.tensor([0] * 30 + [1] * 10, dtype=torch.int32)
    out = tattn.flash_attention_plain(q, k, v, SCALE, ids)
    pad = torch.softmax(q[..., 30:, :] @ k[..., 30:, :].transpose(-1, -2)
                        * SCALE, -1) @ v[..., 30:, :]
    np.testing.assert_allclose(out[..., 30:, :].numpy(), pad.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_bias_to_segment_ids():
    ids = tattn.bias_to_segment_ids(torch.from_numpy(_key_mask(200, 128)),
                                    200)
    assert ids.dtype == torch.int32 and ids.shape == (200,)
    assert (ids[:128] == 0).all() and (ids[128:] == 1).all()
    assert tattn.bias_to_segment_ids(None, 200) is None


def test_unsupported_biases_raise():
    """Per-batch and wrong-length masks are not segment ids (tpu_ac's
    attention.py:60-66)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(128, 64))
    with pytest.raises(NotImplementedError):
        tattn.flash_attention_impl(q, k, v, SCALE, torch.zeros(2, 1, 1, 128))
    with pytest.raises(NotImplementedError):
        tattn.flash_attention_impl(q, k, v, SCALE, torch.zeros(1, 1, 1, 64))


def test_bf16_on_cpu_returns_bf16():
    """bf16 in, bf16 out: the plain version computes in f32 and casts back
    (one bf16 rounding: 2^-8 relative to the values, so 1e-2 x max|v|)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(26, 64, seed=3))
    f32 = tattn.flash_attention_impl(q, k, v, SCALE)
    bf = tattn.flash_attention_impl(*(t.to(torch.bfloat16) for t in
                                      (q, k, v)), SCALE)
    assert bf.dtype == torch.bfloat16
    assert float((bf.float() - f32).abs().max()) <= 1e-2 * float(
        v.abs().max())


def test_input_checks():
    q, k, v = (torch.from_numpy(x) for x in _qkv(17, 64))
    with pytest.raises(TypeError):
        tattn.flash_attention_impl(q, k, v.to(torch.bfloat16), SCALE)
    with pytest.raises(TypeError):
        tattn.flash_attention_impl(*(t.double() for t in (q, k, v)), SCALE)
    with pytest.raises(ValueError):
        tattn.flash_attention_impl(q, k[:, :, :16], v, SCALE)
    with pytest.raises(ValueError):
        tattn.flash_attention_impl(q[0], k[0], v[0], SCALE)


def test_layout_check_takes_packed_qkv_views():
    """The CUDA path reads the strided q/k/v views of a packed qkv
    projection as they are, and refuses (never copies) what its 16-byte
    row loads cannot address."""
    b, n, nh, hd = 2, 785, 12, 64
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.empty(b, n, 3 * nh * hd, dtype=dtype).reshape(
            b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        for t, name in zip(qkv, "qkv"):
            tattn._check_layout(name, t)
        with pytest.raises(ValueError, match="contiguous last dim"):
            tattn._check_layout("q", qkv[0].transpose(2, 3))
        odd = torch.empty(b, nh, n, hd + 1, dtype=dtype)[..., 1:]
        with pytest.raises(ValueError, match="aligned"):
            tattn._check_layout("q", odd)


def test_cpu_call_launches_nothing():
    before = tattn.LAUNCHES
    q, k, v = (torch.from_numpy(x) for x in _qkv(26, 64))
    tattn.flash_attention_impl(q, k, v, SCALE,
                               torch.from_numpy(_key_mask(26, 20)))
    assert tattn.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,n_valid", [
    (torch.bfloat16, 785, None), (torch.float32, 785, None),
    (torch.bfloat16, 130, None), (torch.bfloat16, 256, 200),
    (torch.float32, 256, 200),
    # the 128-row Q tiles' and 64-key cp.async tiles' edges
    (torch.bfloat16, 1, None), (torch.bfloat16, 17, None),
    (torch.bfloat16, 127, None), (torch.bfloat16, 128, None),
    (torch.bfloat16, 129, None), (torch.float32, 1, None),
    (torch.float32, 17, None), (torch.float32, 127, None),
    (torch.float32, 128, None), (torch.float32, 129, None),
    (torch.float32, 130, None)])
def test_kernel_matches_plain_on_card(dtype, s, n_valid):
    """The CUDA kernel vs the plain version on the card, on the strided
    views of a packed qkv, element by element within flash_tolerance (bf16:
    the kernel's rounding of P and of both outputs; f32, 3xTF32: 1e-5 of
    the attention of |V|); a CUDA call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((2, s, 3, 4, 64)).astype(
        np.float32)).to("cuda", dtype).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    bias = None if n_valid is None else torch.from_numpy(
        _key_mask(s, n_valid)).cuda()
    before = tattn.LAUNCHES
    got = tattn.flash_attention_impl(q, k, v, SCALE, bias)
    assert tattn.LAUNCHES == before + 1
    ids = tattn.bias_to_segment_ids(bias, s)
    want = tattn.flash_attention_plain(q, k, v, SCALE, ids)
    tol = tattn.flash_tolerance(q, k, v, SCALE, ids, want)
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= tol).all()), float((gap / tol).max())


def _emulated_kernel(q, k, v, scale, ids=None, fault=None):
    """The bf16 kernel's arithmetic in plain PyTorch: f32 logits, P rounded
    to bf16 before P.V, l summing the unrounded P, the output rounded to
    bf16 once.  ``fault`` breaks it as a wrong kernel would be broken:
    "tail" drops the keys of the ragged last 64-key tile, "segments"
    ignores the segment ids, "rescale" skips the rescale of the first
    tile's contribution when the row max grows."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    s_ = q.shape[2]
    logits = qf @ kf.transpose(-2, -1) * scale
    seen = torch.ones(s_, s_, dtype=torch.bool)
    if ids is not None and fault != "segments":
        seen &= ids[:, None] == ids[None, :]
    if fault == "tail":
        seen[:, s_ - s_ % 64:] = False
    logits = logits.masked_fill(~seen, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    if fault == "rescale":  # the first tile stays scaled to its own max
        m0 = logits[..., :64].amax(-1, keepdim=True)
        p[..., :64] = torch.exp(logits[..., :64] - m0)
    pv = p.to(torch.bfloat16).float() @ vf
    return (pv / p.sum(-1, keepdim=True)).to(torch.bfloat16)


def _bf16_case(s, n_valid, seed=5):
    """bf16 q, k, v [1, 2, S, 64] and the segment ids of a key mask."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(s, 64, b=1, h=2, seed=seed))
    ids = None if n_valid is None else tattn.bias_to_segment_ids(
        torch.from_numpy(_key_mask(s, n_valid)), s)
    return q, k, v, ids


@pytest.mark.parametrize("s,n_valid", [(785, None), (17, None),
                                       (130, None), (256, 200)])
def test_tolerance_holds_the_kernels_rounding(s, n_valid):
    """flash_tolerance admits the bf16 kernel's own arithmetic, emulated,
    at the main path's S and the ragged and masked shapes, and it lies well
    below the outputs' size: at S = 785 its median is under a tenth of
    the mean |out|."""
    q, k, v, ids = _bf16_case(s, n_valid)
    want = tattn.flash_attention_plain(q, k, v, SCALE, ids)
    tol = tattn.flash_tolerance(q, k, v, SCALE, ids, want)
    gap = (_emulated_kernel(q, k, v, SCALE, ids).float()
           - want.float()).abs()
    assert bool((gap <= tol).all()), float((gap / tol).max())
    if s == 785:
        assert float(tol.median()) < 0.1 * float(want.float().abs().mean())


@pytest.mark.parametrize("fault,s,n_valid", [
    ("tail", 785, None), ("segments", 256, 200), ("rescale", 785, None)])
def test_tolerance_catches_a_wrong_kernel(fault, s, n_valid):
    """A kernel broken in one of the ways the design guards against falls
    outside flash_tolerance; dropping the 17 keys of S = 785's ragged tile
    is caught at the main path's S."""
    q, k, v, ids = _bf16_case(s, n_valid)
    want = tattn.flash_attention_plain(q, k, v, SCALE, ids)
    tol = tattn.flash_tolerance(q, k, v, SCALE, ids, want)
    gap = (_emulated_kernel(q, k, v, SCALE, ids, fault).float()
           - want.float()).abs()
    assert float((gap / tol).max()) > 1.0
