"""The f32 flash kernel's arithmetic (3xTF32 on the tensor cores) and the
head-dim padding of tpu_ac_torch.kernels.attention.

The CUDA kernel cannot run on the CPU, so ``_emulate`` repeats its
arithmetic in PyTorch: the online softmax over 64-key tiles in the log2
domain, and each product as 3xTF32 in 8-deep steps (d += a_lo.b_hi, d +=
a_hi.b_lo, d += a_hi.b_hi, with hi = x truncated to tf32 and lo = x - hi,
truncated to tf32 as the tensor cores read it).  That arithmetic stays
within the unchanged ``flash_tolerance`` of the plain version, while
single-pass TF32 does not, so the tolerance that the card's check applies
catches a kernel that loses the lo terms.  The kernel itself is held against the plain
version by the ``cuda``-marked tests (skipped without a card) and by
chip_smoke.py.

Head dims under 64 are zero-padded to 64 (``pad_head_dim``), as tpu_ac
pads them to 128 lanes; over 64 they go to the wide kernels, one launch a
call up to 256 columns (``flash_by_slices``, run here with each launch's
plain function).  The plain attention of the padded inputs, sliced back,
equals tpu_ac's wrapper with JAX's Pallas TPU kernel monkeypatched to its
own ``mha_reference`` (as tests/test_torch_attention.py does).  Tolerance:
rtol/atol 1e-5 (f32 on both sides, differently ordered sums).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu import flash_attention as pallas_fa

from tpu_ac.kernels import attention as jattn
from tpu_ac_torch.kernels import attention as tattn

SCALE = 0.125  # 64 ** -0.5
LOG2E = 1.4426950408889634


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> tf32 by truncation: the low 13 bits cleared, as the kernel
    cuts hi and as the tensor cores read any f32 operand."""
    bits = x.contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor, rn: bool = False
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split_tf32: hi = tf32(x), lo = x - hi (exact), which
    enters the product as tf32(lo); ``rn``: split_tf32_rn, hi rounded to
    nearest (ties away) instead of truncated."""
    if rn:
        bits = x.contiguous().view(torch.int32)
        hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    else:
        hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mma(d: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         passes: int, rn: bool = False) -> torch.Tensor:
    """d + a @ b as the kernel's m16n8k8 steps: 8-deep slices of the
    contraction, each 3xTF32 (passes=3; ``rn``: split_tf32_rn) or
    single-pass TF32 (passes=1)."""
    for k0 in range(0, a.shape[-1], 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        if passes == 1:
            d = d + _tf32(ak) @ _tf32(bk)
            continue
        (ah, al), (bh, bl) = _split(ak, rn), _split(bk, rn)
        d = d + al @ bh
        d = d + ah @ bl
        d = d + ah @ bh
    return d


def _emulate(q, k, v, scale: float, passes: int = 3, tile: int = 64,
             qk_rn: bool = False) -> torch.Tensor:
    """The f32 kernel's arithmetic on f32 q, k, v [B, H, S, Dh], no mask:
    key tiles of ``tile``; ``qk_rn``: q and k split by split_tf32_rn (the
    wide kernel: tiles of 64 up to 128 columns, 32 above)."""
    c = np.float32(scale * LOG2E).item()
    s_len = q.shape[2]
    m = torch.full(q.shape[:3], -math.inf)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    for k0 in range(0, s_len, tile):
        kt, vt = k[..., k0:k0 + tile, :], v[..., k0:k0 + tile, :]
        s = _mma(torch.zeros(*q.shape[:3], kt.shape[2]), q,
                 kt.transpose(-1, -2), passes, qk_rn)
        mn = torch.maximum(m, s.amax(-1) * c)
        corr = torch.exp2(m - mn)
        # the FMA s * c - m rounds once
        p = torch.exp2((s.double() * c - mn.double()[..., None]).float())
        l = l * corr + p.sum(-1)
        acc = _mma(acc * corr[..., None], p, vt, passes)
        m = mn
    return acc / l[..., None]


def _normal(shape, seed: int, mult: float = 1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             * (mult if i < 2 else 1.0))
            for i in range(3)]


SHAPE = (1, 4, 785, 64)


def _share_of_tol(got, q, k, v, want=None) -> float:
    """max |got - want| over flash_tolerance (want: the plain version)."""
    if want is None:
        want = tattn.flash_attention_plain(q, k, v, SCALE)
    tol = tattn.flash_tolerance(q, k, v, SCALE, None, want)
    return float(((got - want).abs() / tol).max())


def test_3xtf32_within_flash_tolerance():
    """At the main path's S (ragged last tile of 17 keys), unit-normal
    inputs: the kernel's arithmetic stays well within the f32 limit."""
    q, k, v = _normal(SHAPE, seed=0)
    share = _share_of_tol(_emulate(q, k, v, SCALE), q, k, v)
    assert share < 0.5, share


def test_single_pass_tf32_is_caught():
    """Single-pass TF32 (the lo terms dropped) lies far outside the same
    unchanged tolerance."""
    q, k, v = _normal(SHAPE, seed=0)
    share = _share_of_tol(_emulate(q, k, v, SCALE, passes=1), q, k, v)
    assert share > 5.0, share


@pytest.mark.parametrize("seed", [1, 2])
def test_3xtf32_as_close_to_f64_as_f32(seed):
    """q and k scaled by 3 (logit std about 9): 3xTF32's gap to an f64
    reference stays within 2x that of the plain f32 attention."""
    q, k, v = _normal(SHAPE, seed=seed, mult=3.0)
    qd, kd, vd = (t.double() for t in (q, k, v))
    ref = (torch.softmax(qd @ kd.transpose(-1, -2) * SCALE, -1) @ vd).float()
    plain = tattn.flash_attention_plain(q, k, v, SCALE)
    kernel = _emulate(q, k, v, SCALE)
    own = _share_of_tol(plain, q, k, v, want=ref)
    assert _share_of_tol(kernel, q, k, v, want=ref) <= 2.0 * own


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


def _key_mask(s: int, n_valid: int) -> np.ndarray:
    return np.where(np.arange(s) < n_valid, 0.0, -1e9).astype(
        np.float32)[None, None, None, :]


@pytest.mark.parametrize("n_valid", [None, 128])
@pytest.mark.parametrize("dh", [16, 32, 48])
def test_padded_head_dim_matches_tpu_ac(jax_flash, dh, n_valid):
    """The plain attention of the zero-padded inputs, sliced back to Dh,
    against tpu_ac's wrapper (which pads Dh to 128 itself)."""
    s = 200
    q, k, v = (t.numpy() for t in _normal((2, 3, s, dh), seed=dh))
    bias = None if n_valid is None else _key_mask(s, n_valid)
    want = np.asarray(jax_flash(
        *(jnp.asarray(x) for x in (q, k, v)), SCALE,
        None if bias is None else jnp.asarray(bias)))
    ids = None if bias is None else tattn.bias_to_segment_ids(
        torch.from_numpy(bias), s)
    padded = [tattn.pad_head_dim(torch.from_numpy(x)) for x in (q, k, v)]
    assert padded[0].shape == (2, 3, s, tattn.HEAD_DIM)
    assert bool((padded[0][..., dh:] == 0).all())
    got = tattn.flash_attention_plain(*padded, SCALE, ids)[..., :dh]
    assert got.shape == want.shape == (2, 3, s, dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _slice_plain(q, k, v, out, scale, ids):
    """One kernel launch's function in plain PyTorch: the attention of the
    padded q, k (every column) on the slice v, written into the slice
    out."""
    logits = q @ k.transpose(-2, -1) * scale
    if ids is not None:
        logits = logits.masked_fill(ids[:, None] != ids[None, :],
                                    float("-inf"))
    out.copy_(torch.softmax(logits, dim=-1) @ v)


@pytest.mark.parametrize("n_valid", [None, 128])
@pytest.mark.parametrize("dh", [80, 128, 200])
def test_wide_head_dim_matches_tpu_ac(jax_flash, dh, n_valid):
    """Head dims over 64: the wrapper's plan (flash_by_slices: Dh padded
    to a multiple of 8, one launch up to 256 columns) with each launch's
    plain function, against tpu_ac's wrapper (which pads Dh to 128 lanes
    itself)."""
    s = 200
    q, k, v = (t.numpy() for t in _normal((2, 3, s, dh), seed=dh))
    bias = None if n_valid is None else _key_mask(s, n_valid)
    want = np.asarray(jax_flash(
        *(jnp.asarray(x) for x in (q, k, v)), SCALE,
        None if bias is None else jnp.asarray(bias)))
    ids = None if bias is None else tattn.bias_to_segment_ids(
        torch.from_numpy(bias), s)
    got = tattn.flash_by_slices(
        *(torch.from_numpy(x) for x in (q, k, v)),
        lambda *qkvo: _slice_plain(*qkvo, SCALE, ids))
    assert got.shape == want.shape == (2, 3, s, dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dh,n_launch", [(16, 1), (64, 1), (80, 1),
                                          (128, 1), (200, 1)])
def test_slice_plan(dh, n_launch):
    """What each launch is given: q and k with every column (zero-padded to
    64 under 64, as they are over 64: multiples of 8); V and the output
    whole (up to 256 columns), the output a view into the [B, S, H, Dh']
    buffer the wrapper allocated; a head dim the kernels take as it is is
    not copied."""
    q, k, v = _normal((2, 3, 17, dh), seed=5)
    calls = []

    def launch(qp, kp, vj, oj):
        calls.append((qp, kp, vj, oj))
        oj.copy_(vj * 2)

    out = tattn.flash_by_slices(q, k, v, launch)
    width = max(dh, 64)
    assert len(calls) == n_launch
    assert out.shape == (2, 3, 17, dh)
    assert torch.equal(out, v * 2)
    for qp, kp, vj, oj in calls:
        assert qp.shape == kp.shape == (2, 3, 17, width)
        assert torch.equal(qp[..., :dh], q) and not bool(qp[..., dh:].any())
        assert vj.shape == oj.shape == (2, 3, 17, width)
        assert oj.stride() == (17 * 3 * width, width, 3 * width, 1)
    if dh == width:
        assert calls[0][0] is q and calls[0][1] is k


def test_3xtf32_within_flash_tolerance_wide_head():
    """Dh = 80: the wide kernel sums QK^T and P.V in 8-deep steps over the
    80 columns themselves (no pad), q and k split with hi rounded to
    nearest, and runs the online softmax over key tiles of 64 (as at Dh =
    64; 32 over 128 columns), so its arithmetic is ``_emulate`` of the
    inputs with qk_rn; within the f32 limit as at 64 (S = 200: three full
    key tiles and a ragged one of 8)."""
    q, k, v = _normal((1, 2, 200, 80), seed=6)
    got = _emulate(q, k, v, SCALE, qk_rn=True)
    share = _share_of_tol(got, q, k, v)
    assert share < 0.5, share


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")


def _on_card(dtype, s: int, dh: int, n_valid=None, seed: int = 4):
    """The kernel on the strided q/k/v views of a packed qkv against the
    plain version, within flash_tolerance; one launch a call."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((2, s, 3, 4, dh)).astype(
        np.float32)).to("cuda", dtype).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    bias = None if n_valid is None else torch.from_numpy(
        _key_mask(s, n_valid)).cuda()
    before = tattn.LAUNCHES
    got = tattn.flash_attention_impl(q, k, v, SCALE, bias)
    assert tattn.LAUNCHES == before + 1
    assert got.shape == (2, 4, s, dh) and got.dtype == dtype
    ids = tattn.bias_to_segment_ids(bias, s)
    want = tattn.flash_attention_plain(q, k, v, SCALE, ids)
    tol = tattn.flash_tolerance(q, k, v, SCALE, ids, want)
    gap = (got.float() - want.float()).abs()
    assert bool((gap <= tol).all()), float((gap / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("s,n_valid", [
    (1, None), (17, None), (127, None), (128, None), (129, None),
    (130, None), (785, None), (256, 200)])
def test_f32_kernel_matches_plain_on_card(s, n_valid):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    _on_card(torch.float32, s, 64, n_valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 48])
def test_padded_head_dim_on_card(dtype, dh):
    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    _on_card(dtype, 130, dh, n_valid=100)
