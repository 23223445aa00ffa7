"""The flash path at head dims over 64 on the CPU: the wrapper's plan for
the wide kernels, a narrow ViT of Dh 80 through the flash embedder and
compute_alpha_X against tpu_ac's, and the f32 wide kernel's order of sums.

The CUDA kernels cannot run here, so (a) runs the wrapper's plan
(``flash_by_slices``) with a stand-in launch that computes, in plain
PyTorch, the attention of the q, k and V slice it is handed; (c) repeats
the f32 wide kernel's arithmetic (3xTF32 in 8-deep steps over the call's
own head dim, q and k split with hi rounded to nearest, the online
softmax over key tiles of 64 or 32) and holds it to the unchanged
``flash_tolerance``; (d) checks that a library's build key covers the
shared header the sources include.  The kernels themselves are held to the
plain version
by the ``cuda``-marked tests of tests/test_torch_flash_card.py and by
chip_smoke.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu import flash_attention as pallas_fa

from tpu_ac import pipeline as jpipe
from tpu_ac.models import registry as jreg
from tpu_ac.models import vit as jvit
from tpu_ac_torch import pipeline as tpipe
from tpu_ac_torch.kernels import attention as tattn
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import vit as tvit

from test_torch_flash_f32 import _emulate, _normal

# a ViT of head dim 80 (ViT-H/14's), cut to 2 heads, 2 blocks, 40 px
CFG = dict(patch_size=8, embed_dim=160, depth=2, num_heads=2, img_size=40)
NAME = "tiny_flash_wide_test"


@pytest.fixture
def reference_kernel(monkeypatch):
    """tpu_ac's flash path with JAX's Pallas TPU kernel replaced by its
    own mha_reference (no CPU mode), as tests/test_torch_vit_flash.py."""

    def reference(q, k, v, ab=None, segment_ids=None, *, causal=False,
                  sm_scale=1.0, block_sizes=None, debug=False):
        return pallas_fa.mha_reference(q, k, v, None, segment_ids,
                                       sm_scale=sm_scale)

    monkeypatch.setattr(pallas_fa, "flash_attention", reference)


def _plain_launch(calls, scale, ids):
    """A stand-in for one kernel launch: the plain attention of q, k (every
    column) on the slice v, written into the slice out."""

    def launch(q, k, v, out):
        calls.append((q, k, v, out))
        logits = q @ k.transpose(-2, -1) * scale
        if ids is not None:
            logits = logits.masked_fill(ids[:, None] != ids[None, :],
                                        float("-inf"))
        out.copy_(torch.softmax(logits, dim=-1) @ v)

    return launch


@pytest.mark.parametrize("dh,width,n_launch", [
    (16, 64, 1), (64, 64, 1), (80, 80, 1), (104, 104, 1), (128, 128, 1),
    (200, 200, 1), (256, 256, 1), (320, 320, 2)])
def test_wide_plan(dh, width, n_launch):
    """Dh <= 64 pads to 64; over 64 no pad (multiples of 8 stay as they
    are) and one launch with q, k, v and the output whole up to 256
    columns, one per 256-column slice of V and the output above; the
    output is [B, H, S, Dh], laid out [B, S, H, Dh'] in memory, and equals
    the plain attention (segment ids over the last 5 keys)."""
    b, h, s = 2, 3, 21
    q, k, v = _normal((b, h, s, dh), seed=dh)
    ids = (torch.arange(s) >= 16).to(torch.int32)
    scale = dh ** -0.5
    calls = []
    out = tattn.flash_by_slices(q, k, v, _plain_launch(calls, scale, ids))
    assert tattn.padded_head_dim(dh) == width
    assert len(calls) == n_launch
    assert out.shape == (b, h, s, dh)
    for j, (qp, kp, vj, oj) in enumerate(calls):
        assert qp.shape == kp.shape == (b, h, s, width)
        lo = j * tattn.WIDE_SLICE
        cols = min(width - lo, tattn.WIDE_SLICE)
        assert vj.shape == oj.shape == (b, h, s, cols)
        assert oj.stride() == (s * h * width, width, h * width, 1)
        assert oj.data_ptr() == calls[0][3].data_ptr() + lo * 4
        assert torch.equal(vj, tattn.pad_head_dim(v)[..., lo:lo + cols])
    if width == dh:  # no copy of the inputs
        assert calls[0][0] is q and calls[0][1] is k
    want = tattn.flash_attention_plain(q, k, v, scale, ids)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_dh80_flash_embed_and_alpha_match_tpu_ac(reference_kernel):
    """A Dh = 80 ViT (2 heads x 80) through the flash CategoryEmbedder and
    compute_alpha_X, the same numpy weights in both packages (the
    registry's seeded init; models/convert.py loads them), 3 images of 40
    px.  tpu_ac pads the 26 tokens to 128 and Dh to 128 lanes; the port
    runs 26 tokens at Dh 80.  Z: rtol 1e-4, atol 1e-5 (f32 both sides,
    HIGHEST on the JAX side, two blocks of differently ordered sums, as
    tests/test_torch_vit_flash.py); alpha: rtol 1e-3, atol 5e-4, the
    contract of tests/test_torch_alpha.py, with rows summing to 1."""
    jreg.register_backbone(NAME, jreg.BackboneSpec(
        "vit", jvit.ViTConfig(**CFG), None))
    treg.register_backbone(NAME, treg.BackboneSpec(
        "vit", tvit.ViTConfig(**CFG), None))
    jcfg = jpipe.PipelineConfig(
        backbone_name=NAME, layers=("blocks.0", "blocks.1"),
        pretrain_embed_dimension=96, target_embed_dimension=192,
        batch_size=2, precision="highest")
    tcfg = tpipe.PipelineConfig(**dataclasses.asdict(jcfg))
    images = np.random.default_rng(3).integers(
        0, 256, (3, 3, 40, 40), dtype=np.uint8)
    # mesh=None: conftest's 8 virtual devices would take the dp branch
    jemb = jpipe.build_embedder_for_config(jcfg, attention_impl="flash",
                                           mesh=None)
    try:
        want = np.asarray(jemb(images))
    finally:
        jemb.close()
    temb = tpipe.build_embedder_for_config(tcfg, device="cpu",
                                           attention_impl="flash")
    cfg = temb._model.blocks[0].attn.cfg
    assert cfg.embed_dim // cfg.num_heads == 80
    got = temb(images)
    assert got.shape == want.shape == (3, 25, 192)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)

    ja, jx = (np.asarray(t) for t in jpipe.compute_alpha_X(
        jnp.asarray(want), "unsupervised", 1.0, use_mesh=False))
    ta, tx = (t.numpy() for t in tpipe.compute_alpha_X(
        got, "unsupervised", 1.0))
    assert ta.shape == ja.shape == (3, 25) and tx.shape == jx.shape
    assert np.isfinite(ta).all() and np.isfinite(tx).all()
    np.testing.assert_allclose(ta.sum(1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(tx, jx, rtol=1e-3, atol=5e-4)


@pytest.mark.parametrize("dh", [80, 104, 200, 320])
def test_3xtf32_wide_order_within_flash_tolerance(dh):
    """The f32 wide kernel's sums: QK^T and P.V in 8-deep 3xTF32 steps over
    the call's own head dim (no pad to 64), q and k split with hi rounded
    to nearest, the online softmax over key tiles of 64 up to 128 columns
    and of 32 above; within half the f32 limit at S = 200 (a ragged last
    tile of 8), as at Dh = 64."""
    q, k, v = _normal((1, 2, 200, dh), seed=dh + 1)
    scale = dh ** -0.5
    got = _emulate(q, k, v, scale, tile=64 if dh <= 128 else 32,
                   qk_rn=True)
    want = tattn.flash_attention_plain(q, k, v, scale)
    tol = tattn.flash_tolerance(q, k, v, scale, None, want)
    share = float(((got - want).abs() / tol).max())
    assert share < 0.5, share


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """A change of csrc/*.cuh alone changes every library's path, so a
    stale build of a source that includes it is never loaded."""
    from tpu_ac_torch.kernels import build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    before = build._library_path(str(tmp_path / "k.cu"))
    assert before == build._library_path(str(tmp_path / "k.cu"))
    (tmp_path / "common.cuh").write_text("// two\n")
    assert build._library_path(str(tmp_path / "k.cu")) != before
    assert os.path.basename(before).startswith("libk-")
