"""The flash-attention path of tpu_ac_torch vs tpu_ac's on the CPU: the ViT
forward with ``attention_impl="flash"`` and the flash ``CategoryEmbedder``
built by ``build_embedder_for_config``.

tpu_ac's flash path pads the 26 tokens of a 40 px image at patch 8 to 128
(``seq_pad=True``) and masks the padding with segment ids; the port runs
the 26 tokens as they are.  JAX's Pallas TPU flash kernel has no CPU mode,
so it is monkeypatched to its module's own pure-jnp ``mha_reference``, as
tests/test_seq_pad_packed.py does.  Tolerance: rtol 1e-4, atol 1e-5, f32
on both sides (HIGHEST on the JAX side), three blocks of differently
ordered sums, as tests/test_torch_vit.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu import flash_attention as pallas_fa

from tpu_ac import pipeline as jpipe
from tpu_ac.kernels.attention import flash_attention_impl as jax_flash
from tpu_ac.models import registry as jreg
from tpu_ac.models import vit as jvit
from tpu_ac_torch import pipeline as tpipe
from tpu_ac_torch.kernels import attention as tattn
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import vit as tvit
from tpu_ac_torch.models.convert import load_jax_params

CFG = dict(patch_size=8, embed_dim=64, depth=3, num_heads=4, img_size=40)
NAME = "tiny_flash_test"


@pytest.fixture
def reference_kernel(monkeypatch):
    def reference(q, k, v, ab=None, segment_ids=None, *, causal=False,
                  sm_scale=1.0, block_sizes=None, debug=False):
        return pallas_fa.mha_reference(q, k, v, None, segment_ids,
                                       sm_scale=sm_scale)

    monkeypatch.setattr(pallas_fa, "flash_attention", reference)


@pytest.mark.parametrize("taps", [(1, 2), (2,)])
def test_flash_vit_forward_matches(reference_kernel, taps):
    params = tvit.init_vit_params(0, tvit.ViTConfig(**CFG))
    model = load_jax_params(tvit.ViT(tvit.ViTConfig(**CFG)), params).eval()
    x = np.random.default_rng(1).standard_normal((2, 3, 40, 40)).astype(
        np.float32)
    want = jvit.vit_forward({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), jvit.ViTConfig(**CFG), taps=taps,
                            precision=jax.lax.Precision.HIGHEST,
                            attention_impl=jax_flash, seq_pad=True)
    before = tattn.LAUNCHES
    with torch.inference_mode():
        got = model(torch.from_numpy(x), taps=taps, attention_impl="flash")
    assert tattn.LAUNCHES == before  # the CPU runs the plain version
    for t in taps:
        assert got[t].shape == want[t].shape == (2, 26, 64)
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]),
                                   rtol=1e-4, atol=1e-5)


def test_flash_category_embedder_matches(reference_kernel):
    jreg.register_backbone(NAME, jreg.BackboneSpec(
        "vit", jvit.ViTConfig(**CFG), None))
    treg.register_backbone(NAME, treg.BackboneSpec(
        "vit", tvit.ViTConfig(**CFG), None))
    jcfg = jpipe.PipelineConfig(
        backbone_name=NAME, layers=("blocks.1", "blocks.2"),
        pretrain_embed_dimension=96, target_embed_dimension=192,
        batch_size=2, precision="highest")
    tcfg = tpipe.PipelineConfig(**dataclasses.asdict(jcfg))
    images = np.random.default_rng(2).integers(
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
    got = temb(images)
    assert got.shape == want.shape == (3, 25, 192)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # and the port's flash embedder equals its dense one
    dense = tpipe.build_embedder_for_config(tcfg, device="cpu")(images)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-4,
                               atol=1e-5)
