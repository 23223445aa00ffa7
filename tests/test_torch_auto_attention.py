"""How ``CategoryEmbedder`` resolves ``attention_impl``, on the CPU: "auto"
takes the flash kernel for a bfloat16 ViT embed on a card, and the dense
attention on the CPU, in f32, for other families, where the probabilities
are asked for and while the embed is traced for export; "dense" and
"flash" are taken as given; ``ATTENTION_FUSED_BATCHES`` counts the batches
during which the kernel launched.  The card is stood in for by the CPU
(``pipeline.FLASH_DEVICE_TYPE`` patched to "cpu"), where the flash path
runs the kernel's plain version; a spy on
``models.vit.flash_attention_impl`` records the flash calls and, on the
stand-in card, counts each as the kernel's launch
(``kernels.attention.LAUNCHES``)."""

import numpy as np
import pytest
import torch

from tpu_ac_torch import pipeline
from tpu_ac_torch.distributed import Mesh
from tpu_ac_torch.kernels import attention as tattn
from tpu_ac_torch.models import vit as tvit
from tpu_ac_torch.models.convert import load_jax_params
from tpu_ac_torch.models.resnet import (
    ResNet,
    ResNetConfig,
    init_resnet_params,
)
from tpu_ac_torch.utils import export as texport

VIT = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, img_size=32)
EMBED = dict(layers=("blocks.0", "blocks.1"), pretrain_embed_dimension=48,
             target_embed_dimension=96, imagesize=32, batch_size=4)
N_IMAGES = 6  # two batches of 4, the second padded
BATCHES = 2


@pytest.fixture(scope="module")
def model():
    cfg = tvit.ViTConfig(**VIT)
    return load_jax_params(tvit.ViT(cfg),
                           tvit.init_vit_params(0, cfg)).eval()


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).integers(
        0, 256, (N_IMAGES, 3, 32, 32), dtype=np.uint8)


@pytest.fixture
def spy(monkeypatch):
    """The flash calls the ViT makes: one entry a call, whether the call
    was traced (``torch.compiler.is_compiling``); a call on the stand-in
    card counts one launch, as the kernel's ``_launch`` does."""
    calls = []
    real = tvit.flash_attention_impl

    def flash(q, *args, **kw):
        calls.append(torch.compiler.is_compiling())
        if q.device.type == pipeline.FLASH_DEVICE_TYPE:
            monkeypatch.setattr(tattn, "LAUNCHES", tattn.LAUNCHES + 1)
        return real(q, *args, **kw)

    monkeypatch.setattr(tvit, "flash_attention_impl", flash)
    return calls


def _as_card(monkeypatch):
    """The CPU taken for the card."""
    monkeypatch.setattr(pipeline, "FLASH_DEVICE_TYPE", "cpu")


@pytest.fixture
def card(monkeypatch):
    _as_card(monkeypatch)


def _embedder(model, precision="bfloat16", impl="auto", mesh=None):
    cfg = pipeline.PipelineConfig(precision=precision, **EMBED)
    return pipeline.CategoryEmbedder(model, cfg, device="cpu",
                                     attention_impl=impl, mesh=mesh)


def _embed(emb, images):
    """(Z, batches counted by ATTENTION_FUSED_BATCHES) of one call."""
    before = pipeline.ATTENTION_FUSED_BATCHES
    z = emb(images)
    return z, pipeline.ATTENTION_FUSED_BATCHES - before


def test_auto_takes_the_kernel_for_bf16_vit_on_a_card(model, images, spy,
                                                      card):
    """Every block of every batch through the flash path, the batches
    counted once each, and Z bit for bit the explicit "flash" one's."""
    emb = _embedder(model)
    assert emb._attention_on(emb.device) == "flash"
    z, fused = _embed(emb, images)
    assert len(spy) == VIT["depth"] * BATCHES and not any(spy)
    assert fused == BATCHES
    z_flash, _ = _embed(_embedder(model, impl="flash"), images)
    assert z.dtype == torch.float32 and torch.equal(z, z_flash)


@pytest.mark.parametrize("case", ["cpu", "default", "highest"])
def test_auto_stays_dense(model, images, spy, monkeypatch, case):
    """On the CPU (no card), and in f32 on a card: no flash call, nothing
    counted, Z bit for bit the explicit "dense" one's."""
    precision = "bfloat16" if case == "cpu" else case
    if case != "cpu":
        _as_card(monkeypatch)
    emb = _embedder(model, precision)
    assert emb._attention_on(emb.device) is None
    z, fused = _embed(emb, images)
    assert spy == [] and fused == 0
    z_dense, _ = _embed(_embedder(model, precision, "dense"), images)
    assert torch.equal(z, z_dense)


def test_auto_stays_dense_for_another_family(images, spy, card):
    """A ResNet has no attention: "auto" passes the embed nothing and
    counts nothing; "dense" is accepted, "flash" refused."""
    rcfg = ResNetConfig(block_counts=(1, 1, 1, 1), expansion=1,
                        block="basic", num_classes=10)
    resnet = load_jax_params(ResNet(rcfg),
                             init_resnet_params(0, rcfg)).eval()
    cfg = pipeline.PipelineConfig(
        precision="bfloat16", **{**EMBED, "layers": ("layer2", "layer3")})
    emb = pipeline.CategoryEmbedder(resnet, cfg, device="cpu")
    assert emb._attention_on(emb.device) is None
    z, fused = _embed(emb, images)
    assert z.shape[0] == N_IMAGES and bool(torch.isfinite(z).all())
    assert spy == [] and fused == 0
    pipeline.CategoryEmbedder(resnet, cfg, device="cpu",
                              attention_impl="dense")
    with pytest.raises(ValueError, match="needs a ViT"):
        pipeline.CategoryEmbedder(resnet, cfg, device="cpu",
                                  attention_impl="flash")


def test_probabilities_come_from_the_dense_path(model, spy, card):
    """A block asked for its attention probabilities runs the dense
    attention whatever it is passed, as the viz path needs."""
    x = torch.randn(2, 17, VIT["embed_dim"])
    blk = model.blocks[0]
    with torch.no_grad():
        attn, y = blk(x, "flash", return_attention=True)
        want_attn, want_y = blk(x, None, return_attention=True)
        maps = model.all_selfattentions(torch.randn(2, 3, 32, 32))
    assert spy == []
    assert torch.equal(attn, want_attn) and torch.equal(y, want_y)
    torch.testing.assert_close(attn.sum(-1), torch.ones(2, 4, 17))
    assert maps.shape == (VIT["depth"], 2, 4, 17, 17)


def test_auto_exports_the_dense_attention(model, images, spy, card):
    """An "auto" embedder stays exportable: its eager calls take the flash
    path, the traced one the dense attention."""
    emb = _embedder(model)
    cfg = pipeline.PipelineConfig(precision="bfloat16", **EMBED)
    art = texport.export_category_programs(emb, cfg, n_images=N_IMAGES)
    assert spy and not any(spy)  # the eager call before the trace only
    assert set(art["programs"]) == {"cpu"}
    spy.clear()
    params = {k: v for k, v in emb._model.state_dict().items()}
    x = torch.from_numpy(images[:EMBED["batch_size"]])
    ep = torch.export.export(texport.EmbedProgram(emb), (params, x),
                             strict=False)
    assert spy == []
    ops = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert any("softmax" in op for op in ops), sorted(ops)


@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_explicit_values_are_honoured(model, images, spy, monkeypatch,
                                      impl, on_card):
    """"dense" never calls the flash path, "flash" always does (the plain
    version on the CPU); only a card's flash batches are counted."""
    if on_card:
        _as_card(monkeypatch)
    emb = _embedder(model, impl=impl)
    _, fused = _embed(emb, images)
    flash = impl == "flash"
    assert len(spy) == (VIT["depth"] * BATCHES if flash else 0)
    assert fused == (BATCHES if flash and on_card else 0)


@pytest.mark.parametrize("impl", ["pallas", "xla", "", None])
def test_unknown_value_raises(model, impl):
    with pytest.raises(ValueError, match="attention_impl"):
        _embedder(model, impl=impl)


def test_counted_once_a_batch_over_a_mesh(model, images, spy, card):
    """Over a mesh each shard of a batch runs every block through the flash
    path, and the batch is counted once."""
    emb = _embedder(model, mesh=Mesh(["cpu"] * 2))
    z, fused = _embed(emb, images)
    assert len(spy) == VIT["depth"] * BATCHES * 2
    assert fused == BATCHES and z.shape[0] == N_IMAGES
