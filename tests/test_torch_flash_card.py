"""The flash kernel at head dims over 64, on the card, against its plain
version (no tpu_ac import: the card's machine runs these with
``-m cuda``).  Head dims over 64 run the wide kernels: one launch a call
up to 256 columns, one per 256-column slice of V above; the check is
element by element within ``flash_tolerance``, as for Dh = 64.  Then the
kernel under ``CategoryEmbedder``'s ``attention_impl="auto"``: a bfloat16
ViT embed on the card takes it (Dh 64 and the wide kernel), on one card
and over a mesh of distinct cards, and an "auto" embedder still exports
the dense attention."""

import copy

import numpy as np
import pytest
import torch

from tpu_ac_torch import pipeline
from tpu_ac_torch.distributed import Mesh
from tpu_ac_torch.kernels import attention as tattn
from tpu_ac_torch.models.convert import load_jax_params
from tpu_ac_torch.models.vit import ViT, ViTConfig, init_vit_params
from tpu_ac_torch.utils import export as texport


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


# small ViTs at 64 px (65 tokens): heads of 64 (the Dh 64 kernel) and of
# 80 (the wide kernel, as ViT-H/14's)
AUTO_VITS = {"dh64": dict(patch_size=8, embed_dim=256, depth=3,
                          num_heads=4, img_size=64),
             "dh80": dict(patch_size=8, embed_dim=320, depth=3,
                          num_heads=4, img_size=64)}
AUTO_EMBED = dict(layers=("blocks.1", "blocks.2"),
                  pretrain_embed_dimension=128, target_embed_dimension=256,
                  imagesize=64, batch_size=4)
AUTO_IMAGES = 10  # 3 batches of 4, the last padded


def _auto_case(name):
    cfg = ViTConfig(**AUTO_VITS[name])
    model = load_jax_params(ViT(cfg), init_vit_params(0, cfg)).eval()
    images = np.random.default_rng(7).integers(
        0, 256, (AUTO_IMAGES, 3, 64, 64), dtype=np.uint8)
    return model, images


def _auto_embedder(model, impl, precision="bfloat16", mesh=None):
    """An embedder of a copy of ``model`` (an embedder casts and moves its
    model in place)."""
    cfg = pipeline.PipelineConfig(precision=precision, **AUTO_EMBED)
    return pipeline.CategoryEmbedder(copy.deepcopy(model), cfg,
                                     device="cuda", attention_impl=impl,
                                     mesh=mesh)


def _embed_counted(emb, images):
    """(Z, flash launches, batches counted as fused) of one embed."""
    before = (tattn.LAUNCHES, pipeline.ATTENTION_FUSED_BATCHES)
    z = emb(images)
    torch.cuda.synchronize()
    return z, tattn.LAUNCHES - before[0], \
        pipeline.ATTENTION_FUSED_BATCHES - before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(AUTO_VITS))
def test_auto_embedder_takes_the_kernel_on_card(name):
    """A bfloat16 "auto" ViT embedder: depth x batches launches, every
    batch counted, Z bit for bit the explicit "flash" embedder's and
    within the bf16 rounding noise of the "dense" one's (3x the dense bf16
    embed's gap to the f32 one, as ``chip_smoke.py`` holds the flash
    sweep); "dense" and f32 "auto" launch nothing."""
    _card()
    model, images = _auto_case(name)
    depth, batches = AUTO_VITS[name]["depth"], -(-AUTO_IMAGES // 4)
    z_auto, launches, fused = _embed_counted(
        _auto_embedder(model, "auto"), images)
    assert (launches, fused) == (depth * batches, batches)
    z_flash, launches, _ = _embed_counted(
        _auto_embedder(model, "flash"), images)
    assert launches == depth * batches
    assert torch.equal(z_auto, z_flash)
    z_dense, launches, fused = _embed_counted(
        _auto_embedder(model, "dense"), images)
    assert (launches, fused) == (0, 0)
    z_f32, launches, fused = _embed_counted(
        _auto_embedder(model, "auto", "highest"), images)
    assert (launches, fused) == (0, 0)
    gap = float((z_auto - z_dense).norm() / z_dense.norm())
    noise = float((z_dense - z_f32).norm() / z_f32.norm())
    assert bool(torch.isfinite(z_auto).all()) and gap <= 3.0 * noise, \
        (gap, noise)


@pytest.mark.cuda
def test_auto_embedder_exports_dense_on_card():
    """An "auto" bfloat16 embedder on the card exports: the trace takes
    the dense attention (the kernel cannot be traced)."""
    _card()
    model, _ = _auto_case("dh64")
    emb = _auto_embedder(model, "auto")
    art = texport.export_category_programs(emb, emb._cfg, n_images=8)
    assert set(art["programs"]) == {"cuda"}


@pytest.mark.cuda
def test_auto_embedder_over_distinct_cards():
    """Over a mesh of two distinct cards each shard launches the kernel on
    its own card: Z bit for bit that of the same mesh's shapes on one card
    (a virtual mesh of cuda:0 twice), the launches depth x batches x 2, the
    batches counted once."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    model, images = _auto_case("dh64")
    depth, batches = AUTO_VITS["dh64"]["depth"], -(-AUTO_IMAGES // 4)
    z_two, launches, fused = _embed_counted(_auto_embedder(
        model, "auto", mesh=Mesh(["cuda:0", "cuda:1"])), images)
    assert (launches, fused) == (depth * batches * 2, batches)
    z_one, launches, _ = _embed_counted(_auto_embedder(
        model, "flash", mesh=Mesh(["cuda:0", "cuda:0"])), images)
    assert launches == depth * batches * 2
    assert z_two.device == z_one.device and torch.equal(z_two, z_one)
