"""The viz path on the card against its own CPU run, marked ``cuda`` (they
skip without a card).  This file imports nothing of tpu_ac or sklearn and
no matplotlib: the card's machine has none of them.

- ``ViT.all_selfattentions`` (f32, TF32 off) of a tiny ViT with one and
  two prefix tokens: within ``ATTN_BOUND`` (relative L2) of the CPU's;
- ``interpolate_nearest``: equal;
- ``visualize_attention.attention_arrays``: the CLS rows within the bound,
  the threshold masks equal outside the band of ``test_torch_viz.py``;
- the video's heat maps within the bound, and the CLI's GIF on the card
  (its default device) from a directory of frames that are not square.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_ac_torch.cli import video_generation
from tpu_ac_torch.cli import visualize_attention as vis
from tpu_ac_torch.models import registry
from tpu_ac_torch.models.convert import load_jax_params
from tpu_ac_torch.models.vit import ViT, ViTConfig, init_vit_params
from tpu_ac_torch.ops.interpolate import interpolate_nearest
from tpu_ac_torch.viz import video

pytestmark = pytest.mark.cuda

CFG = dict(patch_size=8, embed_dim=64, depth=3, num_heads=2, img_size=32)
ARCH = "tiny_torch_viz_card"
ATTN_BOUND = 1e-5
MASS_BOUND = 1e-5


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the viz path on the card)")
    registry.register_backbone(ARCH, registry.BackboneSpec(
        "vit", ViTConfig(**CFG), None))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _model(prefix=1):
    cfg = ViTConfig(**CFG, num_prefix_tokens=prefix)
    m = ViT(cfg).to_empty(device="cpu")
    return load_jax_params(m, init_vit_params(0, cfg)).eval()


@pytest.mark.parametrize("prefix", [1, 2])
def test_all_selfattentions_card_vs_cpu(prefix):
    model = _model(prefix)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 48, 40)).astype(np.float32))
    with torch.inference_mode():
        cpu = model.all_selfattentions(x).numpy()
        card = model.cuda().all_selfattentions(x.cuda()).cpu().numpy()
    n = 6 * 5 + prefix
    assert card.shape == (3, 2, 2, n, n)
    assert _rel(card, cpu) <= ATTN_BOUND


def test_interpolate_nearest_card_equals_cpu():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 7, 9)).astype(np.float32))
    for size in ((24, 30), (5, 4)):
        np.testing.assert_array_equal(
            interpolate_nearest(x.cuda(), size).cpu().numpy(),
            interpolate_nearest(x, size).numpy())


def test_attention_arrays_card_vs_cpu(tmp_path):
    p = str(tmp_path / "img.png")
    Image.fromarray(np.random.default_rng(2).integers(
        0, 255, (64, 72, 3), dtype=np.uint8)).save(p)
    model = _model()
    cpu = vis.attention_arrays(model, p, (48, 48), 0.6, "cpu")
    card = vis.attention_arrays(model, p, (48, 48), 0.6, "cuda")
    assert _rel(card["cls_attn"], cpu["cls_attn"]) <= ATTN_BOUND
    assert _rel(card["maps"], cpu["maps"]) <= ATTN_BOUND
    np.testing.assert_array_equal(card["disp"], cpu["disp"])
    np.testing.assert_array_equal(card["image"], cpu["image"])
    share, cum = vis.cumulative_mass(cpu["cls_attn"][-1])
    band = np.abs(cum - 0.4) <= share + MASS_BOUND
    got = vis.threshold_masks(card["cls_attn"][-1], 0.6)
    want = vis.threshold_masks(cpu["cls_attn"][-1], 0.6)
    assert np.array_equal(got[~band], want[~band])


def test_video_card_vs_cpu(tmp_path):
    model = _model()
    frames = np.random.default_rng(3).standard_normal(
        (3, 3, 32, 48)).astype(np.float32)
    cpu = video.render_attention_frames(model, frames, "mean", "cpu")
    card = video.render_attention_frames(model, frames, "mean", "cuda")
    for a, b in zip(card, cpu):
        assert a.shape == (32, 48) and _rel(a, b) <= ATTN_BOUND
    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.default_rng(4)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
                        ).save(d / f"{i:05d}.jpg")
    out = video_generation.main(["--input_path", str(d), "--output_path",
                                 str(tmp_path / "out"), "--arch", ARCH,
                                 "--video_format", "gif"])
    assert os.path.basename(out) == "video.gif"
    gif = Image.open(out)
    assert gif.n_frames == 3 and gif.size == (56, 40)
