"""The eval suite on the card against its own CPU run, marked ``cuda``
(they skip without a card).  This file imports nothing of tpu_ac.

- ``extract_features`` of a tiny ViT in f32 with TF32 off: within 1e-5
  of the CPU's; under ``precision_scope("default")`` (TF32) within the
  zoo's card-vs-CPU gap bound, 1e-3 relative L2;
- ``knn_predictions``: the card's classes equal the CPU's on features
  with no tie at the k-th neighbour;
- one probe step and ``propagate_labels`` (with ties): within 1e-5;
- the k-NN and DAVIS CLIs run on the card (their default device).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_ac_torch.cli import eval_knn, eval_video_segmentation
from tpu_ac_torch.device import precision_scope
from tpu_ac_torch.models import registry
from tpu_ac_torch.models.convert import load_jax_params
from tpu_ac_torch.models.vit import ViT, ViTConfig, init_vit_params
from tpu_ac_torch.train import evals, video_seg

pytestmark = pytest.mark.cuda

CFG = ViTConfig(patch_size=8, embed_dim=64, depth=3, num_heads=2,
                img_size=32)
ARCH = "tiny_torch_evals_card"


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the eval suite on the card)")
    registry.register_backbone(ARCH, registry.BackboneSpec("vit", CFG, None))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("precision,bound", [("highest", 1e-5),
                                             ("default", 1e-3)])
def test_extract_features_card_vs_cpu(precision, bound):
    model = load_jax_params(ViT(CFG), init_vit_params(0, CFG)).eval()
    x = np.random.default_rng(0).standard_normal((12, 3, 40, 48)).astype(
        np.float32)

    def run(m, device):
        def embed(b):
            with precision_scope(precision):
                return m.forward_cls(b)
        with torch.inference_mode():
            return evals.extract_features(embed, x, 4, device=device)

    cpu = run(model, "cpu")
    card = run(model.to("cuda"), "cuda")
    assert _rel(card, cpu) <= bound


def test_knn_predictions_card_equals_cpu():
    rng = np.random.default_rng(1)
    bank = rng.standard_normal((5000, 64)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    q = rng.standard_normal((300, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    y = rng.integers(0, 50, 5000)
    k = 20
    sims = np.sort(q.astype(np.float64) @ bank.astype(np.float64).T,
                   axis=1)[:, ::-1]
    keep = sims[:, k - 1] - sims[:, k] > 1e-5
    cpu = evals.knn_predictions(bank, y, q, k, 0.07, 50, device="cpu")
    card = evals.knn_predictions(torch.from_numpy(bank).cuda(),
                                 torch.from_numpy(y).cuda(),
                                 torch.from_numpy(q).cuda(), k, 0.07, 50)
    assert keep.sum() > 250
    np.testing.assert_array_equal(card[keep, 0], cpu[keep, 0])


def test_probe_step_card_vs_cpu():
    rng = np.random.default_rng(2)
    f = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 64))
    out = {}
    for dev in ("cpu", "cuda"):
        state, step, _ = evals.make_linear_probe(96, 10, device=dev)
        for _ in range(3):
            state, loss = step(state, f.to(dev), y.to(dev), 0.1)
        out[dev] = (float(loss), state.weight.cpu().numpy())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5,
                               atol=1e-5)


def test_propagate_labels_card_vs_cpu():
    rng = np.random.default_rng(3)
    grid = (30, 52)  # DAVIS's 480 x 832 at 16 px patches
    tar = torch.from_numpy(rng.standard_normal((1560, 64)).astype(
        np.float32))
    ctx = torch.from_numpy(rng.standard_normal((4, 1560, 64)).astype(
        np.float32))
    ctx[2] = ctx[1]  # tied sources
    segs = torch.from_numpy(rng.random((4, 3, *grid)).astype(np.float32))
    cpu = video_seg.propagate_labels(tar, ctx, segs, grid=grid)
    card = video_seg.propagate_labels(tar.cuda(), ctx.cuda(), segs.cuda(),
                                      grid=grid)
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_knn_cli_on_the_card(tmp_path, capsys):
    rng = np.random.default_rng(4)
    for split, n in (("train", 6), ("val", 4)):
        for cls, base in (("a", 30), ("b", 220)):
            d = tmp_path / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                Image.fromarray(np.clip(
                    base + rng.integers(-20, 20, (32, 32, 3)), 0,
                    255).astype(np.uint8)).save(d / f"{i}.png")
    res = eval_knn.main(["--arch", ARCH, "--data_path", str(tmp_path),
                         "--nb_knn", "3", "--imagesize", "32",
                         "--batch_size_per_gpu", "8"])
    assert res[3][0] >= 75.0
    assert "3-NN classifier result" in capsys.readouterr().out


def test_davis_cli_on_the_card(tmp_path):
    vid = tmp_path / "JPEGImages" / "480p" / "v"
    ann = tmp_path / "Annotations" / "480p" / "v"
    sets = tmp_path / "ImageSets" / "2017"
    for d in (vid, ann, sets):
        d.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for t in range(4):
        arr = rng.integers(0, 40, (64, 128, 3)).astype(np.uint8)
        arr[16 + 4 * t:40 + 4 * t, 16:40] = 230
        Image.fromarray(arr).save(vid / f"{t:05d}.jpg", quality=95)
    labels = np.zeros((64, 128), np.uint8)
    labels[16:40, 16:40] = 1
    Image.fromarray(labels).save(ann / "00000.png")
    (sets / "val.txt").write_text("v\n")
    written = eval_video_segmentation.main(
        ["--arch", ARCH, "--data_path", str(tmp_path), "--output_dir",
         str(tmp_path / "out"), "--scale_size", "64"])
    assert len(written) == 4
    assert all(Image.open(p).mode == "P" for p in written)
