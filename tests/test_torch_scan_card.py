"""The SCAN path on the card against its own CPU run, marked ``cuda``
(they skip without a card).  This file imports nothing of tpu_ac: the
card's machine has no sklearn, which tpu_ac's SCAN metrics need.

- One step of each kind (SimCLR, SCAN, SCAN head-only, self-label) at
  tpu_ac's tiny test widths, f32 with TF32 off: the loss within 1e-5
  relative, each parameter's gradient within 1e-4 (relative L2) and the
  BN statistics within 1e-5 of the CPU's, as chip_smoke.py's SCAN phase
  holds the full width (where the gradients' conditioning needs a float64
  reference; these widths do not).
- Mining: the card's neighbours equal the CPU's where the scores do not
  tie, on a bank without duplicates.
- The CLI on the card: the four stages of the micro config run, write
  tpu_ac's artifacts, and score the synthetic classes in [0, 1].
"""

import glob
import os

import numpy as np
import pytest
import torch

from tpu_ac_torch.cli import scan as cli
from tpu_ac_torch.device import precision_scope
from tpu_ac_torch.models.resnet_cifar import CifarResNetConfig
from tpu_ac_torch.train import optim
from tpu_ac_torch.train import scan as ts

pytestmark = pytest.mark.cuda

TINY = ts.SCANModelConfig(
    backbone=CifarResNetConfig(block_counts=(1, 1, 1, 1),
                               widths=(8, 16, 32, 64)),
    feature_dim=16, n_clusters=4, n_heads=2)
ONE = ts.SCANModelConfig(backbone=TINY.backbone, feature_dim=16,
                         n_clusters=4, n_heads=1)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the SCAN path on the card)")


def _rel(a, b) -> float:
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _case(kind):
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((8, 3, 32, 32)).astype(
        np.float32))
    b = a + 0.5 * torch.from_numpy(rng.standard_normal(
        (8, 3, 32, 32)).astype(np.float32))
    if kind == "simclr":
        p, bn = ts.init_contrastive_model(0, TINY, "cpu")
        return p, bn, optim.sgd(0.05, momentum=0.9), (a, b), \
            lambda s, x, y: ts.simclr_loss_and_grads(s, x, y, TINY, 0.5)
    if kind.startswith("scan"):
        p, bn = ts.init_clustering_model(0, TINY, "cpu")
        return p, bn, optim.adam(1e-3), (a, b), \
            lambda s, x, y: ts.scan_loss_and_grads(
                s, x, y, TINY, 2.0, kind == "scan_head_only")
    p, bn = ts.init_clustering_model(0, ONE, "cpu")
    return p, bn, optim.sgd(0.05, momentum=0.9), (a * 3, b * 3), \
        lambda s, x, y: ts.selflabel_loss_and_grads(s, x, y, ONE, 0.3)


@pytest.mark.parametrize("kind",
                         ["simclr", "scan", "scan_head_only", "selflabel"])
def test_step_on_card_matches_cpu(kind):
    p, bn, opt, batch, lg = _case(kind)
    cpu = ts.init_train_state(p, bn, opt)
    card = ts.scan_state_from_numpy(ts.scan_state_to_numpy(cpu), opt,
                                    "cuda")
    with precision_scope("highest"):
        loss_c, aux_c, g_c = lg(cpu, *batch)
        loss_g, aux_g, g_g = lg(card, *(x.cuda() for x in batch))
    assert float(loss_g) == pytest.approx(float(loss_c), rel=1e-5)
    for k, v in g_c.items():
        if float(torch.linalg.vector_norm(v)) > 0:
            assert _rel(g_g[k], v) < 1e-4, k
    bn_c = aux_c[0] if isinstance(aux_c, tuple) else aux_c
    bn_g = aux_g[0] if isinstance(aux_g, tuple) else aux_g
    for k, v in bn_c.items():
        assert _rel(bn_g[k], v) < 1e-5, k


def test_mining_on_card_matches_cpu():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((3000, 128)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    labels = rng.integers(0, 10, 3000)
    got = {}
    for dev in ("cpu", "cuda"):
        bank = ts.MemoryBank(3000, 128, 10, device=dev)
        bank.update(torch.from_numpy(f), labels)
        got[dev] = bank.mine_nearest_neighbors(20)
    np.testing.assert_array_equal(got["cuda"][0], got["cpu"][0])
    assert got["cuda"][1] == got["cpu"][1]


def test_cli_stages_on_card(tmp_path):
    env = tmp_path / "env.yml"
    env.write_text(f"root_dir: {tmp_path}/out\n")
    exp = tmp_path / "exp.yml"
    exp.write_text(
        "train_db_name: synthetic\nnum_classes: 2\nsynthetic_per_class: 8\n"
        "image_size: 32\nnum_heads: 2\nnum_neighbors: 3\nbatch_size: 8\n"
        "epochs: 1\nfeature_dim: 16\nlr: 0.05\nnum_workers: 2\n")
    for stage in ("simclr", "scan", "selflabel"):
        cli.main([stage, "--config_env", str(env), "--config_exp",
                  str(exp)])
    scores = cli.main(["eval", "--config_env", str(env), "--config_exp",
                       str(exp)])
    base = tmp_path / "out" / "synthetic"
    assert np.load(base / "top3-train-neighbors.npy").shape == (16, 4)
    for stage in ("pretext", "scan", "selflabel"):
        assert glob.glob(os.path.join(str(base), stage, "model-*"))
    assert all(0.0 <= scores[k] <= 1.0 for k in ("ACC", "NMI", "ARI"))
