"""The PatchCore modules' card paths against their CPU runs, marked ``cuda``
(they skip without a card).  This file imports nothing of tpu_ac: the
card's machine has no sklearn, which tpu_ac.detect needs.

The same seeded inputs run on the card and on the CPU: the k = 1 coreset
picks are equal (fixed-order sums); the batched and exact-greedy picks,
the IVF neighbours and the exact scorer's indices are equal on data with
no near-ties, distances within 1e-5 of |q|^2 + max|b|^2; the ResNet embed
within 1e-5 relative L2 at "highest" (TF32 off) and 2e-2 in bf16 (its
rounding, about 6e-3 on the CPU).
"""

import copy

import numpy as np
import pytest
import torch

from tpu_ac_torch import detect as tdet
from tpu_ac_torch.models import registry as treg
from tpu_ac_torch.models import resnet as tres
from tpu_ac_torch.pipeline import CategoryEmbedder, PipelineConfig

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the detect modules' card paths)")


def _clustered(n, d, seed, n_modes=12):
    rng = np.random.default_rng(seed)
    modes = rng.standard_normal((n_modes, d)).astype(np.float32) * 8
    pick = rng.integers(0, n_modes, n)
    return modes[pick] + rng.standard_normal((n, d)).astype(np.float32) * 0.3


def _tol(q, bank):
    return 1e-5 * ((q ** 2).sum(1).max() + (bank ** 2).sum(1).max())


@pytest.mark.parametrize("cls,kw", [
    ("ApproximateGreedyCoresetSampler", {}),
    ("ApproximateGreedyCoresetSampler", dict(select_batch=4)),
    ("GreedyCoresetSampler", dict(dimension_to_project_features_to=16)),
])
def test_coreset_on_card_matches_cpu(cls, kw):
    f = np.random.default_rng(0).standard_normal((2000, 256)).astype(
        np.float32)
    sampler = getattr(tdet, cls)(0.1, **kw)
    got = sampler.run(torch.from_numpy(f).cuda())
    assert got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), sampler.run(f))


@pytest.mark.parametrize("method", ["ivfflat", "ivfpq"])
def test_ivf_on_card_matches_cpu(method):
    """Distances within tol; the 3 nearest equal on every row whose 4
    nearest are more than tol apart (the queries' modes are not the
    bank's, so some rows hold near-ties that the two devices' summation
    orders may flip)."""
    bank, query = _clustered(3000, 64, 1), _clustered(500, 64, 2)
    kw = dict(n_nearest_neighbours=4, n_lists=16, n_probe=16, method=method,
              code_size=16)
    out = {}
    for dev in ("cuda", "cpu"):
        s = tdet.ApproximateNearestNeighbourScorer(**kw, device=dev)
        s.fit([bank])
        out[dev] = s.predict([query])
    tol = _tol(query, bank)
    (_, d_card, i_card), (_, d_cpu, i_cpu) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(d_card, d_cpu, rtol=0, atol=tol)
    clear = (np.diff(d_cpu, axis=1) > tol).all(1)
    assert clear.sum() > len(query) // 2
    np.testing.assert_array_equal(i_card[clear, :3], i_cpu[clear, :3])


def _embed(images):
    b, c, h, w = images.shape
    x = images.float().reshape(b, c, 4, h // 4, 4, w // 4).mean(dim=(3, 5))
    return x.permute(0, 2, 3, 1).reshape(b, 16, c)


@pytest.mark.parametrize("nn_method", ["exact", "ivfpq"])
def test_patchcore_on_card_matches_cpu(nn_method):
    rng = np.random.default_rng(3)
    train = rng.standard_normal((12, 3, 32, 32)).astype(np.float32)
    test = rng.standard_normal((6, 3, 32, 32)).astype(np.float32)
    test[4:] += 3.0
    out = {}
    for dev in ("cuda", "cpu"):
        pc = tdet.PatchCore(_embed, nn_method=nn_method, device=dev,
                            target_size=(32, 32), batch_size=4,
                            anomaly_score_num_nn=2)
        pc.fit(train)
        out[dev] = pc.predict(test)
    (cs, cm), (hs, hm) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(cs, hs, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cm, hm, rtol=0, atol=1e-5 * np.abs(hm).max())


@pytest.mark.parametrize("precision,rtol", [("highest", 1e-5),
                                            ("bfloat16", 2e-2)])
def test_resnet_embedder_on_card(precision, rtol):
    """CategoryEmbedder on a ResNet (the clustering sweep's embed), bf16
    BatchNorm included, against the CPU's f32."""
    treg.register_backbone("tiny_card_resnet", treg.BackboneSpec(
        "resnet", tres.ResNetConfig(block_counts=(1, 1, 1, 1),
                                    num_classes=10), None))
    model, _, _ = treg.load_backbone("tiny_card_resnet")
    images = np.random.default_rng(4).integers(0, 256, (6, 3, 224, 224),
                                               dtype=np.uint8)
    kw = dict(backbone_name="tiny_card_resnet",
              layers=("layer2", "layer3"), pretrain_embed_dimension=64,
              target_embed_dimension=96, batch_size=4)
    got = CategoryEmbedder(copy.deepcopy(model),
                           PipelineConfig(**kw, precision=precision),
                           device="cuda")(images)
    want = CategoryEmbedder(model, PipelineConfig(**kw, precision="highest"),
                            device="cpu")(images)
    assert got.is_cuda and tuple(got.shape) == (6, 784, 96)
    gap = float((got.cpu() - want).norm() / want.norm())
    assert gap <= rtol, gap
