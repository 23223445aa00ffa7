"""tpu_ac_torch.detect (samplers, exact scorer, segmentor, metrics, PRO) vs
tpu_ac on the CPU, on seeded numpy inputs (the blur alone:
tests/test_torch_gaussian.py).

Tolerances: sampler indices equal (the data has no near-ties: distinct
Gaussian rows in 8-32 dims); scorer scores to 1e-5 of |q|^2 + max|b|^2
(the kNN rule, tests/test_torch_knn.py) and indices equal; the segmentor
to 1e-5 of max|mask| from tpu_ac's and 1e-5 relative of scipy's blur of
the same bilinear grids; the metrics equal to tpu_ac's sklearn-based ones
(the same float64 counts), AUROCs to 1e-12; PRO equal.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

import jax.numpy as jnp

from tpu_ac import detect as jdet
from tpu_ac_torch import detect as tdet


def _rows(n, d, seed, shift=0.0):
    return (np.random.default_rng(seed).standard_normal((n, d))
            + shift).astype(np.float32)


@pytest.mark.parametrize("kind,kw", [
    ("approx", dict(dimension_to_project_features_to=8)),
    ("approx", dict(dimension_to_project_features_to=16, seed=3)),
    ("approx", dict(select_batch=4, dimension_to_project_features_to=8)),
    ("approx", dict(select_batch=8, dimension_to_project_features_to=16,
                    seed=2)),
    ("greedy", dict(dimension_to_project_features_to=8, seed=1)),
    ("greedy", dict(select_batch=3, dimension_to_project_features_to=16)),
])
def test_coreset_picks_equal_tpu_ac(kind, kw):
    """The same rows, in the same order, through the JL projection (32 ->
    8 or 16 dims) and the greedy loop; the torch run keeps its tensor."""
    f = _rows(300, 32, 0)
    cls = "ApproximateGreedyCoresetSampler" if kind == "approx" \
        else "GreedyCoresetSampler"
    want = np.asarray(getattr(jdet, cls)(0.1, **kw).run(jnp.asarray(f)))
    got = getattr(tdet, cls)(0.1, **kw).run(torch.from_numpy(f))
    assert isinstance(got, torch.Tensor) and got.shape == (30, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    # numpy in, numpy out
    out = getattr(tdet, cls)(0.1, **kw).run(f)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, want)


def test_random_and_identity_samplers():
    f = _rows(40, 4, 1)
    np.testing.assert_array_equal(tdet.RandomSampler(0.5, seed=2).run(f),
                                  jdet.RandomSampler(0.5, seed=2).run(f))
    t = tdet.RandomSampler(0.5, seed=2).run(torch.from_numpy(f))
    np.testing.assert_array_equal(t.numpy(),
                                  jdet.RandomSampler(0.5, seed=2).run(f))
    assert tdet.IdentitySampler().run(f) is f
    with pytest.raises(ValueError):
        tdet.GreedyCoresetSampler(1.5)
    with pytest.raises(ValueError, match="select_batch"):
        tdet.GreedyCoresetSampler(0.5, select_batch=0)
    with pytest.raises(ValueError):
        tdet.RandomSampler(0.0)


@pytest.mark.parametrize("width", [1, 2, 3, 7, 8, 128])
def test_tree_sum_has_a_fixed_order(width):
    """The coreset loop's sum over features is the halving order, bit for
    bit (so the card and the CPU pick the same rows), whatever the storage
    strides; and it is a sum."""
    from tpu_ac_torch.detect.sampler import _tree_sum

    x = _rows(50, width, 3)
    want = x.copy()
    while want.shape[1] > 1:  # the same order in numpy float32
        h = want.shape[1] // 2
        s = want[:, :h] + want[:, h:2 * h]
        want = np.concatenate([s, want[:, 2 * h:]], 1) if want.shape[1] % 2 \
            else s
    got = _tree_sum(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want[:, 0])
    strided = torch.from_numpy(np.asfortranarray(x))
    assert torch.equal(_tree_sum(strided), got)
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64).sum(1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_scorer_matches_tpu_ac(k):
    bank, query = _rows(120, 16, 4), _rows(30, 16, 5)
    want = jdet.NearestNeighbourScorer(k)
    want.fit([bank])
    ws, wd, wi = want.predict([query])
    got = tdet.NearestNeighbourScorer(k, device="cpu")
    got.fit([torch.from_numpy(bank)])
    gs, gd, gi = got.predict([torch.from_numpy(query)])
    tol = 1e-5 * ((query ** 2).sum(1).max() + (bank ** 2).sum(1).max())
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=0, atol=tol)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=tol)


def test_scorer_feature_groups_and_unfitted():
    a, b, q = _rows(40, 4, 6), _rows(40, 3, 7), _rows(5, 7, 8)
    s = tdet.NearestNeighbourScorer(2, device="cpu")
    with pytest.raises(ValueError, match="not fitted"):
        s.predict([q])
    s.fit([a, torch.from_numpy(b)])
    j = jdet.NearestNeighbourScorer(2)
    j.fit([a, b])
    np.testing.assert_array_equal(s.predict([q[:, :4], q[:, 4:]])[2],
                                  j.predict([q[:, :4], q[:, 4:]])[2])


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_bank_saved_by_one_package_loads_in_the_other(saver, tmp_path):
    bank, query = _rows(60, 8, 9), _rows(12, 8, 10)
    src = jdet.NearestNeighbourScorer(3) if saver == "jax" else \
        tdet.NearestNeighbourScorer(3, device="cpu")
    src.fit([bank if saver == "jax" else torch.from_numpy(bank)])
    src.save(str(tmp_path), prepend="wrn_")
    dst = tdet.NearestNeighbourScorer(1, device="cpu") if saver == "jax" \
        else jdet.NearestNeighbourScorer(1)
    dst.load(str(tmp_path), prepend="wrn_")
    assert dst.n_nearest_neighbours == 3
    a, _, ia = src.predict([query])
    b, _, ib = dst.predict([query])
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_load_invalidates_device_bank_cache(tmp_path):
    bank_a, bank_b = _rows(50, 8, 11), _rows(40, 8, 12, shift=5.0)
    query = _rows(10, 8, 13)
    other = tdet.NearestNeighbourScorer(1, device="cpu")
    other.fit([bank_b])
    other.save(str(tmp_path))
    want, _, _ = other.predict([query])
    s = tdet.NearestNeighbourScorer(1, device="cpu")
    s.fit([torch.from_numpy(bank_a)])
    s.predict([query])  # caches bank_a
    s.load(str(tmp_path))
    got, _, _ = s.predict([query])
    np.testing.assert_allclose(got, want)


def test_segmentor_matches_tpu_ac_and_scipy():
    import torch.nn.functional as F

    scores = np.random.default_rng(15).uniform(0.5, 2.0, (3, 6, 6)).astype(
        np.float32)
    got = tdet.RescaleSegmentor((40, 40), device="cpu") \
        .convert_to_segmentation(scores)
    want = jdet.RescaleSegmentor((40, 40)).convert_to_segmentation(scores)
    assert got.shape == (3, 40, 40) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    up = F.interpolate(torch.from_numpy(scores)[:, None], size=(40, 40),
                       mode="bilinear", align_corners=False)[:, 0].numpy()
    ref = np.stack([ndimage.gaussian_filter(m, sigma=4.0) for m in up])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)


def _segs_and_masks(seed, n=6, size=24):
    rng = np.random.default_rng(seed)
    masks = np.zeros((n, size, size), bool)
    segs = rng.uniform(size=(n, size, size))
    for i in range(n):
        if i % 3:
            r, c = rng.integers(0, size - 6, 2)
            masks[i, r:r + 5, c:c + 6] = True
            if i % 2:
                masks[i, 1:3, 1:9] = True  # a second region
    segs[masks] += rng.uniform(0.0, 1.2, int(masks.sum()))
    segs[:, :2, :2] = 0.25  # ties across images
    return segs.astype(np.float32), masks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_sklearn_based(seed):
    segs, masks = _segs_and_masks(seed)
    labels = masks.reshape(len(masks), -1).any(1).astype(int)
    scores = segs.reshape(len(segs), -1).max(1)
    for a, b in ((tdet.compute_imagewise_retrieval_metrics(scores, labels),
                  jdet.compute_imagewise_retrieval_metrics(scores, labels)),
                 (tdet.compute_pixelwise_retrieval_metrics(segs, masks),
                  jdet.compute_pixelwise_retrieval_metrics(segs, masks))):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_allclose(np.asarray(a[key], np.float64),
                                       np.asarray(b[key], np.float64),
                                       rtol=1e-12, atol=0, err_msg=key)
    assert tdet.compute_pro(segs, masks) == jdet.compute_pro(segs, masks)
    assert tdet.compute_pro(list(segs), list(masks)) == \
        jdet.compute_pro(segs, masks)


def test_metrics_edge_cases():
    m = tdet.compute_imagewise_retrieval_metrics([0.1, 0.2, 0.9, 0.8],
                                                 [0, 0, 1, 1])
    assert m["auroc"] == 1.0 and m["threshold"][0] == np.inf
    with pytest.warns(UserWarning, match="one class"):
        assert np.isnan(tdet.compute_imagewise_retrieval_metrics(
            [0.1, 0.2], [1, 1])["auroc"])
    with pytest.raises(ValueError, match="region"):
        tdet.compute_pro(np.ones((1, 4, 4)), np.zeros((1, 4, 4)))
    with pytest.raises(ValueError, match="normal"):
        tdet.compute_pro(np.ones((1, 4, 4)), np.ones((1, 4, 4)))
