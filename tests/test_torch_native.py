"""tpu_ac_torch.native (the host library built from native/tpu_ac_native.cpp
into build/) against tpu_ac.native (the same source built by its Makefile
into native/): equal results, no tolerance, on seeded and on tied inputs;
and the port's clustering metrics, which take the native Hungarian solver
first as tpu_ac's do, equal to tpu_ac's."""

import os

import numpy as np
import pytest

from tpu_ac import native as jnative
from tpu_ac.cluster import metrics as jmetrics
from tpu_ac_torch import native as tnative
from tpu_ac_torch.cluster import metrics as tmetrics


@pytest.fixture(scope="module")
def libs():
    if tnative.get_lib() is None or jnative.get_lib() is None:
        pytest.skip("no C++ compiler: both packages run their fallbacks")
    return tnative.get_lib(), jnative.get_lib()


def _tied(n, seed):
    """Integer costs from few values: many optimal assignments."""
    return np.random.default_rng(seed).integers(0, 3, (n, n)).astype(
        np.float64)


@pytest.mark.parametrize("cost", [
    np.random.default_rng(0).uniform(size=(2, 2)),
    np.random.default_rng(1).uniform(size=(20, 20)),
    np.random.default_rng(2).uniform(size=(64, 64)),
    _tied(7, 3), _tied(33, 4), np.ones((5, 5)), 1.0 - np.eye(6),
], ids=["seeded2", "seeded20", "seeded64", "tied7", "tied33", "ones",
        "identity"])
def test_hungarian_equals_tpu_ac(libs, cost):
    got, got_total = tnative.hungarian(cost)
    want, want_total = jnative.hungarian(cost)
    np.testing.assert_array_equal(got, want)
    assert got_total == want_total
    assert sorted(got.tolist()) == list(range(len(cost)))


def test_hungarian_rejects_non_square():
    with pytest.raises(ValueError, match="square"):
        tnative.hungarian(np.zeros((2, 3)))


@pytest.mark.parametrize("m,n,d,k", [(17, 101, 24, 5), (3, 2, 4, 10),
                                     (40, 256, 96, 1)])
def test_knn_l2_equals_tpu_ac(libs, m, n, d, k):
    rng = np.random.default_rng(m * n)
    q = rng.standard_normal((m, d)).astype(np.float32)
    bank = rng.standard_normal((n, d)).astype(np.float32)
    got = tnative.knn_l2(q, bank, k)
    want = jnative.knn_l2(q, bank, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_knn_l2_ties_equal_tpu_ac(libs):
    """Duplicated bank rows tie exactly; both order them alike."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal((8, 16)).astype(np.float32)
    bank = np.concatenate([base, base, base])
    got = tnative.knn_l2(base[:4], bank, 6)
    want = jnative.knn_l2(base[:4], bank, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,d,k", [(50, 8, 10), (300, 32, 40)])
def test_greedy_coreset_equals_tpu_ac(libs, n, d, k):
    rng = np.random.default_rng(n)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    anchor = np.linalg.norm(feats - feats[0], axis=1).astype(np.float32)
    np.testing.assert_array_equal(tnative.greedy_coreset(feats, anchor, k),
                                  jnative.greedy_coreset(feats, anchor, k))


def test_builds_under_build_dir_not_native(monkeypatch, tmp_path):
    """A fresh build lands in the build directory, keyed by a hash, and
    writes nothing into native/."""
    native_dir = os.path.dirname(tnative.SOURCE)

    def listing():
        return sorted((e.name, e.stat().st_mtime_ns)
                      for e in os.scandir(native_dir))

    before = listing()
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_failed", False)
    lib = tnative.get_lib()
    if lib is None:
        pytest.skip("no C++ compiler here")
    built = os.listdir(tmp_path)
    assert len(built) == 1 and built[0].startswith("libtpu_ac_native-")
    assert built[0] == os.path.basename(
        tnative.library_path(tnative._compiler()))
    assert listing() == before
    cost = np.random.default_rng(0).uniform(size=(9, 9))
    np.testing.assert_array_equal(tnative.hungarian(cost)[0],
                                  jnative.hungarian(cost)[0])


@pytest.mark.parametrize("seed,n,k_true,k_pred", [(0, 100, 5, 5),
                                                  (1, 60, 3, 7),
                                                  (2, 40, 6, 2)])
def test_cluster_metrics_equal_tpu_ac(libs, seed, n, k_true, k_pred):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k_true, n)
    preds = rng.integers(0, k_pred, n)
    np.testing.assert_array_equal(tmetrics.best_map(labels, preds),
                                  jmetrics.best_map(labels, preds))
    assert tmetrics.clustering_scores(labels, preds) == \
        jmetrics.clustering_scores(labels, preds)


def test_best_map_ties_equal_tpu_ac(libs):
    """A contingency table with tied assignments: both packages take the
    native solver's."""
    labels = np.repeat(np.arange(4), 5)
    preds = np.tile(np.arange(4), 5)
    np.testing.assert_array_equal(tmetrics.best_map(labels, preds),
                                  jmetrics.best_map(labels, preds))
