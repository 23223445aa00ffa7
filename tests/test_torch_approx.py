"""tpu_ac_torch.detect.approx vs tpu_ac.detect.approx on the CPU: k-means
(numpy's start rows), IVF-Flat and IVF-PQ, and their index files across
the packages.

Data: Gaussian modes with small noise, seeded.  Tolerances: k-means
assignments equal and centroids to 1e-5 of the largest |centroid| (sums of
one-hot products in another order); IVF neighbours equal at full probe,
distances to 1e-5 relative of |q|^2 + max|b|^2 (IVF-Flat) and 1e-4 of the
ADC distance's magnitude (IVF-PQ: its constants pass through numpy on both
sides; the tables differ in summation order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.detect import approx as japp
from tpu_ac_torch.detect import approx as tapp


def _clustered(n, d, seed, n_modes=12):
    rng = np.random.default_rng(seed)
    modes = rng.standard_normal((n_modes, d)).astype(np.float32) * 8
    pick = rng.integers(0, n_modes, n)
    return modes[pick] + rng.standard_normal((n, d)).astype(np.float32) * 0.3


@pytest.mark.parametrize("k,iters", [(4, 10), (12, 3)])
def test_kmeans_matches(k, iters):
    x = _clustered(300, 16, 0)
    jc, ja = japp.kmeans(jnp.asarray(x), k, iters, seed=2)
    tc, ta = tapp.kmeans(torch.from_numpy(x), k, iters, seed=2)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jc)).max())


def test_kmeans_batched_matches():
    xs = np.stack([_clustered(200, 4, s) for s in range(3)])
    jc, ja = japp._kmeans_batched(jnp.asarray(xs), 8, 5, 1)
    tc, ta = tapp._kmeans_batched(torch.from_numpy(xs), 8, 5, 1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jc)).max())


def test_ivfflat_full_probe_matches():
    bank, query = _clustered(400, 16, 1), _clustered(50, 16, 2)
    j = japp.IVFFlatIndex(n_lists=8, n_probe=8, query_chunk=16)
    t = tapp.IVFFlatIndex(n_lists=8, n_probe=8, query_chunk=16,
                          device="cpu")
    j.fit(bank)
    t.fit(bank)
    for key in ("cells", "cell_ids", "cell_valid"):
        np.testing.assert_array_equal(getattr(t, key).numpy(),
                                      np.asarray(getattr(j, key)), key)
    jd, ji = j.search(query, 5)
    td, ti = t.search(query, 5)
    np.testing.assert_array_equal(ti, ji)
    tol = 1e-5 * ((query ** 2).sum(1).max() + (bank ** 2).sum(1).max())
    np.testing.assert_allclose(td, jd, rtol=0, atol=tol)
    exact = np.argsort(((query[:, None] - bank[None]) ** 2).sum(-1), 1)[:, :5]
    np.testing.assert_array_equal(np.sort(ti, 1), np.sort(exact, 1))


@pytest.mark.parametrize("d,code_size,n_bits", [(32, 8, 6), (30, 8, 6),
                                                (32, 16, 4)])
def test_ivfpq_full_probe_matches(d, code_size, n_bits):
    """Including D = 30, padded to a multiple of the 8 sub-quantizers."""
    bank, query = _clustered(500, d, 3), _clustered(40, d, 4)
    kw = dict(n_lists=8, n_probe=8, code_size=code_size, n_bits=n_bits,
              query_chunk=16)
    j = japp.IVFPQIndex(**kw)
    t = tapp.IVFPQIndex(**kw, device="cpu")
    j.fit(bank)
    t.fit(bank)
    np.testing.assert_array_equal(t.cell_codes.numpy(),
                                  np.asarray(j.cell_codes))
    np.testing.assert_array_equal(t.cell_ids.numpy(), np.asarray(j.cell_ids))
    assert t.code_bytes == j.code_bytes
    jd, ji = j.search(query, 3)
    td, ti = t.search(query, 3)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=0,
                               atol=1e-4 * np.abs(jd).max())


@pytest.mark.parametrize("method", ["ivfflat", "ivfpq"])
@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_index_file_loads_in_the_other_package(method, saver, tmp_path):
    bank, query = _clustered(300, 32, 5), _clustered(20, 32, 6)
    kw = dict(n_nearest_neighbours=2, n_lists=8, n_probe=4, method=method,
              code_size=8)
    src = japp.ApproximateNearestNeighbourScorer(**kw) if saver == "jax" \
        else tapp.ApproximateNearestNeighbourScorer(**kw, device="cpu")
    src.fit([bank])
    s1, d1, i1 = src.predict([query])
    src.save(str(tmp_path), prepend=method)
    dst = tapp.ApproximateNearestNeighbourScorer(method=method,
                                                 device="cpu") \
        if saver == "jax" else japp.ApproximateNearestNeighbourScorer(
            method=method)
    dst.load(str(tmp_path), prepend=method)
    s2, d2, i2 = dst.predict([query])
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-5, atol=1e-4)


def test_scorer_takes_tensors_and_rejects_unknown_method():
    bank = _clustered(200, 8, 7)
    s = tapp.ApproximateNearestNeighbourScorer(2, n_lists=8, n_probe=8,
                                               device="cpu")
    s.fit([torch.from_numpy(bank)])
    _, d2, _ = s.predict([torch.from_numpy(bank[:10])])
    assert d2[:, 0].max() < 1e-6  # full probe finds each row itself
    with pytest.raises(ValueError, match="method"):
        tapp.ApproximateNearestNeighbourScorer(method="hnsw")
