"""tpu_ac_torch.ops.distances vs tpu_ac.ops.distances on the CPU:
``pairwise_sq_dists``, ``knn`` and ``knn_ip`` (whole and in small query
tiles), and the bank-sharded ``knn_sharded`` / ``knn_ip_sharded`` on
``Mesh(["cpu"] * dp)`` against tpu_ac's on its virtual devices
(tests/conftest.py gives it 8), with banks whose size does not divide by
dp.  Inputs are seeded numpy draws with no near-ties.

Tolerances: squared distances and similarities to 1e-5 relative of
|q|^2 + max|b|^2 (both sides form the same f32 products and sum them in
other orders); indices equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.distributed import get_mesh as jax_mesh
from tpu_ac.ops import distances as jd
from tpu_ac_torch.distributed import Mesh
from tpu_ac_torch.ops import distances as td


def _data(m, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _tol(q, bank):
    return 1e-5 * ((q ** 2).sum(-1).max() + (bank ** 2).sum(-1).max())


def _t(x):
    return torch.from_numpy(x)


def test_pairwise_sq_dists_matches():
    q, bank = _data(13, 29, 24, 0)
    got = td.pairwise_sq_dists(_t(q), _t(bank)).numpy()
    want = np.asarray(jd.pairwise_sq_dists(jnp.asarray(q), jnp.asarray(bank)))
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(q, bank))
    # batched leading axes, and cdist
    qb, bb = q.reshape(1, 13, 24), bank.reshape(1, 29, 24)
    np.testing.assert_allclose(
        td.pairwise_sq_dists(_t(qb), _t(bb)).numpy()[0], got, rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(td.cdist(_t(q), _t(bank)).numpy(),
                               np.asarray(jd.cdist(jnp.asarray(q),
                                                   jnp.asarray(bank))),
                               rtol=1e-5, atol=1e-5)
    assert (got >= 0).all()


@pytest.mark.parametrize("tile", [4096, 7])
@pytest.mark.parametrize("fn", ["knn", "knn_ip"])
def test_knn_matches(fn, tile):
    q, bank = _data(45, 60, 16, 1)
    d_t, i_t = getattr(td, fn)(_t(q), _t(bank), 5, tile=tile)
    d_j, i_j = getattr(jd, fn)(jnp.asarray(q), jnp.asarray(bank), 5,
                               tile=tile)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=_tol(q, bank))
    step = np.diff(d_t.numpy(), axis=1)
    assert ((step >= 0) if fn == "knn" else (step <= 0)).all()


def test_knn_against_brute_force():
    q, bank = _data(20, 100, 8, 2)
    d2, idx = td.knn(_t(q), _t(bank), 3)
    full = ((q[:, None].astype(np.float64) - bank[None]) ** 2).sum(-1)
    want = np.argsort(full, axis=1)[:, :3]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_allclose(d2.numpy(), np.take_along_axis(full, want, 1),
                               rtol=1e-4, atol=1e-5)


def test_ties_ordered_by_index():
    """Equal scores come back lowest index first, as lax.top_k orders
    them; which rows tied across the k-th place are kept is unspecified
    (their scores are equal)."""
    bank = np.zeros((6, 4), np.float32)
    bank[[1, 4]] = 1.0  # rows 0, 2, 3, 5 tie at distance 0 from q = 0
    d2, idx = td.knn(torch.zeros(1, 4), _t(bank), 6)
    assert idx.tolist() == [[0, 2, 3, 5, 1, 4]]
    assert d2.tolist() == [[0.0, 0.0, 0.0, 0.0, 4.0, 4.0]]
    d2, idx = td.knn(torch.zeros(1, 4), _t(bank), 3)
    assert d2.tolist() == [[0.0, 0.0, 0.0]]
    assert set(idx[0].tolist()) <= {0, 2, 3, 5}
    assert idx[0].tolist() == sorted(idx[0].tolist())


@pytest.mark.parametrize("dp,n", [(2, 61), (3, 61), (4, 62), (8, 61)])
@pytest.mark.parametrize("fn", ["knn_sharded", "knn_ip_sharded"])
def test_sharded_matches_tpu_ac(fn, dp, n):
    q, bank = _data(37, n, 16, 3 + dp)
    k = 4
    d_t, i_t = getattr(td, fn)(_t(q), _t(bank), k, Mesh(["cpu"] * dp),
                               tile=16)
    d_j, i_j = getattr(jd, fn)(jnp.asarray(q), jnp.asarray(bank), k,
                               jax_mesh(dp), tile=16)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=_tol(q, bank))
    # and the single-device search on the same inputs
    d_1, i_1 = getattr(td, fn.replace("_sharded", ""))(_t(q), _t(bank), k)
    np.testing.assert_array_equal(i_t.numpy(), i_1.numpy())
    np.testing.assert_allclose(d_t.numpy(), d_1.numpy(), rtol=0,
                               atol=_tol(q, bank))


def test_sharded_masks_padding_before_topk():
    """A bank of 9 rows over dp = 4 pads 3 zero rows onto the last rank;
    queries at the origin would pick them if they were not masked."""
    rng = np.random.default_rng(5)
    bank = (rng.standard_normal((9, 6)) + 5.0).astype(np.float32)
    q = np.zeros((3, 6), np.float32)
    d2, idx = td.knn_sharded(_t(q), _t(bank), 2, Mesh(["cpu"] * 4))
    assert int(idx.max()) < 9
    d_1, i_1 = td.knn(_t(q), _t(bank), 2)
    np.testing.assert_array_equal(idx.numpy(), i_1.numpy())


def test_sharded_falls_back_when_shards_are_short():
    """Fewer than k rows a rank: the single-device search, as tpu_ac."""
    q, bank = _data(5, 10, 8, 6)
    d_s, i_s = td.knn_sharded(_t(q), _t(bank), 4, Mesh(["cpu"] * 4))
    d_1, i_1 = td.knn(_t(q), _t(bank), 4)
    assert torch.equal(i_s, i_1) and torch.equal(d_s, d_1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the card's search path)")


@pytest.mark.cuda
def test_knn_on_card_against_float64():
    """knn on the card (TF32 forced on around it, which the search must
    turn off) vs a float64 search on the host: d2 to 1e-4 of
    |q|^2 + max|b|^2, indices equal where the k-th and (k+1)-th distances
    differ by more than that."""
    _cuda()
    q, bank = _data(3000, 5000, 1024, 7)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        d2, idx = td.knn(_t(q).cuda(), _t(bank).cuda(), 5, tile=1024)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    q64, b64 = q.astype(np.float64), bank.astype(np.float64)
    full = ((q64 ** 2).sum(1)[:, None] + (b64 ** 2).sum(1)[None]
            - 2.0 * q64 @ b64.T)
    order = np.argsort(full, axis=1)[:, :6]
    ref = np.take_along_axis(full, order, 1)
    tol = 1e-4 * ((q64 ** 2).sum(1) + (b64 ** 2).sum(1).max())
    assert (np.abs(d2.cpu().numpy() - ref[:, :5]) <= tol[:, None]).all()
    clear = ref[:, 5] - ref[:, 4] > tol
    np.testing.assert_array_equal(
        np.sort(idx.cpu().numpy()[clear], 1), np.sort(order[clear, :5], 1))


@pytest.mark.cuda
def test_knn_sharded_on_card_equals_knn():
    _cuda()
    q, bank = _data(700, 1001, 64, 8)
    qc, bc = _t(q).cuda(), _t(bank).cuda()
    d_s, i_s = td.knn_sharded(qc, bc, 5, Mesh(["cuda:0"] * 2), tile=256)
    d_1, i_1 = td.knn(qc, bc, 5, tile=256)
    assert torch.equal(i_s, i_1)
    assert float((d_s - d_1).abs().max()) <= _tol(q, bank)
