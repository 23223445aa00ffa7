"""tpu_ac_torch.distributed on a virtual CPU mesh (``Mesh(["cpu"] * dp)``:
one process runs the ranks one after another) against tpu_ac.distributed
on its 8-device CPU mesh (tests/conftest.py), the same seeded inputs.

Tolerance of the triangle scheme: rtol/atol 1e-5.  Both sides run the
same window-kernel arithmetic (tpu_ac's Pallas kernel in interpret mode,
the port's plain version) on tiles that never pair an image with itself,
and differ only in summation order.  The rect scheme and the supervised
path are in test_torch_distributed_rect.py (a file of its own, so that the
two halves of tpu_ac's compile time run on two test workers).
"""

import numpy as np
import pytest
import torch

from tpu_ac import distributed as jd
from tpu_ac_torch import distributed as td
from tpu_ac_torch.kernels import distances as tdist

TOL = dict(rtol=1e-5, atol=1e-5)

# (n, dp) of tests/test_distributed.py
CASES = [
    (10, 8),   # L=2, n_pad=16: even (the k == H tie-break) and padded rows
    (8, 8),    # L=1 (window width == H)
    (13, 5),   # L=3, n_pad=15 odd (no tie-break)
    (6, 2),    # dp=2: the window spans n_pad - 1 columns
]


def _z(n, p=16, d=64, seed=None):
    return np.random.default_rng(n if seed is None else seed) \
        .standard_normal((n, p, d)).astype(np.float32)


def _jax_w(Z, dp, **kw):
    mesh = jd.get_mesh(dp)
    z_sh, nv = jd.shard_batch(mesh, Z)
    return np.asarray(jd.sharded_weight_distance_unsupervised(
        mesh, z_sh, n_valid=nv, **kw))[:nv]


def _torch_w(Z, dp, **kw):
    mesh = td.Mesh(["cpu"] * dp)
    z_sh, nv = td.shard_batch(mesh, Z)
    w = td.sharded_weight_distance_unsupervised(mesh, z_sh, n_valid=nv, **kw)
    assert len(w) == dp and all(x.shape == (z_sh[0].shape[0], Z.shape[1])
                                for x in w)
    return torch.cat(w).numpy()[:nv]


@pytest.mark.parametrize("n,dp", CASES)
def test_triangle_matches_tpu_ac(n, dp):
    Z = _z(n)
    np.testing.assert_allclose(_torch_w(Z, dp, scheme="triangle"),
                               _jax_w(Z, dp, scheme="triangle"), **TOL)


@pytest.mark.parametrize("n,dp", [(10, 8), (7, 3)])
def test_triangle_equals_rect_without_self_terms(n, dp):
    """The two schemes of the port: the triangle W is the rect W with the
    self-term taken out (the same plain arithmetic, other sums)."""
    Z = _z(n, seed=n + 100)
    tri = _torch_w(Z, dp)
    rect = _torch_w(Z, dp, scheme="rect")
    idx = np.arange(n)
    self_g = tdist.min_dists_all_pairs(
        torch.from_numpy(Z), torch.from_numpy(Z)).numpy()[idx, idx]
    np.testing.assert_allclose(tri, rect - self_g / (n - 1), **TOL)


def test_triangle_bf16_against_rect():
    Z = _z(10)
    tri = _torch_w(Z, 8, precision="bf16")
    rect = _torch_w(Z, 8, precision="bf16", scheme="rect")
    np.testing.assert_allclose(tri, rect, rtol=3e-2, atol=3e-2)


def test_dp1_falls_back_to_rect():
    Z = _z(5)
    np.testing.assert_array_equal(_torch_w(Z, 1),
                                  _torch_w(Z, 1, scheme="rect"))


def test_bad_scheme_raises():
    mesh = td.Mesh(["cpu"] * 2)
    z_sh, nv = td.shard_batch(mesh, _z(4, 8, 32))
    with pytest.raises(ValueError, match="scheme"):
        td.sharded_weight_distance_unsupervised(mesh, z_sh, n_valid=nv,
                                                scheme="diag")


def test_triangle_weights_local_partials_sum_to_w():
    """Each rank's partial covers its own rows and the columns of its
    window; the partials' sum over ranks, over n - 1, is the W."""
    n, dp = 6, 3
    Z = torch.from_numpy(_z(n))
    w = sum(td.triangle_weights_local(Z[2 * r:2 * r + 2], Z, r, n)
            for r in range(dp)) / (n - 1)
    np.testing.assert_allclose(w.numpy(), _torch_w(Z.numpy(), dp), **TOL)


class TestMeshHelpers:
    def test_shard_batch_pads_and_splits(self):
        mesh = td.Mesh(["cpu"] * 4)
        x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
        shards, n = td.shard_batch(mesh, x)
        assert n == 10 and [s.shape for s in shards] == [(3, 3)] * 4
        full = torch.cat(shards).numpy()
        np.testing.assert_array_equal(full[:10], x)
        assert (full[10:] == 0).all()
        # a tensor stays a tensor of its dtype, split the same way
        t_shards, _ = td.shard_batch(mesh, torch.from_numpy(x))
        for a, b in zip(shards, t_shards):
            assert torch.equal(a, b)

    def test_replicate_one_copy_per_device(self):
        mesh = td.Mesh(["cpu", "cpu", "cpu"])
        x = torch.ones(2)
        reps = td.replicate(mesh, x)
        assert len(reps) == 3 and reps[0] is reps[1] is reps[2]
        assert torch.equal(reps[0], x)
        assert mesh.distinct_devices == (torch.device("cpu"),)

    def test_mesh_size(self):
        mesh = td.Mesh(["cpu"] * 3)
        assert mesh.size == 3 and mesh.axis_name == "dp"
        with pytest.raises(ValueError):
            td.Mesh([])

    def test_get_mesh_raises_past_the_cards(self):
        n = torch.cuda.device_count() + 1
        with pytest.raises(ValueError, match=f"requested a {n}-device"):
            td.get_mesh(n)

    def test_dp_mesh_checks_batch(self):
        with pytest.raises(ValueError, match="not divisible"):
            td.dp_mesh(3, batch_size=8)

    def test_shard_count_must_match_mesh(self):
        mesh = td.Mesh(["cpu"] * 2)
        z_sh, nv = td.shard_batch(td.Mesh(["cpu"] * 3), _z(6, 8, 32))
        with pytest.raises(ValueError, match="shards"):
            td.sharded_weight_distance_unsupervised(mesh, z_sh, n_valid=nv)
