"""tpu_ac_torch.distributed on a virtual CPU mesh against tpu_ac's on its
8-device CPU mesh: the rect scheme of the unsupervised sharded W and the
sharded supervised W, both on the rectangular kernel (the triangle scheme
is in test_torch_distributed.py).

Tolerances:
- rect scheme: the W rows sum the self-term mins[i, i], whose cancellation
  floor differs by summation order (test_torch_distances.py).  Each
  package's own self-term is taken out before the 1e-5 comparison and the
  two self-terms are held to the floor bound, as test_torch_alpha.py does.
- supervised: rtol/atol 1e-5 (no self-term: the bank is the train set).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac import distributed as jd
from tpu_ac.kernels import distances as jdist
from tpu_ac_torch import distributed as td
from tpu_ac_torch.kernels import distances as tdist

TOL = dict(rtol=1e-5, atol=1e-5)

# (n, dp) of tests/test_distributed.py, as in test_torch_distributed.py
CASES = [(10, 8), (8, 8), (13, 5), (6, 2)]


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
    return torch.cat(td.sharded_weight_distance_unsupervised(
        mesh, z_sh, n_valid=nv, **kw)).numpy()[:nv]


@pytest.mark.parametrize("n,dp", CASES)
def test_rect_matches_tpu_ac(n, dp):
    Z = _z(n)
    got = _torch_w(Z, dp, scheme="rect")
    want = _jax_w(Z, dp, scheme="rect")
    idx = np.arange(n)
    self_w = np.asarray(jdist.min_dists_all_pairs(
        jnp.asarray(Z), jnp.asarray(Z)))[idx, idx]
    self_g = tdist.min_dists_all_pairs(
        torch.from_numpy(Z), torch.from_numpy(Z)).numpy()[idx, idx]
    np.testing.assert_allclose(got - self_g / (n - 1),
                               want - self_w / (n - 1), **TOL)
    floor = np.sqrt(64 * np.finfo(np.float32).eps * 2 *
                    np.max(np.sum(Z * Z, -1)))
    assert np.abs(self_g - self_w).max() <= floor


def test_supervised_matches_tpu_ac():
    Z = _z(9)
    Ztr = _z(5, seed=50)
    jmesh = jd.get_mesh(8)
    jz, n = jd.shard_batch(jmesh, Z)
    want = np.asarray(jd.sharded_weight_distance_supervised(
        jmesh, jz, jnp.asarray(Ztr)))[:n]
    mesh = td.Mesh(["cpu"] * 8)
    tz, _ = td.shard_batch(mesh, Z)
    got = torch.cat(td.sharded_weight_distance_supervised(
        mesh, tz, torch.from_numpy(Ztr))).numpy()[:n]
    np.testing.assert_allclose(got, want, **TOL)
