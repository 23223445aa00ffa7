"""tpu_ac_torch.kernels.distances on the CPU: the plain version vs the
Pallas kernel of tpu_ac (interpret mode, the same arithmetic), the
wrapper's checks, and the launch counter.

Tolerance: rtol/atol 1e-5, except the self-distance of an image with
itself (symmetric mode, j == i): there d2 = |a|^2 - 2 a.a' + |a|^2 cancels
to the precision mode's floor, so any difference in summation order
between XLA and torch shows up amplified through the sqrt.  Those entries
are held to the floor bound |sqrt(x) - sqrt(y)| <= sqrt(|x - y|), with
|x - y| <= 64 f32 ulps of the norms, and both sides stay <= 0.06 (the
tpu_ac self-distance contract, tests/test_kernels.py).  The CUDA kernel
itself is compared with this plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.kernels import distances as jdist
from tpu_ac_torch.kernels import distances as tdist

EPS = np.finfo(np.float32).eps


def _check_close(got, want, Z, symmetric):
    """1e-5 everywhere but the j == i self-term of symmetric mode."""
    mask = np.ones(got.shape, bool)
    if symmetric:
        n = got.shape[0]
        mask[np.arange(n), np.arange(n)] = False
        floor = np.sqrt(64 * EPS * 2 * np.max(np.sum(Z * Z, -1)))
        diag_g = got[np.arange(n), np.arange(n)]
        diag_w = want[np.arange(n), np.arange(n)]
        assert np.abs(diag_g - diag_w).max() <= floor
        assert diag_g.max() <= 0.06 and diag_w.max() <= 0.06
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("precision", ["f32", "bf16c", "bf16"])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("n,nb,p,q", [
    (6, 6, 24, 24),
    (5, 3, 20, 16),   # ragged n, p not a multiple of 16
    (7, 4, 19, 19),   # ragged p (the col-min p mask in tpu_ac)
])
def test_plain_matches_pallas(precision, symmetric, n, nb, p, q):
    rng = np.random.default_rng(n * 100 + p)
    Z = rng.standard_normal((n, p, 96)).astype(np.float32)
    bank = Z if symmetric else rng.standard_normal((nb, q, 96)).astype(
        np.float32)
    want = np.asarray(jdist.min_dists_all_pairs(
        jnp.asarray(Z), jnp.asarray(bank), d_tile=96, precision=precision,
        symmetric=symmetric, interpret=True))
    got = tdist.min_dists_all_pairs(
        torch.from_numpy(Z), torch.from_numpy(bank), precision=precision,
        symmetric=symmetric).numpy()
    assert got.shape == want.shape
    _check_close(got, want, Z, symmetric)


def test_split_hi_lo_matches():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    jh, jl = jdist._split_hi_lo(jnp.asarray(x))
    th, tl = tdist._split_hi_lo(torch.from_numpy(x))
    np.testing.assert_array_equal(th.float().numpy(),
                                  np.asarray(jh.astype(jnp.float32)))
    np.testing.assert_array_equal(tl.float().numpy(),
                                  np.asarray(jl.astype(jnp.float32)))


def test_bf16_nonnegative_and_close_to_f32():
    rng = np.random.default_rng(7)
    Z = torch.from_numpy(rng.standard_normal((4, 24, 128)).astype(
        np.float32))
    bank = torch.from_numpy(rng.standard_normal((3, 16, 128)).astype(
        np.float32))
    f32 = tdist.min_dists_all_pairs(Z, bank).numpy()
    fast = tdist.min_dists_all_pairs(Z, bank, precision="bf16").numpy()
    assert (fast >= 0).all()
    np.testing.assert_allclose(fast, f32, rtol=3e-2, atol=3e-2)


class TestErrors:
    def _z(self, *shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype)

    def test_bad_precision(self):
        with pytest.raises(ValueError, match="precision"):
            tdist.min_dists_all_pairs(self._z(2, 4, 8), self._z(2, 4, 8),
                                      precision="fp8")

    def test_symmetric_shape_mismatch(self):
        with pytest.raises(ValueError, match="symmetric"):
            tdist.min_dists_all_pairs(self._z(3, 4, 8), self._z(2, 4, 8),
                                      symmetric=True)

    def test_depth_mismatch(self):
        with pytest.raises(ValueError):
            tdist.min_dists_all_pairs(self._z(3, 4, 8), self._z(2, 4, 16))

    def test_dtype(self):
        with pytest.raises(TypeError):
            tdist.min_dists_all_pairs(self._z(2, 4, 8, dtype=torch.float64),
                                      self._z(2, 4, 8, dtype=torch.float64))

    def test_contiguity(self):
        z = self._z(2, 8, 4).transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            tdist.min_dists_all_pairs(z, z)


def test_cpu_call_launches_nothing():
    before = tdist.LAUNCHES
    z = torch.randn(3, 8, 32)
    tdist.min_dists_all_pairs(z, z, symmetric=True)
    tdist.min_dists_all_pairs(z, z[:2].contiguous())
    assert tdist.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16c", "bf16"])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("n,p,q,d", [
    (5, 20, 20, 96),
    # the wgmma/TMA tile edges: a warpgroup with no rows, a 112-column half
    # with no columns, one and 64 chunks of 64 deep
    (1, 112, 130, 96),
    (1, 130, 784, 4096),
    (1, 784, 112, 4096),
    (2, 784, 784, 4096),
])
def test_kernel_matches_plain_on_card(precision, symmetric, n, p, q, d):
    """The CUDA kernel vs the plain version on the card, held on squared
    distances to 1e-4 of |a|^2 + max|b|^2: both form the same bf16 products
    exactly and differ only in f32 summation order (chip_smoke.py
    _check_agree gives the bound); a CUDA call counts one launch.  In
    symmetric mode the bank is Z (Q = P)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(3)
    Z = torch.from_numpy(rng.standard_normal((n, p, d)).astype(
        np.float32)).cuda()
    bank = Z if symmetric else torch.from_numpy(rng.standard_normal(
        (3, q, d)).astype(np.float32)).cuda()
    before = tdist.LAUNCHES
    got = tdist.min_dists_all_pairs(Z, bank, precision=precision,
                                    symmetric=symmetric)
    assert tdist.LAUNCHES == before + 1
    want = tdist.min_dists_all_pairs_plain(Z, bank, precision=precision,
                                           symmetric=symmetric)
    tol = 1e-4 * (Z.square().sum(-1)[:, None, :]
                  + bank.square().sum(-1).amax(-1)[None, :, None])
    assert bool(((got.square() - want.square()).abs() <= tol).all())
