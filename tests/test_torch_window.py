"""tpu_ac_torch.kernels.distances.min_dists_window (the window mode of the
min_dists kernel, run by the triangle-sharded alpha) on the CPU: its plain
version against tpu_ac's ``min_dists_window`` (the Pallas kernel in
interpret mode), at the placements of tests/test_kernels.py TestWindowMode.

Tolerance: rtol/atol 1e-5 on the active tiles, as test_torch_distances.py.
No active tile pairs an image with itself (pair distance w - r + 1 lies in
[1, H] and H < N), so the self-distance floor never enters.  Inactive
tiles are undefined in tpu_ac; the port leaves them +inf.  The CUDA kernel
itself is compared with this plain version on the card (the ``cuda`` test
below, and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_ac.kernels import distances as jdist
from tpu_ac_torch.kernels import distances as tdist

TOL = dict(rtol=1e-5, atol=1e-5)

# (n, off, n_local, ti): a rank owning rows off .. off + n_local - 1 of n
PLACEMENTS = [
    (8, 2, 2, 2),    # interior rank
    (8, 6, 2, 2),    # window wraps around the bank end
    (7, 0, 3, 2),    # odd N, n_local not divisible by ti
    (8, 3, 1, 1),    # single-row rank
]


def _window_inputs(n, off, n_local, p=20, d=96, seed=None):
    rng = np.random.default_rng(n * 10 + off if seed is None else seed)
    Z = rng.standard_normal((n, p, d)).astype(np.float32)
    h = n // 2
    w_win = n_local - 1 + h
    idx = (off + 1 + np.arange(w_win)) % n
    return Z[off:off + n_local], Z[idx], h


def _active(n_local, w_win, h):
    r = np.arange(n_local)[:, None]
    w = np.arange(w_win)[None, :]
    return (r <= w) & (w < r + h)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n,off,n_local,ti", PLACEMENTS)
def test_plain_matches_pallas(precision, n, off, n_local, ti):
    z_loc, bank_w, h = _window_inputs(n, off, n_local)
    want_row, want_col = (np.asarray(x) for x in jdist.min_dists_window(
        jnp.asarray(z_loc), jnp.asarray(bank_w), window=h, d_tile=96,
        precision=precision, ti=ti))
    row, col = tdist.min_dists_window(
        torch.from_numpy(z_loc), torch.from_numpy(bank_w), window=h,
        precision=precision)
    w_win = bank_w.shape[0]
    assert row.shape == want_row.shape == (n_local, w_win, z_loc.shape[1])
    assert col.shape == want_col.shape == (w_win, n_local, bank_w.shape[1])
    act = _active(n_local, w_win, h)
    np.testing.assert_allclose(row.numpy()[act], want_row[act], **TOL)
    np.testing.assert_allclose(col.numpy()[act.T], want_col[act.T], **TOL)
    # inactive tiles: +inf in the port, as the kernel leaves them
    assert np.isinf(row.numpy()[~act]).all()
    assert np.isinf(col.numpy()[~act.T]).all()


@pytest.mark.parametrize("precision", ["f32", "bf16c", "bf16"])
def test_active_tiles_match_all_pairs(precision):
    """Each active tile's row- and col-mins are the port's own all-pairs
    mins of the same two images (the same plain arithmetic: the col-min is
    the min over the transposed tile, equal up to the order of the rank-1
    norm adds)."""
    n, off, n_local = 9, 5, 3
    z_loc, bank_w, h = _window_inputs(n, off, n_local, p=12, d=64, seed=4)
    row, col = tdist.min_dists_window(
        torch.from_numpy(z_loc), torch.from_numpy(bank_w), window=h,
        precision=precision)
    fwd = tdist.min_dists_all_pairs(torch.from_numpy(z_loc),
                                    torch.from_numpy(bank_w),
                                    precision=precision).numpy()
    back = tdist.min_dists_all_pairs(torch.from_numpy(bank_w),
                                     torch.from_numpy(z_loc),
                                     precision=precision).numpy()
    act = _active(n_local, bank_w.shape[0], h)
    np.testing.assert_allclose(row.numpy()[act], fwd[act], **TOL)
    np.testing.assert_allclose(col.numpy()[act.T], back[act.T], **TOL)


@pytest.mark.parametrize("n_i,n_w,window", [
    (3, 5, 3),    # the mesh's shape: W = I - 1 + H
    (4, 3, 2),    # W < I - 1 + H: the last rows have fewer tiles
    (2, 6, 1),    # window 1: the diagonal only
])
def test_window_pairs(n_i, n_w, window):
    pairs = tdist.window_pairs(n_i, n_w, window)
    want = [(r, w) for r in range(n_i) for w in range(n_w)
            if r <= w < r + window]
    assert pairs.dtype == np.int32 and pairs.flags.c_contiguous
    assert [tuple(x) for x in pairs.tolist()] == want


@pytest.mark.parametrize("window", [0, -1])
def test_bad_window_raises(window):
    Z = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="window"):
        tdist.min_dists_window(Z, Z, window=window)
    with pytest.raises(ValueError, match="window"):
        tdist.min_dists_window_plain(Z, Z, window=window)


def test_bad_precision_raises():
    Z = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="precision"):
        tdist.min_dists_window(Z, Z, window=1, precision="fp8")


def test_cpu_call_launches_nothing():
    before = (tdist.LAUNCHES, tdist.WINDOW_LAUNCHES)
    z = torch.randn(3, 8, 32)
    tdist.min_dists_window(z[:2].contiguous(), z, window=2)
    assert (tdist.LAUNCHES, tdist.WINDOW_LAUNCHES) == before


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_min_dists_to_sets_matches(precision):
    rng = np.random.default_rng(11)
    zi = rng.standard_normal((19, 96)).astype(np.float32)
    bank = rng.standard_normal((4, 16, 96)).astype(np.float32)
    want = np.asarray(jdist.min_dists_to_sets(
        jnp.asarray(zi), jnp.asarray(bank), d_tile=96, precision=precision))
    got = tdist.min_dists_to_sets(torch.from_numpy(zi),
                                  torch.from_numpy(bank),
                                  precision=precision).numpy()
    assert got.shape == want.shape == (4, 19)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("n,off,n_local,ti", PLACEMENTS)
@pytest.mark.parametrize("p,d", [(20, 96), (130, 4096)])
def test_kernel_matches_plain_on_card(precision, n, off, n_local, ti, p, d):
    """The window kernel vs its plain version on the card, on the active
    tiles, held on squared distances to 1e-4 of the norms (chip_smoke.py
    _check_agree gives the bound), at P = 20 (one warpgroup, one Q half)
    and at P = 130, D = 4096 (a second slab, 64 chunks); inactive tiles
    +inf on both; a CUDA call counts one window launch and no other."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    z_loc, bank_w, h = (torch.from_numpy(x).cuda() if isinstance(
        x, np.ndarray) else x for x in _window_inputs(n, off, n_local, p,
                                                       d))
    before = (tdist.LAUNCHES, tdist.WINDOW_LAUNCHES)
    row, col = tdist.min_dists_window(z_loc, bank_w, window=h,
                                      precision=precision)
    assert (tdist.LAUNCHES, tdist.WINDOW_LAUNCHES) == (before[0],
                                                       before[1] + 1)
    want_row, want_col = tdist.min_dists_window_plain(
        z_loc, bank_w, window=h, precision=precision)
    torch.cuda.synchronize()
    act = torch.from_numpy(_active(n_local, bank_w.shape[0], h)).cuda()
    a2 = z_loc.square().sum(-1)  # [I, P]
    b2 = bank_w.square().sum(-1)  # [W, Q]
    tol_row = 1e-4 * (a2[:, None, :] + b2.amax(-1)[None, :, None])
    tol_col = 1e-4 * (b2[:, None, :] + a2.amax(-1)[None, :, None])
    for got, want, tol, m in ((row, want_row, tol_row, act),
                              (col, want_col, tol_col, act.t())):
        assert bool(torch.isinf(got[~m]).all())
        gap = (got[m].square() - want[m].square()).abs()
        assert bool(torch.isfinite(got[m]).all())
        assert bool((gap <= tol[m]).all())


@pytest.mark.parametrize("off", [0, 4])
def test_validity_masks_leave_tiles_out(off):
    """With row and column validity masks (a dp-2 rank over a bucket of 8
    with 6 valid images: rows and wrapped columns past 6 masked), the
    active tiles are those of the unmasked sweep with a valid row and
    column, equal to it there, and +inf elsewhere; the op takes the masks
    only as bool CPU tensors of the right length."""
    n, n_local, nv = 8, 4, 6
    z_loc, bank_w, h = _window_inputs(n, off, n_local)
    z_loc, bank_w = torch.from_numpy(z_loc), torch.from_numpy(bank_w)
    w_win = bank_w.shape[0]
    row_valid = off + torch.arange(n_local) < nv
    col_valid = (off + 1 + torch.arange(w_win)) % n < nv
    row, col = tdist.min_dists_window(z_loc, bank_w, window=h,
                                      row_valid=row_valid,
                                      col_valid=col_valid)
    full_row, full_col = tdist.min_dists_window(z_loc, bank_w, window=h)
    act = _active(n_local, w_win, h) & row_valid.numpy()[:, None] \
        & col_valid.numpy()[None, :]
    pairs = tdist.window_pairs(n_local, w_win, h, row_valid.numpy(),
                               col_valid.numpy())
    assert [tuple(x) for x in pairs.tolist()] == \
        [tuple(x) for x in np.argwhere(act).tolist()]
    assert act.sum() < _active(n_local, w_win, h).sum()
    np.testing.assert_array_equal(row.numpy()[act], full_row.numpy()[act])
    np.testing.assert_array_equal(col.numpy()[act.T],
                                  full_col.numpy()[act.T])
    assert np.isinf(row.numpy()[~act]).all()
    assert np.isinf(col.numpy()[~act.T]).all()
    with pytest.raises(ValueError, match="row_valid"):
        tdist.min_dists_window(z_loc, bank_w, window=h,
                               row_valid=row_valid.to(torch.int64))
    with pytest.raises(ValueError, match="col_valid"):
        tdist.min_dists_window(z_loc, bank_w, window=h,
                               col_valid=col_valid[1:])
