"""The host-side parts of tpu_ac_torch's min_dists kernel on the CPU: the
work list the persistent kernel walks (``work_items``), the operands' D
padding to the kernel's 64-deep chunk, and the operand checks the TMA
tensor maps need.  The kernel itself runs only on the card (chip_smoke.py
and the ``cuda``-marked tests of test_torch_distances.py and
test_torch_window.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_ac_torch.kernels import distances as tdist

P = 784  # patches of a ViT-B/8 image: 7 slabs of 128 rows
# (n, off, n_local): the rank placements of test_torch_window.py
PLACEMENTS = [(8, 2, 2), (8, 6, 2), (7, 0, 3), (8, 3, 1)]


def _schedules():
    """(label, pairs, n_i) of each mode at the sizes the tests cover."""
    out = []
    for n in (1, 2, 84, 168):
        out.append((f"symmetric-{n}", tdist.symmetric_pairs(n)))
        out.append((f"rectangular-{n}", tdist.all_pairs(n, max(1, n // 2))))
    for n, off, n_local in PLACEMENTS:
        h = n // 2
        out.append((f"window-{n}-{off}-{n_local}",
                    tdist.window_pairs(n_local, n_local - 1 + h, h)))
    return out


SCHEDULES = _schedules()


@pytest.mark.parametrize("label,pairs", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_every_item_once(label, pairs):
    items = tdist.work_items(pairs, P)
    assert items.dtype == np.int32 and items.flags.c_contiguous
    assert items.shape == (len(pairs) * 7, 3)
    want = sorted((int(i), int(j), s) for i, j in pairs for s in range(7))
    assert sorted(map(tuple, items.tolist())) == want


@pytest.mark.parametrize("label,pairs", SCHEDULES,
                         ids=[s[0] for s in SCHEDULES])
def test_grouping_holds(label, pairs):
    """Bands of _GROUP query images, bank image next, then the query
    image, the slabs of a pair adjacent and in order."""
    items = tdist.work_items(pairs, P).astype(np.int64)
    g = tdist._GROUP
    key = np.stack([items[:, 0] // g, items[:, 1], items[:, 0], items[:, 2]],
                   axis=1)
    # lexicographically strictly increasing: the walk order above
    diff = np.diff(key, axis=0)
    first = np.argmax(diff != 0, axis=1)
    assert (diff[np.arange(len(diff)), first] > 0).all()
    slabs = items[:, 2].reshape(-1, 7)
    assert (slabs == np.arange(7)).all()


@pytest.mark.parametrize("label,pairs", [
    ("symmetric-168", tdist.symmetric_pairs(168)),
    ("rectangular-96x84", tdist.all_pairs(96, 84)),
    ("window-84x167", tdist.window_pairs(84, 167, 84))],
    ids=["symmetric-168", "rectangular-96x84", "window-84x167"])
def test_items_in_flight_share_operands(label, pairs):
    """At the main path's shapes, any 132 consecutive items (one a block of
    an H100's 132 SMs) touch at most 15 images, at most 11 of them bank
    images: the operands the source note counts as live in L2."""
    items = tdist.work_items(pairs, P)
    worst_j = worst = 0
    for start in range(0, len(items) - 132, 7):
        win = items[start:start + 132]
        n_j = len(np.unique(win[:, 1]))
        worst_j = max(worst_j, n_j)
        worst = max(worst, len(np.unique(win[:, 0])) + n_j)
    assert worst_j <= 11 and worst <= 15


def test_slabs_follow_p():
    for p, n_slabs in ((1, 1), (128, 1), (129, 2), (784, 7)):
        items = tdist.work_items(np.array([[0, 0]]), p)
        assert items[:, 2].tolist() == list(range(n_slabs))


@pytest.mark.parametrize("precision", tdist.PRECISIONS)
def test_depth_padding_changes_nothing(precision):
    """The kernel's operands are the plain version's, zero-padded from
    D = 96 to the 64-deep chunk (128): parts equal bit for bit, norms those
    of the unpadded values, and the plain version on the padded inputs
    gives the same bits (integer-valued inputs make every sum exact, so
    any difference would be the padding's)."""
    rng = np.random.default_rng(1)
    Z = torch.from_numpy(rng.integers(-3, 4, (3, 20, 96)).astype(np.float32))
    bank = torch.from_numpy(rng.integers(-3, 4, (2, 24, 96)).astype(
        np.float32))
    z_parts, a2, b_parts, b2 = tdist._operands(Z, bank, precision, False)
    for parts, x in ((z_parts, Z), (b_parts, bank)):
        want, _ = tdist._prep(x, precision)
        for got, w in zip(parts, want):
            assert got.shape[2] == 128 and got.is_contiguous()
            assert torch.equal(got[..., :96], w)
            assert not got[..., 96:].any()
    assert torch.equal(a2, tdist._prep(Z, precision)[1])
    assert torch.equal(b2, tdist._prep(bank, precision)[1])
    pad = (lambda x: F.pad(x, (0, 32)))
    for sym in (True, False):
        b = Z if sym else bank
        got = tdist.min_dists_all_pairs_plain(pad(Z), pad(b),
                                              precision=precision,
                                              symmetric=sym)
        want = tdist.min_dists_all_pairs_plain(Z, b, precision=precision,
                                               symmetric=sym)
        assert torch.equal(got, want)
    got = tdist.min_dists_window_plain(pad(Z[:2]), pad(Z), window=2,
                                       precision=precision)
    want = tdist.min_dists_window_plain(Z[:2].contiguous(), Z, window=2,
                                        precision=precision)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_operand_check_takes_the_kernels_operands():
    z_parts, _, b_parts, _ = tdist._operands(torch.randn(2, 20, 96),
                                             torch.randn(3, 16, 96), "f32",
                                             False)
    for t in z_parts + b_parts:
        tdist._check_operand("x", t)


@pytest.mark.parametrize("fault", ["view", "offset", "dtype", "depth"])
def test_operand_check_raises(fault):
    """What a TMA tensor map over [N * rows, D] cannot address raises."""
    base = torch.zeros(2, 20, 136, dtype=torch.bfloat16)
    t = {"view": base[:, :, :128],  # rows 272 B apart: not contiguous
         "offset": base.reshape(-1)[1:1 + 2 * 20 * 128].reshape(2, 20, 128),
         "dtype": torch.zeros(2, 20, 128),
         "depth": base[:, :, :96].contiguous()}[fault]
    with pytest.raises(ValueError, match="contiguous"):
        tdist._check_operand("Z hi", t)
