"""Pairwise-distance + min for the alpha weights: wrapper of the CUDA kernel
``csrc/min_dists.cu`` and its plain PyTorch version (port of
``tpu_ac.kernels.distances``: ``min_dists_all_pairs``, ``min_dists_window``
and ``min_dists_to_sets``).

    mins[i, j, p] = min_q || Z[i, p] - bank[j, q] ||

Precision modes, as in ``tpu_ac``:

- "f32" / "bf16c" (same computation): each operand is split z = hi + lo
  into two bf16 parts and the products accumulate hi.hi' + hi.lo' + lo.hi'
  in f32 (~2^-16 relative; the dropped lo.lo' term leaves a self-distance
  floor of ~|z| 2^-9); the norms |z|^2 are f32 sums of the unsplit values.
- "bf16": one pass over the bf16-rounded values, with the norms taken from
  the same rounded values, so d2 >= 0 up to summation order.

``symmetric=True`` asserts ``bank`` is ``Z`` (the unsupervised alpha): the
kernel computes only the i <= j pairs and emits both their row- and
col-mins.  ``min_dists_window`` is the same kernel over the circulant
window of one dp rank of the triangle-sharded alpha
(``tpu_ac_torch.distributed``).  A CUDA tensor launches the kernel or
raises; a CPU tensor runs the plain version (``*_plain``), the same
arithmetic as plain torch ops (bf16 parts upcast to f32, f32 matmul;
products of bf16 values are exact in f32, so only the summation order
differs from the kernel).  The TPU tiling knobs (``d_tile``, ``ti``,
``interpret``) are not carried.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "bf16c", "bf16")

# kernel launches (CUDA tensors only) made by min_dists_all_pairs, in the
# symmetric and rectangular modes, and by min_dists_window
LAUNCHES = 0
WINDOW_LAUNCHES = 0

_BK = 64  # the kernel's D chunk: D is zero-padded to a multiple of it
_BM = 128  # P rows of one work item (a slab)
_GROUP = 2  # query images a band of the work order


def _check(Z: torch.Tensor, bank: torch.Tensor, precision: str,
           symmetric: bool) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}; want one of {PRECISIONS}")
    if Z.ndim != 3 or bank.ndim != 3 or Z.shape[2] != bank.shape[2]:
        raise ValueError(f"want Z [I, P, D] and bank [J, Q, D]; got "
                         f"{tuple(Z.shape)} and {tuple(bank.shape)}")
    if symmetric and Z.shape != bank.shape:
        raise ValueError(f"symmetric=True needs bank is Z; got Z "
                         f"{tuple(Z.shape)} vs bank {tuple(bank.shape)}")
    if Z.dtype != torch.float32 or bank.dtype != torch.float32:
        raise TypeError(f"want float32 inputs; got {Z.dtype}, {bank.dtype}")
    if Z.device != bank.device:
        raise ValueError(f"Z on {Z.device} but bank on {bank.device}")
    if not (Z.is_contiguous() and bank.is_contiguous()):
        raise ValueError("Z and bank must be contiguous")


def _split_hi_lo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16 pair with hi + lo ~= x to ~16 mantissa bits."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _prep(x: torch.Tensor, precision: str):
    """(bf16 parts, f32 norms [N, P]) of one operand."""
    if precision == "bf16":
        hi = x.to(torch.bfloat16)
        return (hi,), hi.to(torch.float32).square().sum(-1)
    return _split_hi_lo(x), x.square().sum(-1)


def _plain_d2(Z: torch.Tensor, bank: torch.Tensor, precision: str):
    """d2(i, js) -> [len(js), P, Q] squared distances of query image i
    against bank images js, in the kernel's arithmetic."""
    z_parts, a2 = _prep(Z, precision)
    b_parts, b2 = _prep(bank, precision)
    zf = [t.to(torch.float32) for t in z_parts]
    bt = [t.to(torch.float32).transpose(1, 2) for t in b_parts]  # [J, D, Q]
    terms = [(0, 0)] if precision == "bf16" else [(0, 0), (0, 1), (1, 0)]

    def d2(i: int, js: slice) -> torch.Tensor:
        acc = None
        for za, bb in terms:
            t = torch.matmul(zf[za][i], bt[bb][js])  # [J', P, Q]
            acc = t if acc is None else acc + t
        return a2[i][None, :, None] - 2.0 * acc + b2[js][:, None, :]

    return d2


def min_dists_all_pairs_plain(Z: torch.Tensor, bank: torch.Tensor, *,
                              precision: str = "f32",
                              symmetric: bool = False) -> torch.Tensor:
    """The kernel's arithmetic as plain torch ops, one query image at a
    time (bounded memory).  ``symmetric`` only validates: every pair is
    computed directly."""
    _check(Z, bank, precision, symmetric)
    d2 = _plain_d2(Z, bank, precision)
    out = torch.empty(Z.shape[0], bank.shape[0], Z.shape[1],
                      dtype=torch.float32, device=Z.device)
    for i in range(Z.shape[0]):
        out[i] = d2(i, slice(None)).amin(dim=-1).clamp_min(0.0).sqrt()
    return out


def _check_window(Z: torch.Tensor, bank_window: torch.Tensor, window: int,
                  precision: str) -> None:
    _check(Z, bank_window, precision, False)
    if not 1 <= window:
        raise ValueError(f"window must be >= 1, got {window}")


def window_pairs(n_i: int, n_w: int, window: int) -> np.ndarray:
    """The active tiles (r, w), r <= w < min(r + window, n_w), of a window
    sweep, r-major: [n_pairs, 2] int32, C-contiguous."""
    r = np.arange(n_i)[:, None]
    w = np.arange(n_w)[None, :]
    # argwhere's result is a transposed view: the kernel reads row-major
    return np.ascontiguousarray(np.argwhere((r <= w) & (w < r + window)),
                                dtype=np.int32)


def min_dists_window_plain(Z: torch.Tensor, bank_window: torch.Tensor, *,
                           window: int, precision: str = "f32"
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The window kernel's arithmetic as plain torch ops: (row [I, W, P],
    col [W, I, Q]) on the active tiles, +inf elsewhere, as the kernel
    leaves them."""
    _check_window(Z, bank_window, window, precision)
    n_i, p, _ = Z.shape
    n_w, q, _ = bank_window.shape
    d2 = _plain_d2(Z, bank_window, precision)
    row = torch.full((n_i, n_w, p), float("inf"), dtype=torch.float32,
                     device=Z.device)
    col = torch.full((n_w, n_i, q), float("inf"), dtype=torch.float32,
                     device=Z.device)
    for r in range(n_i):
        lo, hi = r, min(r + window, n_w)
        if lo >= hi:
            continue
        t = d2(r, slice(lo, hi))  # [hi - lo, P, Q]
        row[r, lo:hi] = t.amin(dim=-1).clamp_min(0.0).sqrt()
        col[lo:hi, r] = t.amin(dim=-2).clamp_min(0.0).sqrt()
    return row, col


def work_items(pairs: np.ndarray, p: int) -> np.ndarray:
    """The kernel's work list for the (i, j) ``pairs`` [n, 2]: one item
    (i, j, slab) per pair and slab of 128 P rows, [n * ceil(P / 128), 3]
    int32, C-contiguous, in the order the blocks walk it.

    Pairs go in bands of ``_GROUP`` query images (i // _GROUP), bank image j
    next, then i, and the slabs of a pair stay adjacent: the items in
    flight at once then share few operands, which stay in L2
    (csrc/min_dists.cu, "Tile order")."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    i, j = pairs[:, 0], pairs[:, 1]
    pairs = pairs[np.lexsort((i, j, i // _GROUP))]  # last key sorts first
    n_slabs = -(-p // _BM)
    items = np.empty((len(pairs), n_slabs, 3), dtype=np.int32)
    items[:, :, :2] = pairs[:, None, :]
    items[:, :, 2] = np.arange(n_slabs)
    return items.reshape(-1, 3)


def symmetric_pairs(n: int) -> np.ndarray:
    """The pairs i <= j of the symmetric mode, [n (n + 1) / 2, 2]."""
    return np.stack(np.triu_indices(n), axis=1)


def all_pairs(n_i: int, n_j: int) -> np.ndarray:
    """Every pair (i, j) of the rectangular mode, [n_i n_j, 2]."""
    return np.stack(np.meshgrid(np.arange(n_i), np.arange(n_j),
                                indexing="ij"), axis=-1).reshape(-1, 2)


def _operands(Z: torch.Tensor, bank: torch.Tensor, precision: str,
              symmetric: bool):
    """(Z parts, a2, bank parts, b2): the kernel's bf16 operand parts, D
    zero-padded to a multiple of the 64-deep chunk (zero columns change
    neither the products nor the norms), and the f32 norms of the unpadded
    values."""
    z_parts, a2 = _prep(Z, precision)
    b_parts, b2 = (z_parts, a2) if symmetric else _prep(bank, precision)
    pad = (-Z.shape[2]) % _BK
    if pad:
        z_parts, b_parts = (tuple(F.pad(t, (0, pad)) for t in parts)
                            for parts in (z_parts, b_parts))
    return z_parts, a2.contiguous(), b_parts, b2.contiguous()


def _check_operand(name: str, t: torch.Tensor) -> None:
    """The kernel reads a [N, rows, D] bf16 operand through a TMA tensor
    map over its N * rows rows: contiguous, D a multiple of the 64-deep
    chunk, 16-byte aligned, and N * rows within int32 coordinates."""
    if t.dtype != torch.bfloat16 or t.ndim != 3 or not t.is_contiguous() \
            or t.shape[2] % _BK or t.data_ptr() % 16 \
            or t.shape[0] * t.shape[1] >= 2 ** 31:
        raise ValueError(
            f"{name}: the kernel needs a contiguous [N, rows, D] bfloat16 "
            f"with D a multiple of {_BK}, 16-byte aligned, N * rows < 2^31; "
            f"got {tuple(t.shape)} {t.dtype} strides {t.stride()} at offset "
            f"{t.data_ptr() % 16} (mod 16)")


_FN = None


def _kernel_fn():
    global _FN
    if _FN is None:
        from tpu_ac_torch.kernels.build import library

        fn = library("min_dists").tpu_ac_min_dists
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, vp, vp,
                       ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
        _FN = fn
    return _FN


# the C interface's modes (csrc/min_dists.cu)
_RECT, _SYM, _WIN = 0, 1, 2


def _launch(Z: torch.Tensor, bank: torch.Tensor, precision: str, mode: int,
            pairs: np.ndarray, out: torch.Tensor,
            col: torch.Tensor | None) -> None:
    """Prepare the bf16 operands, the norms and the work list of ``pairs``
    [n_pairs, 2] and launch the kernel on Z's device, into ``out`` (and
    ``col`` in window mode); raises if the launch fails."""
    n_i, p, _ = Z.shape
    n_j, q, _ = bank.shape
    items = work_items(pairs, p)
    if len(items) >= 2 ** 31:
        raise ValueError(f"{len(items)} work items: more than int32 counts")
    z_parts, a2, b_parts, b2 = _operands(Z, bank, precision, mode == _SYM)
    for name, parts in (("Z", z_parts), ("bank", b_parts)):
        for part, t in zip(("hi", "lo"), parts):
            _check_operand(f"{name} {part}", t)
    comp = precision != "bf16"
    dev = Z.device
    # the work list comes from the host through pinned memory: no sync
    items = torch.from_numpy(items).pin_memory().to(dev, non_blocking=True)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        rc = fn(z_parts[0].data_ptr(),
                z_parts[1].data_ptr() if comp else None,
                b_parts[0].data_ptr(),
                b_parts[1].data_ptr() if comp else None,
                a2.data_ptr(), b2.data_ptr(), items.data_ptr(),
                items.shape[0], out.data_ptr(),
                col.data_ptr() if col is not None else None,
                n_i, n_j, p, q, z_parts[0].shape[2], int(comp), mode,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"min_dists kernel launch failed: cudaError {rc}")
    # inputs freed on return go back to PyTorch's stream-ordered caching
    # allocator, which reuses them only after this stream's kernel


def _min_dists_cuda(Z: torch.Tensor, bank: torch.Tensor, precision: str,
                    symmetric: bool) -> torch.Tensor:
    global LAUNCHES
    n_i, p, _ = Z.shape
    n_j = bank.shape[0]
    dev = Z.device
    if symmetric:
        pairs = symmetric_pairs(n_i)
        out = torch.full((n_i, n_j, p), float("inf"), dtype=torch.float32,
                         device=dev)
    else:
        pairs = all_pairs(n_i, n_j)
        out = torch.empty((n_i, n_j, p), dtype=torch.float32, device=dev)
    _launch(Z, bank, precision, _SYM if symmetric else _RECT, pairs, out,
            None)
    LAUNCHES += 1
    return out


def min_dists_all_pairs(Z: torch.Tensor, bank: torch.Tensor, *,
                        precision: str = "f32",
                        symmetric: bool = False) -> torch.Tensor:
    """mins[i, j, p] = min_q ||Z[i, p] - bank[j, q]|| -> [I, J, P] f32.

    Z [I, P, D] and bank [J, Q, D]: contiguous float32 on one device.  On
    CUDA this launches the kernel (or raises); on the CPU it runs the plain
    version.
    """
    _check(Z, bank, precision, symmetric)
    if Z.device.type == "cuda":
        return _min_dists_cuda(Z, bank, precision, symmetric)
    if Z.device.type == "cpu":
        return min_dists_all_pairs_plain(Z, bank, precision=precision,
                                         symmetric=symmetric)
    raise ValueError(f"unsupported device {Z.device}")


def _min_dists_window_cuda(Z: torch.Tensor, bank_window: torch.Tensor,
                           window: int, precision: str
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    global WINDOW_LAUNCHES
    n_i, p, _ = Z.shape
    n_w, q, _ = bank_window.shape
    dev = Z.device
    row = torch.full((n_i, n_w, p), float("inf"), dtype=torch.float32,
                     device=dev)
    col = torch.full((n_w, n_i, q), float("inf"), dtype=torch.float32,
                     device=dev)
    _launch(Z, bank_window, precision, _WIN,
            window_pairs(n_i, n_w, window), row, col)
    WINDOW_LAUNCHES += 1
    return row, col


def min_dists_window(Z: torch.Tensor, bank_window: torch.Tensor, *,
                     window: int, precision: str = "f32"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Circulant-window sweep of the triangle-sharded unsupervised alpha
    (port of ``tpu_ac.kernels.distances.min_dists_window``).

    The caller owns globally contiguous query rows a = offset + r and a
    window of the (symmetric) bank whose column w holds global image
    b = (offset + 1 + w) mod N.  Tile (r, w) is active iff
    ``r <= w < r + window`` (pair distance w - r + 1 in [1, window]) and
    gives both mins[a, b] (its row-min) and mins[b, a] (its col-min).

    Returns ``(row [I, W, P], col [W, I, Q])`` f32.  Entries of inactive
    tiles are undefined (+inf here): the caller masks by the pair
    predicate.  On CUDA this launches the kernel (or raises); on the CPU
    it runs the plain version.
    """
    _check_window(Z, bank_window, window, precision)
    if Z.device.type == "cuda":
        return _min_dists_window_cuda(Z, bank_window, window, precision)
    if Z.device.type == "cpu":
        return min_dists_window_plain(Z, bank_window, window=window,
                                      precision=precision)
    raise ValueError(f"unsupported device {Z.device}")


def min_dists_to_sets(zi: torch.Tensor, bank: torch.Tensor, *,
                      precision: str = "f32") -> torch.Tensor:
    """mins[j, p] = min_q ||zi[p] - bank[j, q]|| for one query set zi
    [P, D] -> [J, P] f32 (the rectangular kernel on one query image)."""
    return min_dists_all_pairs(zi[None], bank, precision=precision)[0]
