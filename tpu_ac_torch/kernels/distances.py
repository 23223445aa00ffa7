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
(``tpu_ac_torch.distributed``).  The TPU tiling knobs (``d_tile``, ``ti``,
``interpret``) are not carried.

The three modes are ``torch.library`` custom ops of the ``tpu_ac_torch``
namespace (``min_dists_symmetric``, ``min_dists_rectangular``,
``min_dists_window``), so that a ``torch.export`` program holds them as
nodes (``tpu_ac_torch.utils.export``).  The live sweep calls the same ops.
The valid counts are 0-d int64 CPU tensors (the window op takes a
validity mask of its rows and one of its columns, 1-d bool CPU tensors),
read on the host to build the kernel's pair list: one program serves every
category size up to its padded capacity, and no count waits for the card.
Pairs with an invalid image are not computed and stay +inf; the kernel
reads the operands of the valid images only.  On a CUDA tensor an op
launches the kernel or raises; on a CPU tensor it runs the plain version
(``*_plain``), the same arithmetic as plain torch ops (bf16 parts upcast to
f32, f32 matmul; products of bf16 values are exact in f32, so only the
summation order differs from the kernel).

This module imports only torch, numpy and the standard library: an export
artifact carries its source, and ``scripts/serving_host_torch.py`` loads it
from there under a private name, without tpu_ac_torch, after pointing
``LIBRARY_PATH`` at the kernel library.  Where ``LIBRARY_PATH`` is None the
package's ``kernels/build.py`` compiles ``csrc/min_dists.cu`` at first use.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "bf16c", "bf16")
NAMESPACE = "tpu_ac_torch"

# kernel launches (CUDA tensors only) of the symmetric and rectangular ops
# and of the window op, and the op calls that ran the plain version (CPU
# tensors; the ``*_plain`` functions called directly are not counted)
LAUNCHES = 0
WINDOW_LAUNCHES = 0
PLAIN_CALLS = 0

# the kernel library to load; None: the package builds csrc/min_dists.cu
LIBRARY_PATH: str | None = None

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
    if Z.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {Z.device}")
    if not (Z.is_contiguous() and bank.is_contiguous()):
        raise ValueError("Z and bank must be contiguous")


def count_tensor(n, default: int) -> torch.Tensor:
    """A valid count as the ops take it: a 0-d int64 CPU tensor (``n`` an
    int, such a tensor, or None for ``default``)."""
    if isinstance(n, torch.Tensor):
        return n
    return torch.tensor(default if n is None else int(n), dtype=torch.int64)


def _host_count(t: torch.Tensor, limit: int, name: str) -> int:
    """The value of a count tensor, checked: 0-d, integral, on the CPU (a
    CUDA count would make the host wait for the card), in [0, limit]."""
    if t.ndim != 0 or t.dtype.is_floating_point or t.device.type != "cpu":
        raise ValueError(f"{name}: want a 0-d integer CPU tensor; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    v = int(t)
    if not 0 <= v <= limit:
        raise ValueError(f"{name} = {v} outside [0, {limit}]")
    return v


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
    against bank images js (a slice or an index tensor), in the kernel's
    arithmetic."""
    z_parts, a2 = _prep(Z, precision)
    b_parts, b2 = _prep(bank, precision)
    zf = [t.to(torch.float32) for t in z_parts]
    bt = [t.to(torch.float32).transpose(1, 2) for t in b_parts]  # [J, D, Q]
    terms = [(0, 0)] if precision == "bf16" else [(0, 0), (0, 1), (1, 0)]

    def d2(i: int, js) -> torch.Tensor:
        acc = None
        for za, bb in terms:
            t = torch.matmul(zf[za][i], bt[bb][js])  # [J', P, Q]
            acc = t if acc is None else acc + t
        return a2[i][None, :, None] - 2.0 * acc + b2[js][:, None, :]

    return d2


def min_dists_all_pairs_plain(Z: torch.Tensor, bank: torch.Tensor, *,
                              precision: str = "f32",
                              symmetric: bool = False, n_valid=None,
                              n_bank_valid=None) -> torch.Tensor:
    """The kernel's arithmetic as plain torch ops, one query image at a
    time (bounded memory).  ``symmetric`` only validates: every pair is
    computed directly.  Rows at or past ``n_valid`` and bank images at or
    past ``n_bank_valid`` (ints, default all; ``n_valid`` for both when
    symmetric) stay +inf."""
    _check(Z, bank, precision, symmetric)
    nv = Z.shape[0] if n_valid is None else int(n_valid)
    nbv = nv if symmetric else (
        bank.shape[0] if n_bank_valid is None else int(n_bank_valid))
    d2 = _plain_d2(Z, bank, precision)
    out = torch.full((Z.shape[0], bank.shape[0], Z.shape[1]), float("inf"),
                     dtype=torch.float32, device=Z.device)
    for i in range(nv):
        out[i, :nbv] = d2(i, slice(0, nbv)).amin(dim=-1).clamp_min(0.0) \
            .sqrt()
    return out


def _check_window(Z: torch.Tensor, bank_window: torch.Tensor, window: int,
                  precision: str) -> None:
    _check(Z, bank_window, precision, False)
    if not 1 <= window:
        raise ValueError(f"window must be >= 1, got {window}")


def _host_mask(t, n: int, name: str) -> np.ndarray | None:
    """The value of a validity mask, checked: None, or a 1-d bool CPU
    tensor of length ``n`` (a CUDA mask would make the host wait for the
    card)."""
    if t is None:
        return None
    if t.shape != (n,) or t.dtype != torch.bool or t.device.type != "cpu":
        raise ValueError(f"{name}: want a [{n}] bool CPU tensor; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.numpy()


def window_pairs(n_i: int, n_w: int, window: int,
                 row_valid: np.ndarray | None = None,
                 col_valid: np.ndarray | None = None) -> np.ndarray:
    """The active tiles (r, w), r <= w < min(r + window, n_w), of a window
    sweep, r-major: [n_pairs, 2] int32, C-contiguous.  With ``row_valid``
    [n_i] / ``col_valid`` [n_w] (bool), a tile is active only if its row
    and its column are valid."""
    r = np.arange(n_i)[:, None]
    w = np.arange(n_w)[None, :]
    act = (r <= w) & (w < r + window)
    if row_valid is not None:
        act &= np.asarray(row_valid, bool)[:, None]
    if col_valid is not None:
        act &= np.asarray(col_valid, bool)[None, :]
    # argwhere's result is a transposed view: the kernel reads row-major
    return np.ascontiguousarray(np.argwhere(act), dtype=np.int32)


def min_dists_window_plain(Z: torch.Tensor, bank_window: torch.Tensor, *,
                           window: int, precision: str = "f32",
                           row_valid: torch.Tensor | None = None,
                           col_valid: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The window kernel's arithmetic as plain torch ops: (row [I, W, P],
    col [W, I, Q]) on the active tiles (``window_pairs``), +inf elsewhere,
    as the kernel leaves them."""
    _check_window(Z, bank_window, window, precision)
    n_i, p, _ = Z.shape
    n_w, q, _ = bank_window.shape
    pairs = window_pairs(n_i, n_w, window,
                         _host_mask(row_valid, n_i, "row_valid"),
                         _host_mask(col_valid, n_w, "col_valid"))
    d2 = _plain_d2(Z, bank_window, precision)
    row = torch.full((n_i, n_w, p), float("inf"), dtype=torch.float32,
                     device=Z.device)
    col = torch.full((n_w, n_i, q), float("inf"), dtype=torch.float32,
                     device=Z.device)
    for r in range(n_i):
        ws = torch.from_numpy(pairs[pairs[:, 0] == r, 1].astype(np.int64)) \
            .to(Z.device)
        if not len(ws):
            continue
        t = d2(r, ws)  # [len(ws), P, Q]
        row[r, ws] = t.amin(dim=-1).clamp_min(0.0).sqrt()
        col[ws, r] = t.amin(dim=-2).clamp_min(0.0).sqrt()
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
        if LIBRARY_PATH is not None:
            lib = ctypes.CDLL(LIBRARY_PATH)
        else:
            from tpu_ac_torch.kernels.build import library

            lib = library("min_dists")
        fn = lib.tpu_ac_min_dists
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
            col: torch.Tensor | None) -> bool:
    """Prepare the bf16 operands, the norms and the work list of ``pairs``
    [n_pairs, 2] and launch the kernel on Z's device, into ``out`` (and
    ``col`` in window mode); raises if the launch fails.  False, and no
    launch, when there is no pair."""
    n_i, p, _ = Z.shape
    n_j, q, _ = bank.shape
    items = work_items(pairs, p)
    if not len(items):
        return False
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
    return True


def _output(shape, inf: bool, device) -> torch.Tensor:
    """An f32 output of the kernel: +inf-filled, or left empty."""
    if inf:
        return torch.full(shape, float("inf"), dtype=torch.float32,
                          device=device)
    return torch.empty(shape, dtype=torch.float32, device=device)


def _pairs_op(Z: torch.Tensor, bank: torch.Tensor, nv: int, nbv: int,
              precision: str, symmetric: bool) -> torch.Tensor:
    """The body of the symmetric and rectangular ops, on valid counts."""
    global LAUNCHES, PLAIN_CALLS
    if Z.device.type == "cpu":
        PLAIN_CALLS += 1
        return min_dists_all_pairs_plain(Z, bank, precision=precision,
                                         symmetric=symmetric, n_valid=nv,
                                         n_bank_valid=nbv)
    shape = (Z.shape[0], bank.shape[0], Z.shape[1])
    # the symmetric kernel min-merges its col-mins into an output that
    # starts at +inf; the rectangular one writes every entry of its pairs.
    # Padded, the kernel reads and writes the valid images only.
    if (nv, nbv) == shape[:2]:
        out = dst = _output(shape, symmetric, Z.device)
    else:
        out = _output(shape, True, Z.device)
        dst = _output((nv, nbv, shape[2]), symmetric, Z.device)
    zv = Z[:nv]
    pairs = symmetric_pairs(nv) if symmetric else all_pairs(nv, nbv)
    if _launch(zv, zv if symmetric else bank[:nbv], precision,
               _SYM if symmetric else _RECT, pairs, dst, None):
        LAUNCHES += 1
    if dst is not out:
        out[:nv, :nbv] = dst
    return out


def _symmetric_op(z: torch.Tensor, n_valid: torch.Tensor,
                  precision: str) -> torch.Tensor:
    _check(z, z, precision, True)
    nv = _host_count(n_valid, z.shape[0], "n_valid")
    return _pairs_op(z, z, nv, nv, precision, True)


def _rectangular_op(z: torch.Tensor, bank: torch.Tensor,
                    n_valid: torch.Tensor, n_bank_valid: torch.Tensor,
                    precision: str) -> torch.Tensor:
    _check(z, bank, precision, False)
    return _pairs_op(z, bank, _host_count(n_valid, z.shape[0], "n_valid"),
                     _host_count(n_bank_valid, bank.shape[0],
                                 "n_bank_valid"), precision, False)


def _window_op(z: torch.Tensor, bank_window: torch.Tensor, window: int,
               row_valid: torch.Tensor | None,
               col_valid: torch.Tensor | None,
               precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    global WINDOW_LAUNCHES, PLAIN_CALLS
    _check_window(z, bank_window, window, precision)
    n_i, p, _ = z.shape
    n_w, q, _ = bank_window.shape
    pairs = window_pairs(n_i, n_w, window,
                         _host_mask(row_valid, n_i, "row_valid"),
                         _host_mask(col_valid, n_w, "col_valid"))
    if z.device.type == "cpu":
        PLAIN_CALLS += 1
        return min_dists_window_plain(z, bank_window, window=window,
                                      precision=precision,
                                      row_valid=row_valid,
                                      col_valid=col_valid)
    row = torch.full((n_i, n_w, p), float("inf"), dtype=torch.float32,
                     device=z.device)
    col = torch.full((n_w, n_i, q), float("inf"), dtype=torch.float32,
                     device=z.device)
    if _launch(z, bank_window, precision, _WIN, pairs, row, col):
        WINDOW_LAUNCHES += 1
    return row, col


def _define_ops() -> None:
    """Register the three ops and their shape functions (once a process:
    a second copy of this module, loaded under another name, finds them
    registered and leaves them to the first)."""
    lib = torch.library
    sym = lib.custom_op(f"{NAMESPACE}::min_dists_symmetric",
                        mutates_args=())(_symmetric_op)
    rect = lib.custom_op(f"{NAMESPACE}::min_dists_rectangular",
                         mutates_args=())(_rectangular_op)
    win = lib.custom_op(f"{NAMESPACE}::min_dists_window",
                        mutates_args=())(_window_op)

    @sym.register_fake
    def _(z, n_valid, precision):
        return z.new_empty((z.shape[0], z.shape[0], z.shape[1]))

    @rect.register_fake
    def _(z, bank, n_valid, n_bank_valid, precision):
        return z.new_empty((z.shape[0], bank.shape[0], z.shape[1]))

    @win.register_fake
    def _(z, bank_window, window, row_valid, col_valid, precision):
        n_i, n_w = z.shape[0], bank_window.shape[0]
        return (z.new_empty((n_i, n_w, z.shape[1])),
                z.new_empty((n_w, n_i, bank_window.shape[1])))


if not hasattr(getattr(torch.ops, NAMESPACE), "min_dists_window"):
    _define_ops()


def min_dists_all_pairs(Z: torch.Tensor, bank: torch.Tensor, *,
                        precision: str = "f32", symmetric: bool = False,
                        n_valid=None, n_bank_valid=None) -> torch.Tensor:
    """mins[i, j, p] = min_q ||Z[i, p] - bank[j, q]|| -> [I, J, P] f32.

    Z [I, P, D] and bank [J, Q, D]: contiguous float32 on one device.
    ``n_valid`` / ``n_bank_valid`` (ints or 0-d int64 CPU tensors; default
    all; symmetric takes ``n_valid`` for both): pairs with a row at or past
    them are not computed and stay +inf.  On CUDA this launches the kernel
    (or raises); on the CPU it runs the plain version.
    """
    _check(Z, bank, precision, symmetric)
    ops = getattr(torch.ops, NAMESPACE)
    nv = count_tensor(n_valid, Z.shape[0])
    if symmetric:
        return ops.min_dists_symmetric(Z, nv, precision)
    return ops.min_dists_rectangular(Z, bank, nv,
                                     count_tensor(n_bank_valid,
                                                  bank.shape[0]), precision)


def min_dists_window(Z: torch.Tensor, bank_window: torch.Tensor, *,
                     window: int, precision: str = "f32",
                     row_valid: torch.Tensor | None = None,
                     col_valid: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Circulant-window sweep of the triangle-sharded unsupervised alpha
    (port of ``tpu_ac.kernels.distances.min_dists_window``).

    The caller owns globally contiguous query rows a = offset + r and a
    window of the (symmetric) bank whose column w holds global image
    b = (offset + 1 + w) mod N.  Tile (r, w) is active iff
    ``r <= w < r + window`` (pair distance w - r + 1 in [1, window]) and
    gives both mins[a, b] (its row-min) and mins[b, a] (its col-min).
    ``row_valid`` [I] and ``col_valid`` [W] (1-d bool CPU tensors; default
    all) leave out the tiles of an invalid row or column too.

    Returns ``(row [I, W, P], col [W, I, Q])`` f32.  Entries of inactive
    tiles are undefined (+inf here): the caller masks by the pair
    predicate.  On CUDA this launches the kernel (or raises); on the CPU
    it runs the plain version.
    """
    _check_window(Z, bank_window, window, precision)
    return getattr(torch.ops, NAMESPACE).min_dists_window(
        Z, bank_window, window, row_valid, col_valid, precision)


def min_dists_to_sets(zi: torch.Tensor, bank: torch.Tensor, *,
                      precision: str = "f32") -> torch.Tensor:
    """mins[j, p] = min_q ||zi[p] - bank[j, q]|| for one query set zi
    [P, D] -> [J, P] f32 (the rectangular kernel on one query image)."""
    return min_dists_all_pairs(zi[None], bank, precision=precision)[0]
