"""ctypes bindings of the native host kernels (port of ``tpu_ac.native``):
Hungarian assignment, threaded exact k-NN and greedy coreset selection.

The source is the repository's ``native/tpu_ac_native.cpp``, which this
module reads and never writes next to: at first use the host's ``g++``
builds it with the flags of ``native/Makefile`` into
``build/tpu_ac_torch/libtpu_ac_native-<hash>.so`` under the repository
root, keyed by a hash of the source and the flags (as ``kernels/build.py``
keys the CUDA libraries).  These are host functions, not device kernels:
where no compiler is found the scipy/numpy fallbacks of ``tpu_ac`` run
instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess

import numpy as np

LOGGER = logging.getLogger(__name__)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "native", "tpu_ac_native.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "tpu_ac_torch")
# native/Makefile's CXXFLAGS (-march=native where the compiler takes it)
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared"]

_lib: ctypes.CDLL | None = None
_lib_failed = False


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


def _flags(cxx: str) -> list[str]:
    march = subprocess.run([cxx, "-march=native", "-E", "-x", "c++",
                            os.devnull], capture_output=True).returncode == 0
    return CXX_FLAGS + (["-march=native"] if march else [])


def library_path(cxx: str) -> str:
    """Where the library built by ``cxx`` lives: keyed by the source, the
    compiler and the flags."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join([cxx, *_flags(cxx)]).encode())
    return os.path.join(BUILD_DIR,
                        f"libtpu_ac_native-{h.hexdigest()[:16]}.so")


def _build() -> str | None:
    cxx = _compiler()
    if cxx is None or not os.path.exists(SOURCE):
        LOGGER.warning("no C++ compiler (or no %s): using python fallbacks",
                       SOURCE)
        return None
    so = library_path(cxx)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *_flags(cxx), SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        LOGGER.warning("native build failed (%s); using python fallbacks",
                       proc.stderr.strip()[-500:])
        return None
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native library, or None."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    so = _build()
    if so is None:
        _lib_failed = True
        return None
    lib = ctypes.CDLL(so)
    lib.tpu_ac_hungarian.restype = ctypes.c_double
    lib.tpu_ac_hungarian.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    lib.tpu_ac_knn_l2.restype = None
    lib.tpu_ac_knn_l2.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    lib.tpu_ac_greedy_coreset.restype = None
    lib.tpu_ac_greedy_coreset.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    _lib = lib
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def hungarian(cost: np.ndarray) -> tuple[np.ndarray, float]:
    """Min-cost assignment on a square cost matrix: (assignment[row] = col,
    total cost).  Native O(n^3) JV solver; scipy fallback."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n = cost.shape[0]
    if cost.shape != (n, n):
        raise ValueError(f"cost must be square, got {cost.shape}")
    lib = get_lib()
    if lib is None:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(cost)
        out = np.empty(n, np.int32)
        out[rows] = cols
        return out, float(cost[rows, cols].sum())
    assignment = np.empty(n, np.int32)
    total = lib.tpu_ac_hungarian(_ptr(cost, ctypes.c_double), n,
                                 _ptr(assignment, ctypes.c_int32))
    return assignment, float(total)


def knn_l2(query: np.ndarray, bank: np.ndarray, k: int,
           n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Host exact k-NN (squared L2, ascending), FAISS IndexFlatL2.search:
    threaded C++, numpy fallback."""
    query = np.ascontiguousarray(query, np.float32)
    bank = np.ascontiguousarray(bank, np.float32)
    m, d = query.shape
    n = bank.shape[0]
    k = min(k, n)
    lib = get_lib()
    if lib is None:
        d2 = ((query[:, None] - bank[None]) ** 2).sum(-1)
        idx = np.argsort(d2, axis=1)[:, :k]
        return np.take_along_axis(d2, idx, 1).astype(np.float32), \
            idx.astype(np.int32)
    out_d2 = np.empty((m, k), np.float32)
    out_idx = np.empty((m, k), np.int32)
    lib.tpu_ac_knn_l2(_ptr(query, ctypes.c_float), m,
                      _ptr(bank, ctypes.c_float), n, d, k,
                      _ptr(out_d2, ctypes.c_float),
                      _ptr(out_idx, ctypes.c_int32), n_threads)
    return out_d2, out_idx


def greedy_coreset(feats: np.ndarray, init_anchor: np.ndarray,
                   n_select: int, n_threads: int = 0) -> np.ndarray:
    """Host greedy coreset selection (threaded relax step); numpy
    fallback."""
    feats = np.ascontiguousarray(feats, np.float32)
    anchor = np.ascontiguousarray(init_anchor, np.float32).copy()
    n, d = feats.shape
    selected = np.empty(n_select, np.int32)
    lib = get_lib()
    if lib is None:
        for s in range(n_select):
            best = int(np.argmax(anchor))
            selected[s] = best
            dist = np.sqrt(((feats - feats[best]) ** 2).sum(-1))
            anchor = np.minimum(anchor, dist)
        return selected
    lib.tpu_ac_greedy_coreset(_ptr(feats, ctypes.c_float), n, d,
                              _ptr(anchor, ctypes.c_float), n_select,
                              _ptr(selected, ctypes.c_int32), n_threads)
    return selected
