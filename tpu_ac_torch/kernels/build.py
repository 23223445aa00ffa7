"""Build the CUDA sources of ``tpu_ac_torch/csrc`` and load them.

At first use each ``csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface,
``build/tpu_ac_torch/lib<name>-<hash>.so`` under the repository root,
keyed by a hash of the source, the shared headers ``csrc/*.cuh`` it may
include and the flags; the libraries are loaded with
``ctypes``.  All sources compile at once, one ``nvcc`` each.  Nothing else
is built and nothing is downloaded; a failed build raises.

The flags need nothing beyond the CUDA toolkit: ``min_dists.cu`` builds its
TMA tensor maps with the driver API's ``cuTensorMapEncodeTiled``, which it
reaches at run time through the runtime's ``cudaGetDriverEntryPoint``
(``...ByVersion`` from CUDA 12.5), so the libraries link no ``-lcuda``;
no CUTLASS header is used.  ``-Xptxas -v`` keeps ptxas's report of each
kernel instance (registers, shared memory, spills, wgmma warnings) in
``BUILD_LOG``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)),
                         "build", "tpu_ac_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# name -> nvcc's stderr (ptxas register/shared-memory report) of a build
# made in this process
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of tpu_ac_torch "
                       "build only where the CUDA toolkit is installed")


def _library_path(src: str) -> str:
    h = hashlib.sha256()
    for path in [src, *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` not yet built, all nvcc processes at
    once; returns {name: library path}."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths, procs = {}, {}
    for src in sources:
        name = os.path.splitext(os.path.basename(src))[0]
        paths[name] = so = _library_path(src)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, err = proc.communicate()
        BUILD_LOG[name] = out + err
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first
    use)."""
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            if name not in paths:
                raise KeyError(f"no csrc/{name}.cu")
            _LIBS[name] = ctypes.CDLL(paths[name])
        return _LIBS[name]
