"""Separable Gaussian blur equal to ``scipy.ndimage.gaussian_filter`` (port
of ``tpu_ac.ops.gaussian``), for the segmentation rescaler (sigma = 4).

scipy's defaults: order 0, truncate 4, radius int(truncate * sigma + 0.5),
mode "reflect": the edge sample repeats (d c b a | a b c d | d c b a),
numpy's "symmetric" and ``jnp.pad(mode="symmetric")`` in ``tpu_ac``.
torch's ``F.pad(mode="reflect")`` is numpy's "reflect" (no repeat), a
different padding, so the mirror indices are built here; they repeat with
period 2n, which also holds where the radius exceeds the side n.  Each
axis is a sum of 2 * radius + 1 shifted, weighted copies, taps in order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    phi /= phi.sum()
    # scipy correlates with the reversed kernel; symmetric here, so no-op
    return phi.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _mirror_index(n: int, radius: int) -> np.ndarray:
    """Source index of each position -radius .. n + radius - 1 of the
    scipy-"reflect" extension of a side of n samples."""
    i = np.arange(-radius, n + radius) % (2 * n)
    return np.where(i >= n, 2 * n - 1 - i, i)


def _blur_axis(x: torch.Tensor, kernel: np.ndarray, axis: int
               ) -> torch.Tensor:
    n = x.shape[axis]
    radius = (len(kernel) - 1) // 2
    idx = torch.from_numpy(_mirror_index(n, radius)).to(x.device)
    xp = torch.index_select(x, axis, idx)
    out = torch.zeros_like(x)
    for t, w in enumerate(kernel.tolist()):  # the f32 weights, exactly
        out.add_(xp.narrow(axis, t, n), alpha=w)
    return out


def gaussian_blur(x: torch.Tensor, sigma: float,
                  truncate: float = 4.0) -> torch.Tensor:
    """Gaussian blur over the last two axes (scipy.ndimage.gaussian_filter
    of each [H, W] plane)."""
    kernel = _gaussian_kernel(sigma, truncate)
    out = _blur_axis(x, kernel, x.ndim - 2)
    return _blur_axis(out, kernel, x.ndim - 1)
