"""torch-exact spatial resampling from static tables (port of
``tpu_ac.ops.interpolate``).

Bilinear (align_corners=False) aligns coarser feature grids; bicubic with
a ``scale_factor`` (a = -0.75) resizes the ViT positional embedding;
nearest upsamples attention and alpha maps to the image.  The index/weight
tables are the ``tpu_ac`` ones, so both packages resample with identical
taps: half-pixel centres, ``scale = 1/scale_factor`` when a scale factor
is given, negative source clamped for linear but not cubic, per-tap border
clamping for cubic; nearest takes ``floor(out * scale)``, clamped.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _source_coords(out_size: int, in_size: int, scale_factor: float | None,
                   *, cubic: bool) -> np.ndarray:
    scale = 1.0 / scale_factor if scale_factor is not None \
        else in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    if not cubic:
        src = np.maximum(src, 0.0)
    return src


@functools.lru_cache(maxsize=256)
def _linear_tables(in_size: int, out_size: int, scale_factor: float | None):
    """(idx [out, 2], w [out, 2]) for 1-D linear resampling."""
    src = _source_coords(out_size, in_size, scale_factor, cubic=False)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    frac = (src - i0).astype(np.float32)
    idx = np.stack([i0, i1], axis=-1)
    w = np.stack([1.0 - frac, frac], axis=-1).astype(np.float32)
    return idx, w


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution weights for the 4 taps at fractional offset t."""
    t = t.astype(np.float64)

    def w1(x):  # |x| <= 1
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def w2(x):  # 1 < |x| < 2
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a

    return np.stack([w2(t + 1.0), w1(t), w1(1.0 - t), w2(2.0 - t)], axis=-1)


@functools.lru_cache(maxsize=256)
def _cubic_tables(in_size: int, out_size: int, scale_factor: float | None):
    """(idx [out, 4], w [out, 4]) for 1-D bicubic resampling."""
    src = _source_coords(out_size, in_size, scale_factor, cubic=True)
    i0 = np.floor(src).astype(np.int64)
    taps = np.clip(np.stack([i0 - 1, i0, i0 + 1, i0 + 2], axis=-1),
                   0, in_size - 1)
    return taps, _cubic_kernel(src - i0).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _nearest_tables(in_size: int, out_size: int,
                    scale_factor: float | None) -> np.ndarray:
    """[out] source index of each output row for 1-D nearest resampling."""
    scale = 1.0 / scale_factor if scale_factor is not None \
        else in_size / out_size
    idx = np.floor(np.arange(out_size, dtype=np.float64) * scale)
    return np.minimum(idx, in_size - 1).astype(np.int64)


@functools.lru_cache(maxsize=256)
def _device_index(in_size: int, out_size: int, scale_factor: float | None,
                  device: torch.device) -> torch.Tensor:
    """``_nearest_tables`` on ``device``, copied there once."""
    return torch.from_numpy(
        _nearest_tables(in_size, out_size, scale_factor)).to(device)


@functools.lru_cache(maxsize=256)
def _device_tables(tables, in_size: int, out_size: int,
                   scale_factor: float | None, device: torch.device):
    """``tables``' indices and weights, one tensor a tap, and the dense
    [out, in] matrix of the taps' weights summed per source (the
    backward's), on ``device``, copied there once: a copy from pageable
    host memory to the card waits for the card's queue to drain."""
    idx, w = tables(in_size, out_size, scale_factor)
    m = np.zeros((idx.shape[0], in_size), np.float32)
    np.add.at(m, (np.arange(idx.shape[0])[:, None], idx), w)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ([put(idx[:, k]) for k in range(idx.shape[1])],
            [put(w[:, k]) for k in range(idx.shape[1])], put(m))


def _resample_taps(x: torch.Tensor, axis: int, tabs) -> torch.Tensor:
    """out[o] = sum_k w[o, k] * x[idx[o, k]] along ``axis``, taps added in
    order."""
    idx, w, _ = tabs
    shape = [1] * x.ndim
    shape[axis] = -1
    out = None
    for i_k, w_k in zip(idx, w):
        t = torch.index_select(x, axis, i_k) * w_k.to(x.dtype).reshape(shape)
        out = t if out is None else out + t
    return out


class _ResampleAxis(torch.autograd.Function):
    """``_resample_taps`` with a deterministic backward.

    The autograd of ``index_select`` is ``index_add_``, which sums with
    atomics on the card, so two runs of one train step would differ in the
    last bits of the gradient of whatever was resampled (the ViT's
    pos_embed, for the local crops).  The resample is linear, out = M x
    along ``axis`` with M [out, in] the taps' weights summed per source,
    so the backward is the product Mᵀ g, in a fixed order.
    """

    @staticmethod
    def forward(ctx, x, axis, tabs):
        ctx.axis, ctx.m = axis, tabs[2]
        return _resample_taps(x, axis, tabs)

    @staticmethod
    def backward(ctx, g):
        gx = torch.movedim(torch.movedim(g, ctx.axis, -1) @ ctx.m.to(g.dtype),
                           -1, ctx.axis)
        return gx, None, None


def _resample_axis(x: torch.Tensor, axis: int, tables, out_size: int,
                   scale_factor: float | None) -> torch.Tensor:
    tabs = _device_tables(tables, x.shape[axis], out_size, scale_factor,
                          x.device)
    if torch.is_grad_enabled() and x.requires_grad:
        return _ResampleAxis.apply(x, axis, tabs)
    return _resample_taps(x, axis, tabs)


def interpolate_bilinear(x: torch.Tensor, size: tuple[int, int],
                         scale_factor: tuple[float, float] | None = None
                         ) -> torch.Tensor:
    """F.interpolate(mode="bilinear", align_corners=False), last 2 axes."""
    sf_h, sf_w = scale_factor if scale_factor is not None else (None, None)
    out = _resample_axis(x, x.ndim - 2, _linear_tables, size[0], sf_h)
    return _resample_axis(out, x.ndim - 1, _linear_tables, size[1], sf_w)


def interpolate_bicubic(x: torch.Tensor, size: tuple[int, int] | None = None,
                        scale_factor: tuple[float, float] | None = None
                        ) -> torch.Tensor:
    """F.interpolate(mode="bicubic", align_corners=False), last 2 axes."""
    h, w_in = x.shape[-2], x.shape[-1]
    if size is None:
        if scale_factor is None:
            raise ValueError("interpolate_bicubic needs size or scale_factor")
        size = (int(np.floor(h * scale_factor[0])),
                int(np.floor(w_in * scale_factor[1])))
    sf_h, sf_w = scale_factor if scale_factor is not None else (None, None)
    out = _resample_axis(x, x.ndim - 2, _cubic_tables, size[0], sf_h)
    return _resample_axis(out, x.ndim - 1, _cubic_tables, size[1], sf_w)


def interpolate_nearest(x: torch.Tensor, size: tuple[int, int] | None = None,
                        scale_factor: tuple[float, float] | None = None
                        ) -> torch.Tensor:
    """F.interpolate(mode="nearest") over the last 2 axes, with
    ``tpu_ac``'s index tables (a gather: exact for any dtype)."""
    h, w_in = x.shape[-2], x.shape[-1]
    if size is None:
        if scale_factor is None:
            raise ValueError("interpolate_nearest needs size or scale_factor")
        size = (int(np.floor(h * scale_factor[0])),
                int(np.floor(w_in * scale_factor[1])))
    sf_h, sf_w = scale_factor if scale_factor is not None else (None, None)
    out = torch.index_select(x, x.ndim - 2,
                             _device_index(h, size[0], sf_h, x.device))
    return torch.index_select(out, x.ndim - 1,
                              _device_index(w_in, size[1], sf_w, x.device))
