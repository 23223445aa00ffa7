"""The precision control: a matmul operand rounded to fp8 (e4m3) with one
scale a tensor (its largest magnitude to 448, e4m3's largest value) and
used in f32: the reference computed one precision below the bf16 that the
configurations state."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    scale = E4M3_MAX / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def exact(x: torch.Tensor) -> torch.Tensor:
    return x
