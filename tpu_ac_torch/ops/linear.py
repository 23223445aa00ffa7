"""Shared torch-layout dense/BN primitives (port of ``tpu_ac.ops.linear``).

``torch_linear`` is ``x @ W^T + b`` over torch-layout (out, in) weights;
``bn_inference_nchw`` is folded inference BatchNorm2d on [B, C, H, W] with
running statistics.  ``tpu_ac``'s takes a params dict and a key prefix;
here the four tensors come from the module that holds them
(``models.layers.FrozenBN``).  Precision follows the enclosing
``tpu_ac_torch.device.precision_scope``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def torch_linear(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor | None) -> torch.Tensor:
    return F.linear(x, w, b)


def bn_inference_nchw(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, running_mean: torch.Tensor,
                      running_var: torch.Tensor, eps: float) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * weight + bias per channel, as one
    ``F.batch_norm`` in inference mode (one fused pass on the card)."""
    return F.batch_norm(x, running_mean, running_var, weight, bias,
                        training=False, eps=eps)
