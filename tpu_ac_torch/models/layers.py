"""Layers shared by the convolutional families of ``tpu_ac_torch.models``.

``FrozenBN`` is inference BatchNorm2d whose four tensors are buffers (no
``num_batches_tracked``), as ``tpu_ac`` folds running statistics.
``Conv2d`` is ``nn.Conv2d`` that can also pad TensorFlow's "SAME" way:
asymmetric, bottom/right-heavy at stride 2 (``tf_same_pads``), which
torch's ``padding="same"`` refuses for a strided conv, so the input is
padded with zeros first.  The families' pools are ``F.max_pool2d`` (its
padding is -inf, as ``tpu_ac``'s ``reduce_window`` max) and
``F.avg_pool2d`` with the ``count_include_pad`` each upstream model uses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_ac_torch.ops.linear import bn_inference_nchw


def tf_same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TensorFlow SAME padding (lo, hi) of one spatial axis (port of
    ``tpu_ac.ops.pooling.tf_same_pads``): k=3, s=2 on an even size pads
    (0, 1) where the symmetric k//2 pads (1, 1)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_tf_same(x: torch.Tensor, kh: int, kw: int, stride: int,
                value: float = 0.0) -> torch.Tensor:
    """Pad [B, C, H, W] for a VALID window op to act as TF SAME."""
    top, bottom = tf_same_pads(x.shape[2], kh, stride)
    left, right = tf_same_pads(x.shape[3], kw, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class FrozenBN(nn.Module):
    """Inference BatchNorm2d: weight, bias and running stats as buffers, no
    ``num_batches_tracked``."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        for name, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((channels,), fill))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bn_inference_nchw(x, self.weight, self.bias,
                                 self.running_mean, self.running_var,
                                 self.eps)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (no bias unless asked) with ``tf_same``: TF "SAME"
    padding worked out from each input's size instead of ``padding``."""

    def __init__(self, in_c: int, out_c: int, k, stride: int = 1,
                 padding=0, groups: int = 1, bias: bool = False,
                 tf_same: bool = False):
        super().__init__(in_c, out_c, k, stride=stride,
                         padding=0 if tf_same else padding, groups=groups,
                         bias=bias)
        self.tf_same = tf_same

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tf_same:
            x = pad_tf_same(x, *self.kernel_size, self.stride[0])
        return super().forward(x)
