"""DINO projection head as an ``nn.Module`` (port of
``tpu_ac.models.dino_head``; vision_transformer.py:257-291).

MLP (Linear-GELU-[Linear-GELU]-Linear) -> L2 normalize -> weight-normed
final linear, ``weight_g * weight_v / ||weight_v||`` row by row.  The
``state_dict`` keys are the torch ``nn.Sequential`` ones (``mlp.{0,2,4}.*``,
``last_layer.weight_g``, ``last_layer.weight_v``), the keys of ``tpu_ac``'s
params dict, so one set of arrays feeds both packages.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_ac_torch.ops.normalize import l2_normalize


def init_dino_head_params(seed: int, in_dim: int, out_dim: int,
                          nlayers: int = 3, hidden_dim: int = 2048,
                          bottleneck_dim: int = 256
                          ) -> dict[str, np.ndarray]:
    """Seeded init; the same numpy draws in the same order as
    ``tpu_ac.models.dino_head.init_dino_head_params``, so the arrays are
    bit-identical."""
    rng = np.random.default_rng(seed)

    def tn(shape):
        std = 0.02
        x = rng.standard_normal(shape) * std
        return np.clip(x, -2 * std, 2 * std).astype(np.float32)

    p: dict[str, np.ndarray] = {}
    nlayers = max(nlayers, 1)
    if nlayers == 1:
        p["mlp.weight"] = tn((bottleneck_dim, in_dim))
        p["mlp.bias"] = np.zeros((bottleneck_dim,), np.float32)
    else:
        dims = [in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
        for li in range(nlayers):
            p[f"mlp.{2 * li}.weight"] = tn((dims[li + 1], dims[li]))
            p[f"mlp.{2 * li}.bias"] = np.zeros((dims[li + 1],), np.float32)
    p["last_layer.weight_g"] = np.ones((out_dim, 1), np.float32)
    p["last_layer.weight_v"] = (
        rng.standard_normal((out_dim, bottleneck_dim)) /
        math.sqrt(bottleneck_dim)).astype(np.float32)
    return p


class _WeightNormLinear(nn.Module):
    """Bias-free linear with the weight ``weight_g * weight_v /
    ||weight_v||`` (torch's old ``weight_norm`` parameterization)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.empty(d_out, 1))
        self.weight_v = nn.Parameter(torch.empty(d_out, d_in))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.weight_v
        w = self.weight_g * v / torch.linalg.vector_norm(v, dim=1,
                                                         keepdim=True)
        return F.linear(x, w)


class DINOHead(nn.Module):
    """Parameters are allocated uninitialized: load them with
    ``load_state_dict`` (e.g. from ``init_dino_head_params``)."""

    def __init__(self, in_dim: int, out_dim: int, nlayers: int = 3,
                 hidden_dim: int = 2048, bottleneck_dim: int = 256):
        super().__init__()
        nlayers = max(nlayers, 1)
        if nlayers == 1:
            self.mlp = nn.Linear(in_dim, bottleneck_dim)
        else:
            dims = [in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
            layers: list[nn.Module] = []
            for li in range(nlayers):
                layers.append(nn.Linear(dims[li], dims[li + 1]))
                if li < nlayers - 1:
                    layers.append(nn.GELU(approximate="none"))
            self.mlp = nn.Sequential(*layers)
        self.last_layer = _WeightNormLinear(bottleneck_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.last_layer(l2_normalize(self.mlp(x), dim=-1))
