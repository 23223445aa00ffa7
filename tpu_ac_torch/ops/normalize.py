"""Normalization primitives (port of ``tpu_ac.ops.normalize``).

``adhoc_layernorm`` replicates the reference's fresh, never-trained
``torch.nn.LayerNorm([C, H, W])`` inside the embedding forward: identity
affine, biased variance, eps 1e-5, over every non-batch axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adhoc_layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over all axes except the first, identity affine."""
    return F.layer_norm(x, x.shape[1:], eps=eps)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the trailing axis with affine params (ViT blocks)."""
    return F.layer_norm(x, x.shape[-1:], weight, bias, eps)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along ``dim`` (F.normalize(p=2)), in x's dtype."""
    norm = torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)
