"""The embedding tail of anomaly clustering (PatchCore's ``_embed``, as the
Anomaly-Clustering repository uses it), plain f32 torch ops.

Per tapped map [B, C, H, W]: a fresh ``LayerNorm([C, H, W])`` (identity
affine, eps 1e-5); 3 x 3 patches, zero padded (``F.unfold``, flattened in
(c, kh, kw) order); MeanMapper (``adaptive_avg_pool1d`` of each patch to
``pretrain_embed_dimension``); maps on a coarser grid aligned onto the
first tap's grid by bilinear interpolation (``align_corners=False``);
the layers stacked and pooled to ``target_embed_dimension`` (the
Aggregator).  One departure: PatchCore aligns the unpooled patches and
pools after; both maps are linear on disjoint axes, so pooling first is
the same map at a ninth of the memory.  ``q`` is applied to the pooling's
input (a product in the program: ``tpu_ac_torch`` pools by a convolution).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def embed_tail(maps: list[torch.Tensor], config: dict, q) -> torch.Tensor:
    """[B, C_l, H_l, W_l] maps -> [B, P, target] f32."""
    k = config["patchsize"]
    pre = config["pretrain_embed_dimension"]
    target = config["target_embed_dimension"]
    pooled, grids = [], []
    for x in maps:
        x = F.layer_norm(x, x.shape[1:], eps=1e-5)
        b, c, h, w = x.shape
        u = F.unfold(q(x), k, padding=(k - 1) // 2).transpose(1, 2)
        p = F.adaptive_avg_pool1d(u.reshape(b * h * w, 1, c * k * k), pre)
        pooled.append(p.reshape(b, h * w, pre))
        grids.append((h, w))
    ref = grids[0]
    aligned = []
    for p, (h, w) in zip(pooled, grids):
        if (h, w) != ref:
            b = p.shape[0]
            grid = p.transpose(1, 2).reshape(b, pre, h, w)
            grid = F.interpolate(grid, size=ref, mode="bilinear",
                                 align_corners=False)
            p = grid.reshape(b, pre, -1).transpose(1, 2)
        aligned.append(p)
    stacked = torch.stack(aligned, dim=2)  # [B, P, L, pre]
    b, n = stacked.shape[:2]
    z = F.adaptive_avg_pool1d(stacked.reshape(b * n, 1, -1), target)
    return z.reshape(b, n, target)
