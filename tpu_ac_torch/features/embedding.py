"""Patch-embedding pipeline for every backbone family (port of
``tpu_ac.features.embedding``).

Per tapped layer: ViT tokens drop the CLS token and reshape to the
[D, G, G] grid, XCiT tokens (no CLS) reshape straight onto it, conv and
Swin maps are used as they come; ad-hoc LayerNorm over (C, H, W) unless
``apply_layernorm`` is off (PatchCore), then patchify (3x3, zero padded) +
MeanMapper (adaptive pool of the flattened window to
``pretrain_embed_dimension``); bilinear-align coarser grids onto the
first; Aggregator (adaptive pool of the stacked layers to
``target_embed_dimension``).  With ``patchstride == 1`` patchify+MeanMapper
is one k x k ``F.conv2d`` whose weight is the banded pooling matrix.  The
conv and pool matmuls are plain torch ops, as ``tpu_ac`` leaves them to
XLA; their precision follows the enclosing ``device.precision_scope``,
except that every family but the ViT runs its tail with TF32 off, as
``tpu_ac`` runs it at ``HIGHEST`` behind the trunk; a trunk whose
``tpu_ac`` forward defaults to ``HIGHEST`` (``trunk_precision``) runs with
TF32 off too.  ``embed_features`` dispatches on ``FAMILY_EMBEDDERS``.
Every family's embed opens two ``record_function`` ranges (inside the
sweep's ``ac.embed``): ``ac.embed.trunk`` around the backbone's forward
and ``ac.embed.tail`` around ``embed_feature_maps``; none while the embed
is traced for export.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from tpu_ac_torch.device import precision_scope
from tpu_ac_torch.models.vit import ViT
from tpu_ac_torch.ops.interpolate import interpolate_bilinear
from tpu_ac_torch.ops.normalize import adhoc_layernorm
from tpu_ac_torch.ops.pooling import (
    _adaptive_pool_matrix_np,
    adaptive_avg_pool1d,
    patchify,
)
from tpu_ac_torch.utils.profiling import step_annotation


@dataclasses.dataclass(frozen=True)
class EmbedConfig:
    """Hyperparameters of the embedding pipeline (reference main.py flags)."""

    layers: tuple[str, ...] = ("blocks.10", "blocks.11")
    pretrain_embed_dimension: int = 2048
    target_embed_dimension: int = 4096
    patchsize: int = 3
    patchstride: int = 1
    apply_layernorm: bool = True

    def __post_init__(self):
        # the (k-1)//2-padded patchify preserves the grid only for odd k
        if self.patchsize % 2 != 1:
            raise ValueError(f"patchsize must be odd, got {self.patchsize}")

    @property
    def tap_indices(self) -> tuple[int, ...]:
        return tuple(int(name.split(".")[-1]) for name in self.layers)


def _grid_features(tokens: torch.Tensor) -> torch.Tensor:
    """[B, N+1, D] tokens -> [B, D, G, G] grid (CLS dropped, square grid)."""
    b, n1, d = tokens.shape
    g = int(round((n1 - 1) ** 0.5))
    return tokens[:, 1:, :].reshape(b, g, g, d).permute(0, 3, 1, 2)


def _align_to(x: torch.Tensor, grid: tuple[int, int],
              ref_grid: tuple[int, int]) -> torch.Tensor:
    """[B, gh*gw, C] per-site features -> [B, ref_gh*ref_gw, C], bilinear."""
    if grid == ref_grid:
        return x
    b = x.shape[0]
    x = x.reshape(b, grid[0], grid[1], -1).permute(0, 3, 1, 2)
    x = interpolate_bilinear(x, size=ref_grid)
    return x.permute(0, 2, 3, 1).reshape(b, ref_grid[0] * ref_grid[1], -1)


@functools.lru_cache(maxsize=8)
def _fused_pool_conv_weight(d: int, k: int, out_dim: int,
                            dtype: torch.dtype,
                            device: torch.device) -> torch.Tensor:
    """patchify + MeanMapper as conv weights [out, d, k, k]: the banded
    pooling matrix over the flattened (c, kh, kw) window, reshaped."""
    mat = _adaptive_pool_matrix_np(d * k * k, out_dim)  # [d*k*k, out]
    w = torch.from_numpy(mat.reshape(d, k, k, out_dim)).permute(3, 0, 1, 2)
    return w.contiguous().to(device=device, dtype=dtype)


def _fused_pool(x: torch.Tensor, k: int, out_dim: int) -> torch.Tensor:
    """[B, D, H, W] grid -> [B, H*W, out_dim] pooled patch features."""
    b, d, h, w = x.shape
    weight = _fused_pool_conv_weight(d, k, out_dim, x.dtype, x.device)
    y = F.conv2d(x, weight, padding=(k - 1) // 2)
    return y.permute(0, 2, 3, 1).reshape(b, h * w, out_dim)


def embed_feature_maps(feature_maps: Sequence[torch.Tensor],
                       cfg: EmbedConfig) -> torch.Tensor:
    """The _embed tail for per-layer features ([B, N+1, D] tokens or
    [B, C, H, W] maps) -> [B, P, target_embed_dimension]."""
    pooled, grids = [], []
    for f in feature_maps:
        x = _grid_features(f) if f.ndim == 3 else f
        if cfg.apply_layernorm:
            x = adhoc_layernorm(x)
        if cfg.patchstride == 1:
            p = _fused_pool(x, cfg.patchsize, cfg.pretrain_embed_dimension)
            grid = (x.shape[2], x.shape[3])
        else:
            patches, grid = patchify(x, cfg.patchsize, cfg.patchstride)
            b, n = patches.shape[:2]
            p = patches.reshape(b, n, -1)  # (D, k, k) flatten order
        pooled.append(p)
        grids.append(grid)
    # the bilinear alignment and the MeanMapper pool are both linear on
    # disjoint axes, so aligning before or after the pool is the same map
    aligned = [_align_to(p, g, grids[0]) for p, g in zip(pooled, grids)]
    if cfg.patchstride != 1:
        aligned = [adaptive_avg_pool1d(p, cfg.pretrain_embed_dimension)
                   for p in aligned]
    stacked = torch.stack(aligned, dim=2)  # [B, P, L, pretrain]
    b, p_ = stacked.shape[:2]
    return adaptive_avg_pool1d(stacked.reshape(b, p_, -1),
                               cfg.target_embed_dimension)


def _span(name: str):
    """``step_annotation(name)``, or nothing while the embed is traced."""
    if torch.compiler.is_compiling():
        return contextlib.nullcontext()
    return step_annotation(name)


def _trunk(model, images: torch.Tensor, **kw):
    """The backbone's forward in the ``ac.embed.trunk`` range."""
    with _span("ac.embed.trunk"):
        return model(images, **kw)


def _tail(maps: Sequence[torch.Tensor], cfg: EmbedConfig) -> torch.Tensor:
    """``embed_feature_maps`` in the ``ac.embed.tail`` range."""
    with _span("ac.embed.tail"):
        return embed_feature_maps(maps, cfg)


def embed_vit_features(model: ViT, images: torch.Tensor,
                       cfg: EmbedConfig, *,
                       attention_impl: str | None = None) -> torch.Tensor:
    """[B, 3, H, W] normalized images -> [B, P, target_embed_dimension]."""
    taps = cfg.tap_indices
    outs = _trunk(model, images, taps=taps, attention_impl=attention_impl)
    # DeiT-distilled's dist token and DINOv2's registers follow CLS; keep
    # exactly one prefix token so the shared CLS-drop path applies
    skip = model.cfg.num_prefix_tokens + model.cfg.num_register_tokens - 1
    return _tail([outs[t][:, skip:] for t in taps], cfg)


def _trunk_scope(model):
    """TF32 off for a trunk that ``tpu_ac`` runs at HIGHEST whatever the
    pipeline's precision; else the caller's scope."""
    if getattr(model, "trunk_precision", None) == "highest":
        return precision_scope("highest")
    return contextlib.nullcontext()


def embed_trunk_features(model, images: torch.Tensor,
                         cfg: EmbedConfig) -> torch.Tensor:
    """[B, 3, H, W] normalized images -> [B, P, target_embed_dimension] for
    a family whose forward returns {layer name: [B, C, H, W]}; ``cfg.layers``
    are those names ("layer2", "denseblock3", "features.9", "layers.1",
    ...).  The tail runs with TF32 off."""
    with _trunk_scope(model):
        outs = _trunk(model, images, taps=cfg.layers)
    with precision_scope("highest"):
        return _tail([outs[name] for name in cfg.layers], cfg)


def embed_xcit_features(model, images: torch.Tensor,
                        cfg: EmbedConfig) -> torch.Tensor:
    """XCiT: ``cfg.layers`` are block indices ("blocks.i"); the tokens carry
    no CLS, so [B, N, D] reshapes straight onto the [D, G, G] grid."""
    taps = cfg.tap_indices
    with _trunk_scope(model):
        outs = _trunk(model, images, taps=taps)
    maps = []
    for t in taps:
        b, n, d = outs[t].shape
        g = int(round(n ** 0.5))
        maps.append(outs[t].reshape(b, g, g, d).permute(0, 3, 1, 2))
    with precision_scope("highest"):
        return _tail(maps, cfg)


def embed_hybrid_vit_features(model, images: torch.Tensor,
                              cfg: EmbedConfig) -> torch.Tensor:
    """R50+ViT: ``cfg.layers`` are block indices; the tokens carry a CLS
    token, which the shared path drops, as for a ViT."""
    taps = cfg.tap_indices
    with _trunk_scope(model):
        outs = _trunk(model, images, taps=taps)
    with precision_scope("highest"):
        return _tail([outs[t] for t in taps], cfg)


# family -> embed fn (model, images, cfg, **family kwargs); a family not
# here raises in embed_features
FAMILY_EMBEDDERS = {
    "vit": embed_vit_features,
    "xcit": embed_xcit_features,
    "vit_hybrid": embed_hybrid_vit_features,
    **{family: embed_trunk_features for family in (
        "resnet", "vgg", "alexnet", "densenet", "efficientnet",
        "efficientnetv2", "mnasnet", "resnetv2", "swin", "inception_v4",
        "bninception", "resnest")},
}


def embed_features(family: str, model, images: torch.Tensor,
                   cfg: EmbedConfig, **kwargs) -> torch.Tensor:
    """Family-dispatched _embed: [B, 3, H, W] -> [B, P, target_dim]."""
    if family not in FAMILY_EMBEDDERS:
        raise NotImplementedError(
            f"family {family!r}; ported: {sorted(FAMILY_EMBEDDERS)}")
    return FAMILY_EMBEDDERS[family](model, images, cfg, **kwargs)
