"""Hybrid R50+ViT (``vit_r50``, timm's vit_large_r50_s32_224) as an
``nn.Module`` (port of ``tpu_ac.models.vit_hybrid``).

A post-activation ResNetV2-50 with TF "SAME" padding and weight
standardisation (eps 1e-6) takes the place of the patch projection
(``patch_embed.backbone.*``): its stride-32 stage-4 map goes through a 1x1
conv (``patch_embed.proj``) to tokens, then a CLS token, the position
embedding (resized for a grid other than the pretraining one) and the
ViT-Large blocks of ``models/vit.py``.  ``forward(images, taps)`` returns
the tapped blocks' [B, 1 + N, D] tokens, CLS first, and stops after the
deepest; ``hybrid_vit_cls_forward`` is the normed CLS feature.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_ac_torch.models.resnetv2 import (
    ResNetV2,
    ResNetV2Config,
    init_resnetv2_params,
)
from tpu_ac_torch.models.vit import (
    ViTConfig,
    _Block,
    _LayerNorm,
    init_vit_params,
    interpolate_pos_encoding,
)

_BACKBONE_PREFIX = "patch_embed.backbone."


@dataclasses.dataclass(frozen=True)
class HybridViTConfig:
    resnet: ResNetV2Config = ResNetV2Config(block_counts=(3, 4, 6, 3),
                                            width_factor=1, preact=False,
                                            tf_same=True, stem_pool="same",
                                            ws_eps=1e-6)
    vit: ViTConfig = ViTConfig(embed_dim=1024, depth=24, num_heads=16,
                               img_size=224)
    total_stride: int = 32

    @property
    def grid(self) -> int:
        return self.vit.img_size // self.total_stride

    @property
    def token_vit(self) -> ViTConfig:
        """The ViT config whose patch is the backbone's total stride."""
        return dataclasses.replace(self.vit, patch_size=self.total_stride)


VIT_LARGE_R50_S32 = HybridViTConfig()


def _feat_channels(cfg: HybridViTConfig) -> int:
    return 512 * 4 * cfg.resnet.width_factor  # stage-4 output channels


def init_hybrid_vit_params(seed: int, cfg: HybridViTConfig
                           ) -> dict[str, np.ndarray]:
    """Bit-identical to ``tpu_ac.models.vit_hybrid.init_hybrid_vit_params``:
    the backbone from ``seed``, the ViT from ``seed + 1``, the projection
    from ``seed``'s first draws."""
    rng = np.random.default_rng(seed)
    p = {_BACKBONE_PREFIX + k: v
         for k, v in init_resnetv2_params(seed, cfg.resnet).items()}
    d, feat_c = cfg.vit.embed_dim, _feat_channels(cfg)
    if cfg.resnet.preact:  # post-act trunks have no final norm
        p[_BACKBONE_PREFIX + "norm.weight"] = np.ones((feat_c,), np.float32)
        p[_BACKBONE_PREFIX + "norm.bias"] = np.zeros((feat_c,), np.float32)
    vit_p = init_vit_params(seed + 1, cfg.token_vit)
    del vit_p["patch_embed.proj.weight"], vit_p["patch_embed.proj.bias"]
    p.update(vit_p)
    p["patch_embed.proj.weight"] = (
        rng.standard_normal((d, feat_c, 1, 1)) * (feat_c ** -0.5)
    ).astype(np.float32)
    p["patch_embed.proj.bias"] = np.zeros((d,), np.float32)
    return p


class HybridViT(nn.Module):
    """R50 + ViT trunk; ``forward(images, taps)`` -> {i: [B, 1+N, D]}."""

    family = "vit_hybrid"
    trunk_precision = "highest"  # tpu_ac's forward runs at HIGHEST

    def __init__(self, cfg: HybridViTConfig):
        super().__init__()
        self.cfg = cfg
        vcfg = cfg.token_vit
        d = vcfg.embed_dim
        self.patch_embed = nn.Module()
        self.patch_embed.backbone = ResNetV2(cfg.resnet)
        self.patch_embed.proj = nn.Conv2d(_feat_channels(cfg), d, 1)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(torch.empty(1, vcfg.num_patches + 1, d))
        self.blocks = nn.ModuleList(_Block(vcfg) for _ in range(vcfg.depth))
        self.norm = _LayerNorm(d, vcfg.ln_eps)

    def prepare_tokens(self, images: torch.Tensor) -> torch.Tensor:
        bb = self.patch_embed.backbone
        n_stages = len(self.cfg.resnet.block_counts)
        feats = bb(images, taps=(f"stage{n_stages}",))[f"stage{n_stages}"]
        if self.cfg.resnet.preact:  # post-act trunks end at the ReLU
            feats = F.relu(bb.norm(feats))
        x = self.patch_embed.proj(feats)
        b, d, gh, gw = x.shape
        tokens = x.reshape(b, d, gh * gw).transpose(1, 2)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], 1)
        s = self.cfg.total_stride
        return tokens + interpolate_pos_encoding(
            self.pos_embed, gh * gw, gh * s, gw * s, self.cfg.token_vit)

    def forward(self, images: torch.Tensor, taps: Sequence[int] = ()
                ) -> dict[int, torch.Tensor]:
        """Tapped block outputs; no taps runs every block and returns the
        last under -1."""
        taps = tuple(taps)
        depth = max(taps) + 1 if taps else len(self.blocks)
        x = self.prepare_tokens(images)
        out: dict[int, torch.Tensor] = {}
        for i in range(depth):
            x = self.blocks[i](x)
            if i in taps:
                out[i] = x
        if not taps:
            out[-1] = x
        return out


def hybrid_vit_cls_forward(model: HybridViT, images: torch.Tensor
                           ) -> torch.Tensor:
    """Every block, the final norm, the CLS token: [B, D]."""
    return model.norm(model(images)[-1])[:, 0]
