"""ResNetV2 / BiT trunk as an ``nn.Module`` (port of
``tpu_ac.models.resnetv2``).

BiT: pre-activation bottlenecks with GroupNorm (32 groups) and
weight-standardised convs (per output channel, eps 1e-8 for BiT), a
7x7/2 stem conv and a "fixed" stem pool (zero pad, then an unpadded 3x3/2
max pool), a final trunk norm.  ``RESNETV2_101`` is timm's plain
resnetv2_101: BatchNorm with running stats, ordinary convs, a
``MaxPool2d(3, 2, 1)`` stem pool.  ``preact=False`` is the post-activation
layout timm builds for the R50+ViT hybrid (conv -> norm, normed
downsample, ReLU after the residual add, no final norm), with TF "SAME"
padding (``tf_same``) on every conv and the stem pool.

The standardisation runs on the weight in its own dtype: under the
bfloat16 embed the weights are bf16 first, as ``tpu_ac`` casts every
param before the forward.  Keys are timm's (``stem.conv.weight``,
``stages.S.blocks.B.{norm1,conv1,...,downsample.conv}``, ``norm``).  Taps
are ``stage1`` ... ``stage4`` (the residual stream after each stage);
``forward`` stops after the deepest.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_ac_torch.models.layers import FrozenBN, pad_tf_same


@dataclasses.dataclass(frozen=True)
class ResNetV2Config:
    block_counts: tuple[int, ...] = (3, 4, 23, 3)  # resnetv2_101
    width_factor: int = 1                          # 3 for bitm x3 variants
    gn_groups: int = 32
    gn_eps: float = 1e-5
    preact: bool = True
    tf_same: bool = False
    norm: str = "gn"       # "gn" (GroupNorm) | "bn" (BN with running stats)
    std_conv: bool = True  # weight-standardised convs
    ws_eps: float = 1e-8
    # "fixed" (BiT: zero pad 1, unpadded pool) | "standard"
    # (MaxPool2d(3, 2, 1)) | "same" (TF SAME, -inf)
    stem_pool: str = "fixed"
    bn_eps: float = 1e-5


RESNETV2_101 = ResNetV2Config(norm="bn", std_conv=False,
                              stem_pool="standard")
RESNETV2_50X3 = ResNetV2Config(block_counts=(3, 4, 6, 3), width_factor=3)
RESNETV2_101X3 = ResNetV2Config(width_factor=3)
RESNETV2_152X4 = ResNetV2Config(block_counts=(3, 8, 36, 3), width_factor=4)
RESNETV2_152X2 = ResNetV2Config(block_counts=(3, 8, 36, 3), width_factor=2)


def init_resnetv2_params(seed: int, cfg: ResNetV2Config
                         ) -> dict[str, np.ndarray]:
    """Bit-identical to ``tpu_ac.models.resnetv2.init_resnetv2_params``."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def conv(name, out_c, in_c, k):
        fan = in_c * k * k
        p[name + ".weight"] = (
            rng.standard_normal((out_c, in_c, k, k)) * math.sqrt(2.0 / fan)
        ).astype(np.float32)

    def gn(name, c):
        p[name + ".weight"] = np.ones((c,), np.float32)
        p[name + ".bias"] = np.zeros((c,), np.float32)
        if cfg.norm == "bn":
            p[name + ".running_mean"] = np.zeros((c,), np.float32)
            p[name + ".running_var"] = np.ones((c,), np.float32)

    wf = cfg.width_factor
    conv("stem.conv", 64 * wf, 3, 7)
    if not cfg.preact:
        gn("stem.norm", 64 * wf)
    in_c = 64 * wf
    for si, n_blocks in enumerate(cfg.block_counts):
        out_c, mid = 256 * (2 ** si) * wf, 64 * (2 ** si) * wf
        for bi in range(n_blocks):
            pre = f"stages.{si}.blocks.{bi}."
            gn(pre + "norm1", in_c if cfg.preact else mid)
            conv(pre + "conv1", mid, in_c, 1)
            gn(pre + "norm2", mid)
            conv(pre + "conv2", mid, mid, 3)
            gn(pre + "norm3", mid if cfg.preact else out_c)
            conv(pre + "conv3", out_c, mid, 1)
            if bi == 0:
                conv(pre + "downsample.conv", out_c, in_c, 1)
                if not cfg.preact:
                    gn(pre + "downsample.norm", out_c)
            in_c = out_c
    if cfg.preact:
        gn("norm", in_c)
    return p


class _StdConv(nn.Module):
    """Conv (no bias) whose weight is standardised per output channel
    (population variance, ``eps``) when ``standardize``; TF SAME padding
    when ``tf_same``, else symmetric ``padding``."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int,
                 padding: int, cfg: ResNetV2Config):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_c, in_c, k, k))
        self.stride, self.padding = stride, padding
        self.standardize, self.eps = cfg.std_conv, cfg.ws_eps
        self.tf_same = cfg.tf_same

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.standardize:
            var, mean = torch.var_mean(w, dim=(1, 2, 3), unbiased=False,
                                       keepdim=True)
            w = (w - mean) * torch.rsqrt(var + self.eps)
        padding = self.padding
        if self.tf_same:
            k = w.shape[2]
            x, padding = pad_tf_same(x, k, k, self.stride), 0
        return F.conv2d(x, w, None, self.stride, padding)


class _GroupNorm(nn.Module):
    """Affine GroupNorm (``min(groups, C)`` groups), no activation."""

    def __init__(self, c: int, cfg: ResNetV2Config):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.groups, self.eps = min(cfg.gn_groups, c), cfg.gn_eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)


def _norm(c: int, cfg: ResNetV2Config) -> nn.Module:
    return FrozenBN(c, cfg.bn_eps) if cfg.norm == "bn" \
        else _GroupNorm(c, cfg)


class _Block(nn.Module):
    def __init__(self, in_c: int, mid: int, out_c: int, stride: int,
                 down: bool, cfg: ResNetV2Config):
        super().__init__()
        self.preact = cfg.preact
        self.norm1 = _norm(in_c if cfg.preact else mid, cfg)
        self.conv1 = _StdConv(in_c, mid, 1, 1, 0, cfg)
        self.norm2 = _norm(mid, cfg)
        self.conv2 = _StdConv(mid, mid, 3, stride, 1, cfg)
        self.norm3 = _norm(mid if cfg.preact else out_c, cfg)
        self.conv3 = _StdConv(mid, out_c, 1, 1, 0, cfg)
        if down:
            self.downsample = nn.Module()
            self.downsample.conv = _StdConv(in_c, out_c, 1, stride, 0, cfg)
            if not cfg.preact:
                self.downsample.norm = _norm(out_c, cfg)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.preact:
            pre_act = F.relu(self.norm1(x))
            shortcut = x if self.downsample is None \
                else self.downsample.conv(pre_act)
            h = F.relu(self.norm2(self.conv1(pre_act)))
            h = F.relu(self.norm3(self.conv2(h)))
            return self.conv3(h) + shortcut
        shortcut = x if self.downsample is None \
            else self.downsample.norm(self.downsample.conv(x))
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        return F.relu(self.norm3(self.conv3(h)) + shortcut)


class ResNetV2(nn.Module):
    """ResNetV2 trunk; ``forward(images, taps)`` -> {"stageN": map}."""

    family = "resnetv2"

    def __init__(self, cfg: ResNetV2Config):
        super().__init__()
        self.cfg = cfg
        wf = cfg.width_factor
        self.stem = nn.Module()
        self.stem.conv = _StdConv(3, 64 * wf, 7, 2, 3, cfg)
        if not cfg.preact:
            self.stem.norm = _norm(64 * wf, cfg)
        self.stages = nn.ModuleList()
        in_c = 64 * wf
        for si, n_blocks in enumerate(cfg.block_counts):
            out_c, mid = 256 * (2 ** si) * wf, 64 * (2 ** si) * wf
            stage = nn.Module()
            stage.blocks = nn.Sequential(*(
                _Block(in_c if bi == 0 else out_c, mid, out_c,
                       1 if (si == 0 or bi > 0) else 2, bi == 0, cfg)
                for bi in range(n_blocks)))
            self.stages.append(stage)
            in_c = out_c
        if cfg.preact:
            self.norm = _norm(in_c, cfg)

    def stem_forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.stem.conv(images)
        if not self.cfg.preact:
            x = F.relu(self.stem.norm(x))
        if self.cfg.stem_pool == "fixed":
            # zeros, not -inf, reach the pool's borders
            return F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)
        if self.cfg.stem_pool == "same":
            return F.max_pool2d(pad_tf_same(x, 3, 3, 2, float("-inf")), 3,
                                2)
        return F.max_pool2d(x, 3, 2, 1)

    def forward(self, images: torch.Tensor,
                taps: Sequence[str] = ("stage2", "stage3")
                ) -> dict[str, torch.Tensor]:
        deepest = max(int(t[-1]) for t in taps)
        x = self.stem_forward(images)
        out: dict[str, torch.Tensor] = {}
        for si in range(deepest):
            x = self.stages[si].blocks(x)
            if f"stage{si + 1}" in taps:
                out[f"stage{si + 1}"] = x
        return out
