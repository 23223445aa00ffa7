"""ResNeSt (split-attention ResNet) trunk as an ``nn.Module`` (port of
``tpu_ac.models.resnest``): ``resnest50d_4s2x40d``, radix 4, cardinality 2,
base width 40, the deep 3-conv stem, average-pool downsampling, and the
pool before the split-attention conv in strided blocks (``avd_first``).

Keys are timm's (``conv1.{0,1,3,4,6}``, ``layerL.B.conv2.{conv,bn0,fc1,
bn1,fc2}``, ``downsample.{1,2}``).  The split attention is a grouped 3x3
conv to radix x width channels, a gate from the global pool of the summed
splits (fc1 -> BN -> ReLU -> fc2, grouped by cardinality), and the
radix-softmax of ``_rsoftmax`` (a sigmoid when radix is 1) mixing the
splits.  Taps are ``layer1`` ... ``layer4``; ``forward`` stops after the
deepest.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_ac_torch.models.layers import FrozenBN


@dataclasses.dataclass(frozen=True)
class ResNeStConfig:
    block_counts: tuple[int, ...] = (3, 4, 6, 3)
    radix: int = 4
    cardinality: int = 2
    base_width: int = 40
    stem_width: int = 32
    expansion: int = 4
    bn_eps: float = 1e-5
    # pool BEFORE the split-attention conv in strided blocks
    avd_first: bool = True

    def group_width(self, planes: int) -> int:
        return int(planes * (self.base_width / 64.0)) * self.cardinality

    @property
    def stage_planes(self) -> tuple[int, ...]:
        return (64, 128, 256, 512)

    @property
    def stage_out_channels(self) -> tuple[int, ...]:
        return tuple(p * self.expansion for p in self.stage_planes)


RESNEST50D_4S2X40D = ResNeStConfig()


def _inter_channels(gw: int, cfg: ResNeStConfig) -> int:
    return max(gw * cfg.radix // 4, 32)


def init_resnest_params(seed: int, cfg: ResNeStConfig
                        ) -> dict[str, np.ndarray]:
    """Bit-identical to ``tpu_ac.models.resnest.init_resnest_params``."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def conv(name, out_c, in_c, k, groups=1):
        fan = in_c // groups * k * k
        p[name + ".weight"] = (
            rng.standard_normal((out_c, in_c // groups, k, k))
            * np.sqrt(2.0 / fan)).astype(np.float32)

    def bn(name, c):
        p[name + ".weight"] = np.ones((c,), np.float32)
        p[name + ".bias"] = np.zeros((c,), np.float32)
        p[name + ".running_mean"] = np.zeros((c,), np.float32)
        p[name + ".running_var"] = np.ones((c,), np.float32)

    sw = cfg.stem_width
    conv("conv1.0", sw, 3, 3)
    bn("conv1.1", sw)
    conv("conv1.3", sw, sw, 3)
    bn("conv1.4", sw)
    conv("conv1.6", sw * 2, sw, 3)
    bn("bn1", sw * 2)
    in_c = sw * 2
    for li, (n_blocks, planes) in enumerate(zip(cfg.block_counts,
                                                cfg.stage_planes)):
        gw = cfg.group_width(planes)
        out_c = planes * cfg.expansion
        inter = _inter_channels(gw, cfg)
        for b in range(n_blocks):
            pre = f"layer{li + 1}.{b}."
            conv(pre + "conv1", gw, in_c, 1)
            bn(pre + "bn1", gw)
            conv(pre + "conv2.conv", gw * cfg.radix, gw, 3,
                 groups=cfg.cardinality * cfg.radix)
            bn(pre + "conv2.bn0", gw * cfg.radix)
            conv(pre + "conv2.fc1", inter, gw, 1, groups=cfg.cardinality)
            p[pre + "conv2.fc1.bias"] = np.zeros((inter,), np.float32)
            bn(pre + "conv2.bn1", inter)
            conv(pre + "conv2.fc2", gw * cfg.radix, inter, 1,
                 groups=cfg.cardinality)
            p[pre + "conv2.fc2.bias"] = np.zeros((gw * cfg.radix,),
                                                 np.float32)
            conv(pre + "conv3", out_c, gw, 1)
            bn(pre + "bn3", out_c)
            if b == 0:
                conv(pre + "downsample.1", out_c, in_c, 1)
                bn(pre + "downsample.2", out_c)
            in_c = out_c
    return p


def _rsoftmax(x: torch.Tensor, radix: int, cardinality: int
              ) -> torch.Tensor:
    """[B, radix*C] gate logits -> the official rSoftMax: view (B, card,
    radix, c'), softmax over radix in radix-major order, flattened without
    transposing back (chunk r gates radix split r); radix 1 is a sigmoid."""
    if radix == 1:
        return torch.sigmoid(x)
    b = x.shape[0]
    x = x.reshape(b, cardinality, radix, -1).transpose(1, 2)
    return torch.softmax(x, dim=1).reshape(b, -1)


class _SplitAttnConv(nn.Module):
    """SplAtConv2d: grouped conv -> radix-softmax-gated mix of splits."""

    def __init__(self, gw: int, cfg: ResNeStConfig):
        super().__init__()
        r, card, eps = cfg.radix, cfg.cardinality, cfg.bn_eps
        inter = _inter_channels(gw, cfg)
        self.radix, self.cardinality = r, card
        self.conv = nn.Conv2d(gw, gw * r, 3, padding=1, groups=card * r,
                              bias=False)
        self.bn0 = FrozenBN(gw * r, eps)
        self.fc1 = nn.Conv2d(gw, inter, 1, groups=card)
        self.bn1 = FrozenBN(inter, eps)
        self.fc2 = nn.Conv2d(inter, gw * r, 1, groups=card)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.radix
        y = F.relu(self.bn0(self.conv(x)))
        b, rc, h, w = y.shape
        splits = y.reshape(b, r, rc // r, h, w)
        gap = splits.sum(1).mean((2, 3))[:, :, None, None]      # [B, C, 1, 1]
        gate = self.fc2(F.relu(self.bn1(self.fc1(gap))))
        atten = _rsoftmax(gate[:, :, 0, 0], r, self.cardinality)
        return (atten.reshape(b, r, rc // r, 1, 1) * splits).sum(1)


class _Block(nn.Module):
    def __init__(self, in_c: int, planes: int, stride: int, down: bool,
                 cfg: ResNeStConfig):
        super().__init__()
        gw, out_c, eps = cfg.group_width(planes), planes * cfg.expansion, \
            cfg.bn_eps
        self.stride, self.avd_first = stride, cfg.avd_first
        self.conv1 = nn.Conv2d(in_c, gw, 1, bias=False)
        self.bn1 = FrozenBN(gw, eps)
        self.conv2 = _SplitAttnConv(gw, cfg)
        self.conv3 = nn.Conv2d(gw, out_c, 1, bias=False)
        self.bn3 = FrozenBN(out_c, eps)
        # avg_down: [AvgPool] -> 1x1 conv -> BN (timm's indices 1 and 2)
        self.downsample = nn.Sequential(
            nn.Identity(), nn.Conv2d(in_c, out_c, 1, bias=False),
            FrozenBN(out_c, eps)) if down else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        y = F.relu(self.bn1(self.conv1(x)))
        # avd: the split-attention conv runs at stride 1 and a 3x3/s
        # average pool (padded zeros counted) does the downsampling
        if s > 1 and self.avd_first:
            y = F.avg_pool2d(y, 3, s, 1)
        y = self.conv2(y)
        if s > 1 and not self.avd_first:
            y = F.avg_pool2d(y, 3, s, 1)
        y = self.bn3(self.conv3(y))
        identity = x
        if self.downsample is not None:
            if s > 1:
                identity = F.avg_pool2d(identity, s, s)
            identity = self.downsample[2](self.downsample[1](identity))
        return F.relu(y + identity)


class ResNeSt(nn.Module):
    """ResNeSt trunk; ``forward(images, taps)`` -> {"layerN": map}."""

    family = "resnest"
    trunk_precision = "highest"  # tpu_ac's forward runs at HIGHEST

    def __init__(self, cfg: ResNeStConfig):
        super().__init__()
        self.cfg = cfg
        sw, eps = cfg.stem_width, cfg.bn_eps
        self.conv1 = nn.Sequential(
            nn.Conv2d(3, sw, 3, stride=2, padding=1, bias=False),
            FrozenBN(sw, eps), nn.ReLU(),
            nn.Conv2d(sw, sw, 3, padding=1, bias=False),
            FrozenBN(sw, eps), nn.ReLU(),
            nn.Conv2d(sw, sw * 2, 3, padding=1, bias=False))
        self.bn1 = FrozenBN(sw * 2, eps)
        in_c = sw * 2
        for li, (n_blocks, planes) in enumerate(zip(cfg.block_counts,
                                                    cfg.stage_planes)):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (li > 0 and b == 0) else 1
                blocks.append(_Block(in_c, planes, stride, b == 0, cfg))
                in_c = planes * cfg.expansion
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))

    def forward(self, images: torch.Tensor,
                taps: Sequence[str] = ("layer2", "layer3")
                ) -> dict[str, torch.Tensor]:
        deepest = max(int(t[-1]) for t in taps)
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(images))), 3, 2, 1)
        out: dict[str, torch.Tensor] = {}
        for li in range(1, deepest + 1):
            x = getattr(self, f"layer{li}")(x)
            if f"layer{li}" in taps:
                out[f"layer{li}"] = x
        return out
