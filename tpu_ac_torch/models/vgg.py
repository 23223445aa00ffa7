"""VGG and AlexNet trunks as ``nn.Module``s (port of ``tpu_ac.models.vgg``).

``state_dict`` keys are torchvision's ``features.<index>.<param>``: the
index counts every slot of torchvision's ``Sequential`` (conv, [BN,] ReLU,
max pool), so released checkpoints load key for key.  VGG taps are the
five conv stages ``stage1`` ... ``stage5`` (the output of a stage's last
ReLU, before its 2x2 max pool); AlexNet taps are ``conv1`` ... ``conv5``
(post-ReLU, before the 3x3/2 pool that follows convs 0, 3 and 10).
Both stop after the deepest tap.  Convs are ``nn.Conv2d`` in NCHW; their
precision follows the enclosing ``device.precision_scope``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_ac_torch.models.layers import FrozenBN

# torchvision cfgs: numbers are conv output channels, "M" is a max pool
_CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    arch: str = "vgg19"
    batch_norm: bool = False
    bn_eps: float = 1e-5

    @property
    def layout(self):
        return _CFGS[self.arch]


VGG11 = VGGConfig("vgg11")
VGG19 = VGGConfig("vgg19")
VGG19_BN = VGGConfig("vgg19", batch_norm=True)


def _sequential_indices(cfg: VGGConfig):
    """(features index, kind, channels) in torchvision's numbering: conv
    [, bn], relu per conv; one slot per pool."""
    idx = 0
    for v in cfg.layout:
        if v == "M":
            yield idx, "pool", None
            idx += 1
        else:
            yield idx, "conv", v
            idx += 1
            if cfg.batch_norm:
                yield idx, "bn", v
                idx += 1
            yield idx, "relu", None
            idx += 1


def init_vgg_params(seed: int, cfg: VGGConfig) -> dict[str, np.ndarray]:
    """The same draws in the same order as
    ``tpu_ac.models.vgg.init_vgg_params``: bit-identical arrays."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}
    in_c = 3
    for idx, kind, c in _sequential_indices(cfg):
        if kind == "conv":
            fan = in_c * 9
            p[f"features.{idx}.weight"] = (
                rng.standard_normal((c, in_c, 3, 3)) * math.sqrt(2.0 / fan)
            ).astype(np.float32)
            p[f"features.{idx}.bias"] = np.zeros((c,), np.float32)
            in_c = c
        elif kind == "bn":
            p[f"features.{idx}.weight"] = np.ones((c,), np.float32)
            p[f"features.{idx}.bias"] = np.zeros((c,), np.float32)
            p[f"features.{idx}.running_mean"] = np.zeros((c,), np.float32)
            p[f"features.{idx}.running_var"] = np.ones((c,), np.float32)
    return p


class VGG(nn.Module):
    """VGG feature trunk; ``forward(images, taps)`` -> {stageN: map}."""

    family = "vgg"

    def __init__(self, cfg: VGGConfig):
        super().__init__()
        self.cfg = cfg
        layers: list[nn.Module] = []
        in_c = 3
        for _idx, kind, c in _sequential_indices(cfg):
            if kind == "conv":
                layers.append(nn.Conv2d(in_c, c, 3, padding=1))
                in_c = c
            elif kind == "bn":
                layers.append(FrozenBN(c, cfg.bn_eps))
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def forward(self, images: torch.Tensor,
                taps: Sequence[str] = ("stage3", "stage4")
                ) -> dict[str, torch.Tensor]:
        taps = tuple(taps)
        deepest = max(int(t[-1]) for t in taps)
        x, stage = images, 1
        out: dict[str, torch.Tensor] = {}
        for layer in self.features:
            if isinstance(layer, nn.MaxPool2d):
                # a pool ends a stage: its output is the map before it
                if f"stage{stage}" in taps:
                    out[f"stage{stage}"] = x
                if stage >= deepest:
                    break
                stage += 1
            x = layer(x)
        return out


@dataclasses.dataclass(frozen=True)
class AlexNetConfig:
    pass


ALEXNET = AlexNetConfig()

# (features index, out_c, in_c, kernel, stride, padding)
_ALEXNET_CONVS = (
    (0, 64, 3, 11, 4, 2),
    (3, 192, 64, 5, 1, 2),
    (6, 384, 192, 3, 1, 1),
    (8, 256, 384, 3, 1, 1),
    (10, 256, 256, 3, 1, 1),
)
# a 3x3/2 max pool follows these convs (after their ReLU)
_ALEXNET_POOL_AFTER = {0, 3, 10}


def init_alexnet_params(seed: int, cfg: AlexNetConfig = ALEXNET
                        ) -> dict[str, np.ndarray]:
    """Bit-identical to ``tpu_ac.models.vgg.init_alexnet_params``."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}
    for idx, out_c, in_c, k, _s, _pad in _ALEXNET_CONVS:
        fan = in_c * k * k
        p[f"features.{idx}.weight"] = (
            rng.standard_normal((out_c, in_c, k, k)) * math.sqrt(2.0 / fan)
        ).astype(np.float32)
        p[f"features.{idx}.bias"] = np.zeros((out_c,), np.float32)
    return p


class AlexNet(nn.Module):
    """torchvision AlexNet features; ``forward(images, taps)`` ->
    {convN: map}."""

    family = "alexnet"

    def __init__(self, cfg: AlexNetConfig = ALEXNET):
        super().__init__()
        self.cfg = cfg
        self.features = nn.Module()
        for idx, out_c, in_c, k, stride, pad in _ALEXNET_CONVS:
            self.features.add_module(str(idx), nn.Conv2d(
                in_c, out_c, k, stride=stride, padding=pad))

    def forward(self, images: torch.Tensor,
                taps: Sequence[str] = ("conv4", "conv5")
                ) -> dict[str, torch.Tensor]:
        taps = tuple(taps)
        deepest = max(int(t[-1]) for t in taps)
        x = images
        out: dict[str, torch.Tensor] = {}
        for n, (idx, *_rest) in enumerate(_ALEXNET_CONVS, start=1):
            x = F.relu(getattr(self.features, str(idx))(x))
            if f"conv{n}" in taps:
                out[f"conv{n}"] = x
            if n >= deepest:
                break
            if idx in _ALEXNET_POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return out
