"""DenseNet trunk as an ``nn.Module`` (port of ``tpu_ac.models.densenet``).

``state_dict`` keys are torchvision's (``features.conv0.weight``,
``features.denseblock3.denselayer7.norm2.running_var``,
``features.transition2.conv.weight``, ``classifier.bias``); a released
torchvision ``.pth`` uses the legacy ``norm.1`` spelling, which
``models.convert.load_torch_checkpoint`` remaps.  BatchNorm is frozen
inference BN.  Each dense layer concatenates its 3x3 output onto the
running feature map; taps are the dense-block outputs ``denseblock1`` ...
``denseblock4`` (before the following transition), and ``forward`` stops
after the deepest one.
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


@dataclasses.dataclass(frozen=True)
class DenseNetConfig:
    block_config: tuple[int, ...] = (6, 12, 48, 32)  # densenet201
    growth_rate: int = 32
    num_init_features: int = 64
    bn_size: int = 4
    bn_eps: float = 1e-5
    num_classes: int = 1000


DENSENET201 = DenseNetConfig()
DENSENET169 = DenseNetConfig(block_config=(6, 12, 32, 32))
DENSENET121 = DenseNetConfig(block_config=(6, 12, 24, 16))


def init_densenet_params(seed: int, cfg: DenseNetConfig
                         ) -> dict[str, np.ndarray]:
    """Bit-identical to ``tpu_ac.models.densenet.init_densenet_params``."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def conv(name, out_c, in_c, k):
        fan = in_c * k * k
        p[name + ".weight"] = (
            rng.standard_normal((out_c, in_c, k, k)) * math.sqrt(2.0 / fan)
        ).astype(np.float32)

    def bn(name, c):
        p[name + ".weight"] = np.ones((c,), np.float32)
        p[name + ".bias"] = np.zeros((c,), np.float32)
        p[name + ".running_mean"] = np.zeros((c,), np.float32)
        p[name + ".running_var"] = np.ones((c,), np.float32)

    conv("features.conv0", cfg.num_init_features, 3, 7)
    bn("features.norm0", cfg.num_init_features)
    c = cfg.num_init_features
    for bi, n_layers in enumerate(cfg.block_config, start=1):
        for li in range(1, n_layers + 1):
            pre = f"features.denseblock{bi}.denselayer{li}."
            bn(pre + "norm1", c + (li - 1) * cfg.growth_rate)
            conv(pre + "conv1", cfg.bn_size * cfg.growth_rate,
                 c + (li - 1) * cfg.growth_rate, 1)
            bn(pre + "norm2", cfg.bn_size * cfg.growth_rate)
            conv(pre + "conv2", cfg.growth_rate,
                 cfg.bn_size * cfg.growth_rate, 3)
        c += n_layers * cfg.growth_rate
        if bi != len(cfg.block_config):
            pre = f"features.transition{bi}."
            bn(pre + "norm", c)
            conv(pre + "conv", c // 2, c, 1)
            c //= 2
    bn("features.norm5", c)
    p["classifier.weight"] = (rng.standard_normal((cfg.num_classes, c))
                              * 0.01).astype(np.float32)
    p["classifier.bias"] = np.zeros((cfg.num_classes,), np.float32)
    return p


def _conv(in_c: int, out_c: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_c, out_c, k, stride=stride, padding=(k - 1) // 2,
                     bias=False)


class _DenseLayer(nn.Module):
    def __init__(self, in_c: int, cfg: DenseNetConfig):
        super().__init__()
        mid = cfg.bn_size * cfg.growth_rate
        self.norm1 = FrozenBN(in_c, cfg.bn_eps)
        self.conv1 = _conv(in_c, mid, 1)
        self.norm2 = FrozenBN(mid, cfg.bn_eps)
        self.conv2 = _conv(mid, cfg.growth_rate, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(h)))


class _Transition(nn.Module):
    def __init__(self, in_c: int, eps: float):
        super().__init__()
        self.norm, self.conv = FrozenBN(in_c, eps), _conv(in_c, in_c // 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2, 2)


class DenseNet(nn.Module):
    """Inference DenseNet trunk; ``forward(images, taps)`` returns the
    tapped dense blocks' [B, C, H, W] maps."""

    family = "densenet"

    def __init__(self, cfg: DenseNetConfig):
        super().__init__()
        self.cfg = cfg
        f = nn.Module()
        f.conv0 = nn.Conv2d(3, cfg.num_init_features, 7, stride=2,
                            padding=3, bias=False)
        f.norm0 = FrozenBN(cfg.num_init_features, cfg.bn_eps)
        c = cfg.num_init_features
        for bi, n_layers in enumerate(cfg.block_config, start=1):
            block = nn.Module()
            for li in range(1, n_layers + 1):
                block.add_module(f"denselayer{li}", _DenseLayer(
                    c + (li - 1) * cfg.growth_rate, cfg))
            f.add_module(f"denseblock{bi}", block)
            c += n_layers * cfg.growth_rate
            if bi != len(cfg.block_config):
                f.add_module(f"transition{bi}", _Transition(c, cfg.bn_eps))
                c //= 2
        f.norm5 = FrozenBN(c, cfg.bn_eps)
        self.features = f
        self.classifier = nn.Linear(c, cfg.num_classes)

    def forward(self, images: torch.Tensor,
                taps: Sequence[str] = ("denseblock2", "denseblock3")
                ) -> dict[str, torch.Tensor]:
        taps = tuple(taps)
        deepest = max(int(t[-1]) for t in taps)
        f = self.features
        x = F.max_pool2d(F.relu(f.norm0(f.conv0(images))), 3, 2, 1)
        out: dict[str, torch.Tensor] = {}
        for bi in range(1, deepest + 1):
            for layer in getattr(f, f"denseblock{bi}").children():
                x = torch.cat([x, layer(x)], dim=1)
            if f"denseblock{bi}" in taps:
                out[f"denseblock{bi}"] = x
            if bi < deepest:
                x = getattr(f, f"transition{bi}")(x)
        return out
