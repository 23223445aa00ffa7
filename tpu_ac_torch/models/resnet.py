"""ResNet / WideResNet / ResNeXt trunk as an ``nn.Module`` (port of
``tpu_ac.models.resnet``).

PatchCore's flagship backbone is torchvision's ``wide_resnet50_2`` tapped at
layer2 + layer3.  ``state_dict`` keys are torchvision's (``conv1.weight``,
``layer2.3.bn1.running_mean``, ``downsample.0.weight``, ``fc.bias``), the
keys of ``tpu_ac``'s params dict, so one set of weights feeds both packages
(``models/convert.py``); ``num_batches_tracked`` is not a key, as in
``tpu_ac``.  BatchNorm is frozen inference BN with running statistics:
PatchCore never trains the trunk.  The stride sits on the 3x3 conv of a
bottleneck (torchvision v1.5), the max pool pads with -inf
(``F.max_pool2d``), and ``forward`` stops after the deepest tapped stage.
Convs are ``nn.Conv2d`` in NCHW; their precision follows the enclosing
``device.precision_scope`` (TF32 allowed under "default").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_ac_torch.models.layers import FrozenBN as _FrozenBN


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    block_counts: tuple[int, ...] = (3, 4, 6, 3)  # resnet50
    width_per_group: int = 64                     # 128 for wide_resnet50_2
    expansion: int = 4                            # 1 for BasicBlock nets
    block: str = "bottleneck"                     # "bottleneck" | "basic"
    groups: int = 1                               # 32 for ResNeXt
    bn_eps: float = 1e-5
    num_classes: int = 1000

    @property
    def stage_out_channels(self) -> tuple[int, ...]:
        # expansion * base planes (64, 128, 256, 512), whatever the inner
        # width: a wide resnet widens only the 3x3 convs
        return tuple(64 * (2 ** i) * self.expansion for i in range(4))


RESNET50 = ResNetConfig()
WIDE_RESNET50_2 = ResNetConfig(width_per_group=128)
RESNET101 = ResNetConfig(block_counts=(3, 4, 23, 3))
WIDE_RESNET101_2 = ResNetConfig(block_counts=(3, 4, 23, 3),
                                width_per_group=128)
RESNET18 = ResNetConfig(block_counts=(2, 2, 2, 2), expansion=1,
                        block="basic")
RESNET34 = ResNetConfig(block_counts=(3, 4, 6, 3), expansion=1,
                        block="basic")
RESNEXT101_32X8D = ResNetConfig(block_counts=(3, 4, 23, 3), groups=32,
                                width_per_group=8)
RESNET200 = ResNetConfig(block_counts=(3, 24, 36, 3))

_STAGES = ("layer1", "layer2", "layer3", "layer4")
_PLANES = (64, 128, 256, 512)


def _bottleneck_width(planes: int, cfg: ResNetConfig) -> int:
    # torchvision: width = planes * (base_width / 64) * groups
    return planes * cfg.width_per_group // 64 * cfg.groups


def init_resnet_params(seed: int, cfg: ResNetConfig) -> dict[str, np.ndarray]:
    """Kaiming-style random init with identity BN running stats; the same
    draws in the same order as ``tpu_ac.models.resnet.init_resnet_params``,
    so the arrays are bit-identical."""
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

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    in_c = 64
    for li, (n_blocks, planes) in enumerate(zip(cfg.block_counts, _PLANES)):
        out_c = planes * cfg.expansion
        for b in range(n_blocks):
            pre = f"layer{li + 1}.{b}."
            if cfg.block == "basic":
                conv(pre + "conv1", out_c, in_c, 3)
                bn(pre + "bn1", out_c)
                conv(pre + "conv2", out_c, out_c, 3)
                bn(pre + "bn2", out_c)
                needs_down = b == 0 and (li > 0 or in_c != out_c)
            else:
                width = _bottleneck_width(planes, cfg)
                conv(pre + "conv1", width, in_c, 1)
                bn(pre + "bn1", width)
                conv(pre + "conv2", width, width // cfg.groups, 3)
                bn(pre + "bn2", width)
                conv(pre + "conv3", out_c, width, 1)
                bn(pre + "bn3", out_c)
                needs_down = b == 0
            if needs_down:
                conv(pre + "downsample.0", out_c, in_c, 1)
                bn(pre + "downsample.1", out_c)
            in_c = out_c
    p["fc.weight"] = (rng.standard_normal((cfg.num_classes, in_c)) * 0.01
                      ).astype(np.float32)
    p["fc.bias"] = np.zeros((cfg.num_classes,), np.float32)
    return p


def _conv(in_c: int, out_c: int, k: int, stride: int = 1,
          groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_c, out_c, k, stride=stride, padding=(k - 1) // 2,
                     groups=groups, bias=False)


def _downsample(in_c: int, out_c: int, stride: int, eps: float):
    return nn.Sequential(_conv(in_c, out_c, 1, stride), _FrozenBN(out_c, eps))


class _Bottleneck(nn.Module):
    def __init__(self, in_c: int, width: int, out_c: int, stride: int,
                 groups: int, eps: float, down: bool):
        super().__init__()
        self.conv1, self.bn1 = _conv(in_c, width, 1), _FrozenBN(width, eps)
        self.conv2 = _conv(width, width, 3, stride, groups)
        self.bn2 = _FrozenBN(width, eps)
        self.conv3, self.bn3 = _conv(width, out_c, 1), _FrozenBN(out_c, eps)
        self.downsample = _downsample(in_c, out_c, stride, eps) \
            if down else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class _BasicBlock(nn.Module):
    def __init__(self, in_c: int, out_c: int, stride: int, eps: float,
                 down: bool):
        super().__init__()
        self.conv1 = _conv(in_c, out_c, 3, stride)
        self.bn1 = _FrozenBN(out_c, eps)
        self.conv2, self.bn2 = _conv(out_c, out_c, 3), _FrozenBN(out_c, eps)
        self.downsample = _downsample(in_c, out_c, stride, eps) \
            if down else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Inference ResNet trunk; ``forward(images, taps)`` returns the tapped
    stages' [B, C, H, W] maps.  The registry builds it without initialising
    its tensors and loads them with ``models.convert.load_jax_params``."""

    family = "resnet"

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        eps = cfg.bn_eps
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _FrozenBN(64, eps)
        in_c = 64
        for li, (n_blocks, planes) in enumerate(zip(cfg.block_counts,
                                                     _PLANES)):
            out_c = planes * cfg.expansion
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (li > 0 and b == 0) else 1
                if cfg.block == "basic":
                    down = b == 0 and (li > 0 or in_c != out_c)
                    blocks.append(_BasicBlock(in_c, out_c, stride, eps,
                                              down))
                else:
                    blocks.append(_Bottleneck(
                        in_c, _bottleneck_width(planes, cfg), out_c, stride,
                        cfg.groups, eps, b == 0))
                in_c = out_c
            setattr(self, _STAGES[li], nn.Sequential(*blocks))
        self.fc = nn.Linear(in_c, cfg.num_classes)

    def forward(self, images: torch.Tensor,
                taps: Sequence[str] = ("layer2", "layer3")
                ) -> dict[str, torch.Tensor]:
        """{stage: [B, C, H, W]} for the tapped stages; stops after the
        deepest one (the reference's hook early-abort)."""
        taps = tuple(taps)
        deepest = max(_STAGES.index(t) for t in taps)
        x = F.relu(self.bn1(self.conv1(images)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        out: dict[str, torch.Tensor] = {}
        for stage in _STAGES[:deepest + 1]:
            x = getattr(self, stage)(x)
            if stage in taps:
                out[stage] = x
        return out


def resnet_classify(model: ResNet, images: torch.Tensor) -> torch.Tensor:
    """Full forward to logits (global average pool + fc)."""
    x = model(images, taps=("layer4",))["layer4"]
    return model.fc(x.mean(dim=(2, 3)))
