"""EfficientNet B-series, EfficientNetV2 and MnasNet trunks as
``nn.Module``s (port of ``tpu_ac.models.efficientnet``).

One block class covers the three families' blocks, in timm's layout and keys
(``conv_stem``, ``bn1``, ``blocks.S.B.{conv_pw,bn1,conv_dw,bn2,
se.conv_reduce,se.conv_expand,conv_pwl,bn3}``):

- "ds" DepthwiseSeparable: depthwise kxk -> [SE] -> 1x1 (no expansion);
- "ir" MBConv: 1x1 expand -> depthwise kxk -> [SE] -> 1x1 project;
- "cn" ConvBnAct: one kxk conv (``blocks.S.B.conv``);
- "er" EdgeResidual: kxk expand conv (``conv_exp``) -> 1x1 project.

Depthwise convs set ``groups`` to their channel count.  The tf_ ports
(``tf_same``) pad every kxk conv the TensorFlow "SAME" way, asymmetric at
stride 2 (``layers.Conv2d``); 1x1 convs never pad.  The squeeze-excite
gate is reduce -> act -> expand -> sigmoid on the global mean.
EfficientNet(V2) use SiLU, MnasNet ReLU.  A block adds its input back at
stride 1 when the widths agree.  Taps are ``stage1`` ... ``stage7``;
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

from tpu_ac_torch.models.layers import Conv2d, FrozenBN

# base B0 stage layout: (expand_ratio, channels, repeats, stride, kernel)
_B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def _round_channels(c: float, divisor: int = 8) -> int:
    """timm/tf channel rounding."""
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    width_mult: float = 1.0
    depth_mult: float = 1.0
    bn_eps: float = 1e-3  # tf variants use eps=1e-3
    se_ratio: float = 0.25
    tf_same: bool = True

    @property
    def stem_channels(self) -> int:
        return _round_channels(32 * self.width_mult)

    @property
    def stages(self):
        return tuple(
            (expand, _round_channels(c * self.width_mult),
             int(math.ceil(repeats * self.depth_mult)), stride, k)
            for expand, c, repeats, stride, k in _B0_STAGES)

    @property
    def block_specs(self):
        """(kind, expand, out, repeats, stride, kernel, se) per stage."""
        return tuple(("ds" if e == 1 else "ir", e, c, n, s, k, True)
                     for e, c, n, s, k in self.stages)


EFFICIENTNET_B0 = EfficientNetConfig()
EFFICIENTNET_B1 = EfficientNetConfig(1.0, 1.1)
EFFICIENTNET_B3 = EfficientNetConfig(1.2, 1.4)
EFFICIENTNET_B5 = EfficientNetConfig(1.6, 2.2)
EFFICIENTNET_B7 = EfficientNetConfig(2.0, 3.1)

# stage spec: (kind, expand, channels, repeats, stride, kernel, se)
_MNASNET_B1_STAGES = (
    ("ds", 1, 16, 1, 1, 3, False),
    ("ir", 3, 24, 3, 2, 3, False),
    ("ir", 3, 40, 3, 2, 5, False),
    ("ir", 6, 80, 3, 2, 5, False),
    ("ir", 6, 96, 2, 1, 3, False),
    ("ir", 6, 192, 4, 2, 5, False),
    ("ir", 6, 320, 1, 1, 3, False),
)
_MNASNET_A1_STAGES = (
    ("ds", 1, 16, 1, 1, 3, False),
    ("ir", 6, 24, 2, 2, 3, False),
    ("ir", 3, 40, 3, 2, 5, True),
    ("ir", 6, 80, 4, 2, 3, False),
    ("ir", 6, 112, 2, 1, 3, True),
    ("ir", 6, 160, 3, 2, 5, True),
    ("ir", 6, 320, 1, 1, 3, False),
)


@dataclasses.dataclass(frozen=True)
class MnasNetConfig:
    stages: tuple = _MNASNET_B1_STAGES
    stem_channels: int = 32
    bn_eps: float = 1e-5
    se_ratio: float = 0.25

    @property
    def block_specs(self):
        return self.stages


MNASNET_B1 = MnasNetConfig()
MNASNET_A1 = MnasNetConfig(stages=_MNASNET_A1_STAGES)

_EFFNETV2_M_STAGES = (
    ("cn", 1, 24, 3, 1, 3, False),
    ("er", 4, 48, 5, 2, 3, False),
    ("er", 4, 80, 5, 2, 3, False),
    ("ir", 4, 160, 7, 2, 3, True),
    ("ir", 6, 176, 14, 1, 3, True),
    ("ir", 6, 304, 18, 2, 3, True),
    ("ir", 6, 512, 5, 1, 3, True),
)
_EFFNETV2_L_STAGES = (
    ("cn", 1, 32, 4, 1, 3, False),
    ("er", 4, 64, 7, 2, 3, False),
    ("er", 4, 96, 7, 2, 3, False),
    ("ir", 4, 192, 10, 2, 3, True),
    ("ir", 6, 224, 19, 1, 3, True),
    ("ir", 6, 384, 25, 2, 3, True),
    ("ir", 6, 640, 7, 1, 3, True),
)


@dataclasses.dataclass(frozen=True)
class EfficientNetV2Config:
    stages: tuple = _EFFNETV2_M_STAGES
    stem_channels: int = 24
    bn_eps: float = 1e-3
    se_ratio: float = 0.25
    tf_same: bool = True

    @property
    def block_specs(self):
        return self.stages


EFFICIENTNETV2_M = EfficientNetV2Config()
EFFICIENTNETV2_L = EfficientNetV2Config(stages=_EFFNETV2_L_STAGES,
                                        stem_channels=32)


def _param_plan(cfg):
    """(name, out, in, kernel, groups, bias) of every conv and (name, c,
    None, ...) of every BN, in ``tpu_ac``'s init order."""
    yield "conv_stem", cfg.stem_channels, 3, 3, 1, False
    yield "bn1", cfg.stem_channels, None, 0, 0, False
    in_c = cfg.stem_channels
    for si, (kind, expand, out_c, repeats, _s, k, se) in enumerate(
            cfg.block_specs):
        for bi in range(repeats):
            pre = f"blocks.{si}.{bi}."
            se_c = max(1, int(in_c * cfg.se_ratio))
            if kind == "ds":
                yield pre + "conv_dw", in_c, in_c, k, in_c, False
                yield pre + "bn1", in_c, None, 0, 0, False
                if se:
                    yield pre + "se.conv_reduce", se_c, in_c, 1, 1, True
                    yield pre + "se.conv_expand", in_c, se_c, 1, 1, True
                yield pre + "conv_pw", out_c, in_c, 1, 1, False
                yield pre + "bn2", out_c, None, 0, 0, False
            elif kind == "cn":
                yield pre + "conv", out_c, in_c, k, 1, False
                yield pre + "bn1", out_c, None, 0, 0, False
            elif kind == "er":
                mid = in_c * expand
                yield pre + "conv_exp", mid, in_c, k, 1, False
                yield pre + "bn1", mid, None, 0, 0, False
                yield pre + "conv_pwl", out_c, mid, 1, 1, False
                yield pre + "bn2", out_c, None, 0, 0, False
            else:
                mid = in_c * expand
                yield pre + "conv_pw", mid, in_c, 1, 1, False
                yield pre + "bn1", mid, None, 0, 0, False
                yield pre + "conv_dw", mid, mid, k, mid, False
                yield pre + "bn2", mid, None, 0, 0, False
                if se:
                    yield pre + "se.conv_reduce", se_c, mid, 1, 1, True
                    yield pre + "se.conv_expand", mid, se_c, 1, 1, True
                yield pre + "conv_pwl", out_c, mid, 1, 1, False
                yield pre + "bn3", out_c, None, 0, 0, False
            in_c = out_c


def _init(seed: int, cfg) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}
    for name, out_c, in_c, k, groups, bias in _param_plan(cfg):
        if in_c is None:  # BN
            p[name + ".weight"] = np.ones((out_c,), np.float32)
            p[name + ".bias"] = np.zeros((out_c,), np.float32)
            p[name + ".running_mean"] = np.zeros((out_c,), np.float32)
            p[name + ".running_var"] = np.ones((out_c,), np.float32)
            continue
        fan = (in_c // groups) * k * k
        p[name + ".weight"] = (
            rng.standard_normal((out_c, in_c // groups, k, k))
            * math.sqrt(2.0 / fan)).astype(np.float32)
        if bias:
            p[name + ".bias"] = np.zeros((out_c,), np.float32)
    return p


def init_efficientnet_params(seed: int, cfg: EfficientNetConfig
                             ) -> dict[str, np.ndarray]:
    """Bit-identical to ``tpu_ac``'s ``init_efficientnet_params``."""
    return _init(seed, cfg)


def init_efficientnetv2_params(seed: int, cfg: EfficientNetV2Config
                               ) -> dict[str, np.ndarray]:
    """Bit-identical to ``tpu_ac``'s ``init_efficientnetv2_params``."""
    return _init(seed, cfg)


def init_mnasnet_params(seed: int, cfg: MnasNetConfig
                        ) -> dict[str, np.ndarray]:
    """Bit-identical to ``tpu_ac``'s ``init_mnasnet_params``."""
    return _init(seed, cfg)


class _SqueezeExcite(nn.Module):
    def __init__(self, c: int, se_c: int, act):
        super().__init__()
        self.conv_reduce = nn.Conv2d(c, se_c, 1)
        self.conv_expand = nn.Conv2d(se_c, c, 1)
        self.act = act

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """h times its gate: conv_reduce -> act -> conv_expand -> sigmoid
        of the global mean."""
        s = self.conv_reduce(h.mean((2, 3), keepdim=True))
        return h * torch.sigmoid(self.conv_expand(self.act(s)))


class _Block(nn.Module):
    def __init__(self, kind: str, in_c: int, out_c: int, expand: int,
                 stride: int, k: int, se: bool, cfg, act):
        super().__init__()
        same = getattr(cfg, "tf_same", False)
        eps = cfg.bn_eps
        se_c = max(1, int(in_c * cfg.se_ratio))
        self.kind, self.act = kind, act
        self.skip = stride == 1 and in_c == out_c

        def kxk(i, o, groups=1):
            return Conv2d(i, o, k, stride, k // 2, groups, tf_same=same)

        if kind == "ds":
            self.conv_dw, self.bn1 = kxk(in_c, in_c, in_c), FrozenBN(in_c, eps)
            self.se = _SqueezeExcite(in_c, se_c, act) if se else None
            self.conv_pw = nn.Conv2d(in_c, out_c, 1, bias=False)
            self.bn2 = FrozenBN(out_c, eps)
        elif kind == "cn":
            self.conv, self.bn1 = kxk(in_c, out_c), FrozenBN(out_c, eps)
        elif kind == "er":
            mid = in_c * expand
            self.conv_exp, self.bn1 = kxk(in_c, mid), FrozenBN(mid, eps)
            self.conv_pwl = nn.Conv2d(mid, out_c, 1, bias=False)
            self.bn2 = FrozenBN(out_c, eps)
        else:
            mid = in_c * expand
            self.conv_pw = nn.Conv2d(in_c, mid, 1, bias=False)
            self.bn1 = FrozenBN(mid, eps)
            self.conv_dw, self.bn2 = kxk(mid, mid, mid), FrozenBN(mid, eps)
            self.se = _SqueezeExcite(mid, se_c, act) if se else None
            self.conv_pwl = nn.Conv2d(mid, out_c, 1, bias=False)
            self.bn3 = FrozenBN(out_c, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act, kind = self.act, self.kind
        if kind == "ds":
            h = act(self.bn1(self.conv_dw(x)))
            if self.se is not None:
                h = self.se(h)
            h = self.bn2(self.conv_pw(h))
        elif kind == "cn":
            h = act(self.bn1(self.conv(x)))
        elif kind == "er":
            h = self.bn2(self.conv_pwl(act(self.bn1(self.conv_exp(x)))))
        else:
            h = act(self.bn1(self.conv_pw(x)))
            h = act(self.bn2(self.conv_dw(h)))
            if self.se is not None:
                h = self.se(h)
            h = self.bn3(self.conv_pwl(h))
        return h + x if self.skip else h


class _MBConvNet(nn.Module):
    """Stem conv (3x3/2) + BN + act, then the stages of
    ``cfg.block_specs``; ``forward(images, taps)`` -> {"stageN": map}."""

    act = staticmethod(F.silu)

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        same = getattr(cfg, "tf_same", False)
        self.conv_stem = Conv2d(3, cfg.stem_channels, 3, 2, 1, tf_same=same)
        self.bn1 = FrozenBN(cfg.stem_channels, cfg.bn_eps)
        self.blocks = nn.ModuleList()
        in_c = cfg.stem_channels
        for kind, expand, out_c, repeats, stride, k, se in cfg.block_specs:
            self.blocks.append(nn.Sequential(*(
                _Block(kind, in_c if bi == 0 else out_c, out_c, expand,
                       stride if bi == 0 else 1, k, se, cfg, self.act)
                for bi in range(repeats))))
            in_c = out_c

    def forward(self, images: torch.Tensor,
                taps: Sequence[str] = ("stage4", "stage6")
                ) -> dict[str, torch.Tensor]:
        deepest = max(int(t[-1]) for t in taps)
        x = self.act(self.bn1(self.conv_stem(images)))
        out: dict[str, torch.Tensor] = {}
        for si in range(deepest):
            x = self.blocks[si](x)
            if f"stage{si + 1}" in taps:
                out[f"stage{si + 1}"] = x
        return out


class EfficientNet(_MBConvNet):
    family = "efficientnet"


class EfficientNetV2(_MBConvNet):
    family = "efficientnetv2"


class MnasNet(_MBConvNet):
    family = "mnasnet"
    act = staticmethod(F.relu)
