"""Inception-v4 and BN-Inception trunks as ``nn.Module``s (port of
``tpu_ac.models.inception``).

Inception-v4 keeps the Cadene/timm module tree: ``features.{i}`` with
BasicConv2d (``.conv`` + ``.bn``, eps 1e-3) units under their branch names
(``features.11.branch2.3.conv.weight``, ``features.19.branch1_1a.bn.bias``);
taps are ``features.{i}``.  BN-Inception keeps pretrainedmodels' flat names
(``inception_3a_double_3x3_1.weight`` with its ``_bn``); taps are
``inception_{3a..5b}``.  Both stop after the deepest tap.

The pooling rules are the upstream ones and differ between the two:
Inception-v4's average pools leave the padded zeros out of the count
(``count_include_pad=False``) while BN-Inception's count them (every window
divides by 9); BN-Inception's stride-2 max pools are ``ceil_mode=True``
without padding.  Asymmetric kernels such as (1, 7) come with their own
(0, 3) paddings.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_ac_torch.models.layers import FrozenBN


def _attach(root: nn.Module, dotted: str, module: nn.Module) -> None:
    """Register ``module`` at the dotted path under ``root``, making empty
    containers for the missing parents."""
    *parents, leaf = dotted.split(".")
    for name in parents:
        if not hasattr(root, name):
            root.add_module(name, nn.Module())
        root = getattr(root, name)
    root.add_module(leaf, module)


def _maxpool_ceil(x: torch.Tensor, k: int = 3, stride: int = 2
                  ) -> torch.Tensor:
    """MaxPool2d(k, s, padding=0, ceil_mode=True): windows start at 0 and
    the last one is clipped to the input."""
    return F.max_pool2d(x, k, stride, ceil_mode=True)


# ---------------------------------------------------------------------------
# Inception-v4
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InceptionV4Config:
    bn_eps: float = 1e-3

    @property
    def feature_channels(self) -> dict[int, int]:
        """Output channels at each features.{i} index."""
        ch = {0: 32, 1: 32, 2: 64, 3: 160, 4: 192, 5: 384}
        ch.update({i: 384 for i in range(6, 10)})
        ch[10] = 1024
        ch.update({i: 1024 for i in range(11, 18)})
        ch[18] = 1536
        ch.update({i: 1536 for i in range(19, 22)})
        return ch


INCEPTION_V4 = InceptionV4Config()

# (name suffix, in, out, kernel, stride, padding) per BasicConv2d, grouped
# by features index (Cadene's inceptionv4.py module tree)
_V4_BASIC = {
    0: [("", 3, 32, (3, 3), 2, 0)],
    1: [("", 32, 32, (3, 3), 1, 0)],
    2: [("", 32, 64, (3, 3), 1, 1)],
}
_V4_MIXED3A = [("conv", 64, 96, (3, 3), 2, 0)]
_V4_MIXED4A = [
    ("branch0.0", 160, 64, (1, 1), 1, 0),
    ("branch0.1", 64, 96, (3, 3), 1, 0),
    ("branch1.0", 160, 64, (1, 1), 1, 0),
    ("branch1.1", 64, 64, (1, 7), 1, (0, 3)),
    ("branch1.2", 64, 64, (7, 1), 1, (3, 0)),
    ("branch1.3", 64, 96, (3, 3), 1, 0),
]
_V4_MIXED5A = [("conv", 192, 192, (3, 3), 2, 0)]
_V4_INCEPTION_A = [
    ("branch0", 384, 96, (1, 1), 1, 0),
    ("branch1.0", 384, 64, (1, 1), 1, 0),
    ("branch1.1", 64, 96, (3, 3), 1, 1),
    ("branch2.0", 384, 64, (1, 1), 1, 0),
    ("branch2.1", 64, 96, (3, 3), 1, 1),
    ("branch2.2", 96, 96, (3, 3), 1, 1),
    ("branch3.1", 384, 96, (1, 1), 1, 0),
]
_V4_REDUCTION_A = [
    ("branch0", 384, 384, (3, 3), 2, 0),
    ("branch1.0", 384, 192, (1, 1), 1, 0),
    ("branch1.1", 192, 224, (3, 3), 1, 1),
    ("branch1.2", 224, 256, (3, 3), 2, 0),
]
_V4_INCEPTION_B = [
    ("branch0", 1024, 384, (1, 1), 1, 0),
    ("branch1.0", 1024, 192, (1, 1), 1, 0),
    ("branch1.1", 192, 224, (1, 7), 1, (0, 3)),
    ("branch1.2", 224, 256, (7, 1), 1, (3, 0)),
    ("branch2.0", 1024, 192, (1, 1), 1, 0),
    ("branch2.1", 192, 192, (7, 1), 1, (3, 0)),
    ("branch2.2", 192, 224, (1, 7), 1, (0, 3)),
    ("branch2.3", 224, 224, (7, 1), 1, (3, 0)),
    ("branch2.4", 224, 256, (1, 7), 1, (0, 3)),
    ("branch3.1", 1024, 128, (1, 1), 1, 0),
]
_V4_REDUCTION_B = [
    ("branch0.0", 1024, 192, (1, 1), 1, 0),
    ("branch0.1", 192, 192, (3, 3), 2, 0),
    ("branch1.0", 1024, 256, (1, 1), 1, 0),
    ("branch1.1", 256, 256, (1, 7), 1, (0, 3)),
    ("branch1.2", 256, 320, (7, 1), 1, (3, 0)),
    ("branch1.3", 320, 320, (3, 3), 2, 0),
]
_V4_INCEPTION_C = [
    ("branch0", 1536, 256, (1, 1), 1, 0),
    ("branch1_0", 1536, 384, (1, 1), 1, 0),
    ("branch1_1a", 384, 256, (1, 3), 1, (0, 1)),
    ("branch1_1b", 384, 256, (3, 1), 1, (1, 0)),
    ("branch2_0", 1536, 384, (1, 1), 1, 0),
    ("branch2_1", 384, 448, (3, 1), 1, (1, 0)),
    ("branch2_2", 448, 512, (1, 3), 1, (0, 1)),
    ("branch2_3a", 512, 256, (1, 3), 1, (0, 1)),
    ("branch2_3b", 512, 256, (3, 1), 1, (1, 0)),
    ("branch3.1", 1536, 256, (1, 1), 1, 0),
]


def _v4_module_specs(idx: int):
    if idx in _V4_BASIC:
        return _V4_BASIC[idx]
    if idx == 3:
        return _V4_MIXED3A
    if idx == 4:
        return _V4_MIXED4A
    if idx == 5:
        return _V4_MIXED5A
    if 6 <= idx <= 9:
        return _V4_INCEPTION_A
    if idx == 10:
        return _V4_REDUCTION_A
    if 11 <= idx <= 17:
        return _V4_INCEPTION_B
    if idx == 18:
        return _V4_REDUCTION_B
    if 19 <= idx <= 21:
        return _V4_INCEPTION_C
    raise KeyError(idx)


def init_inception_v4_params(seed: int, cfg: InceptionV4Config
                             ) -> dict[str, np.ndarray]:
    """Bit-identical to ``tpu_ac``'s ``init_inception_v4_params``."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def basic(prefix, in_c, out_c, kernel):
        kh, kw = kernel
        fan = in_c * kh * kw
        p[prefix + ".conv.weight"] = (
            rng.standard_normal((out_c, in_c, kh, kw))
            * np.sqrt(2.0 / fan)).astype(np.float32)
        p[prefix + ".bn.weight"] = np.ones((out_c,), np.float32)
        p[prefix + ".bn.bias"] = np.zeros((out_c,), np.float32)
        p[prefix + ".bn.running_mean"] = np.zeros((out_c,), np.float32)
        p[prefix + ".bn.running_var"] = np.ones((out_c,), np.float32)

    for idx in range(22):
        for suffix, in_c, out_c, kernel, _s, _pad in _v4_module_specs(idx):
            prefix = (f"features.{idx}" if not suffix
                      else f"features.{idx}.{suffix}")
            basic(prefix, in_c, out_c, kernel)
    return p


class _BasicConv(nn.Module):
    """conv (no bias) -> inference BN -> ReLU."""

    def __init__(self, in_c, out_c, kernel, stride, padding, eps):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = FrozenBN(out_c, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avgpool_noinc(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, 1, 1, count_include_pad=False): timm's Inception-v4."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionV4(nn.Module):
    """Inception-v4 features trunk; ``forward(images, taps)`` ->
    {"features.i": map}."""

    family = "inception_v4"
    trunk_precision = "highest"  # tpu_ac's forward runs at HIGHEST

    def __init__(self, cfg: InceptionV4Config):
        super().__init__()
        self.cfg = cfg
        self.features = nn.Module()
        for idx in range(22):
            unit = nn.Module()
            for suffix, in_c, out_c, kernel, stride, pad in \
                    _v4_module_specs(idx):
                conv = _BasicConv(in_c, out_c, kernel, stride, pad,
                                  cfg.bn_eps)
                if suffix:
                    _attach(unit, suffix, conv)
                else:
                    unit = conv
            self.features.add_module(str(idx), unit)

    def _run(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        m = getattr(self.features, str(idx))

        def b(path: str, y: torch.Tensor) -> torch.Tensor:
            return m.get_submodule(path)(y)

        def chain(paths, y):
            for path in paths:
                y = b(path, y)
            return y

        if idx in (0, 1, 2):
            return m(x)
        if idx == 3:   # Mixed3a: maxpool || conv
            return torch.cat([F.max_pool2d(x, 3, 2), b("conv", x)], 1)
        if idx == 4:   # Mixed4a
            return torch.cat([
                chain(("branch0.0", "branch0.1"), x),
                chain(("branch1.0", "branch1.1", "branch1.2", "branch1.3"),
                      x)], 1)
        if idx == 5:   # Mixed5a: conv || maxpool
            return torch.cat([b("conv", x), F.max_pool2d(x, 3, 2)], 1)
        if 6 <= idx <= 9:  # InceptionA
            return torch.cat([
                b("branch0", x),
                chain(("branch1.0", "branch1.1"), x),
                chain(("branch2.0", "branch2.1", "branch2.2"), x),
                b("branch3.1", _avgpool_noinc(x))], 1)
        if idx == 10:  # ReductionA
            return torch.cat([
                b("branch0", x),
                chain(("branch1.0", "branch1.1", "branch1.2"), x),
                F.max_pool2d(x, 3, 2)], 1)
        if 11 <= idx <= 17:  # InceptionB
            return torch.cat([
                b("branch0", x),
                chain(("branch1.0", "branch1.1", "branch1.2"), x),
                chain(("branch2.0", "branch2.1", "branch2.2", "branch2.3",
                       "branch2.4"), x),
                b("branch3.1", _avgpool_noinc(x))], 1)
        if idx == 18:  # ReductionB
            return torch.cat([
                chain(("branch0.0", "branch0.1"), x),
                chain(("branch1.0", "branch1.1", "branch1.2", "branch1.3"),
                      x),
                F.max_pool2d(x, 3, 2)], 1)
        # InceptionC
        b1_0 = b("branch1_0", x)
        b2_2 = chain(("branch2_0", "branch2_1", "branch2_2"), x)
        return torch.cat([
            b("branch0", x),
            b("branch1_1a", b1_0), b("branch1_1b", b1_0),
            b("branch2_3a", b2_2), b("branch2_3b", b2_2),
            b("branch3.1", _avgpool_noinc(x))], 1)

    def forward(self, images: torch.Tensor,
                taps: Sequence[str] = ("features.9", "features.17")
                ) -> dict[str, torch.Tensor]:
        tap_idx = {int(t.split(".")[1]) for t in taps}
        x = images
        out: dict[str, torch.Tensor] = {}
        for idx in range(max(tap_idx) + 1):
            x = self._run(idx, x)
            if idx in tap_idx:
                out[f"features.{idx}"] = x
        return out


# ---------------------------------------------------------------------------
# BN-Inception (pretrainedmodels layout, flat names)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BNInceptionConfig:
    bn_eps: float = 1e-5


BNINCEPTION = BNInceptionConfig()

# (1x1, 3x3_reduce, 3x3, d3x3_reduce, d3x3_1, d3x3_2, pool_proj, stride,
#  pool_kind) per inception module, the BN paper's channel plan;
# stride-2 modules drop the 1x1 and pool-proj branches and max-pool
_BNI_MODULES: dict[str, tuple] = {
    "3a": (64, 64, 64, 64, 96, 96, 32, 1, "avg"),
    "3b": (64, 64, 96, 64, 96, 96, 64, 1, "avg"),
    "3c": (0, 128, 160, 64, 96, 96, 0, 2, "max"),
    "4a": (224, 64, 96, 96, 128, 128, 128, 1, "avg"),
    "4b": (192, 96, 128, 96, 128, 128, 128, 1, "avg"),
    "4c": (160, 128, 160, 128, 160, 160, 128, 1, "avg"),
    "4d": (96, 128, 192, 160, 192, 192, 128, 1, "avg"),
    "4e": (0, 128, 192, 192, 256, 256, 0, 2, "max"),
    "5a": (352, 192, 320, 160, 224, 224, 128, 1, "avg"),
    "5b": (352, 192, 320, 192, 224, 224, 128, 1, "max"),
}
_BNI_ORDER = tuple(_BNI_MODULES)


def _bni_in_channels() -> dict[str, int]:
    """Input channels per inception module (the stem ends at 192)."""
    ch: dict[str, int] = {}
    cur = 192
    for name, spec in _BNI_MODULES.items():
        ch[name] = cur
        c1, _, c3, _, _, cd2, cp, stride, _ = spec
        cur = c1 + c3 + cd2 + cp + (cur if stride == 2 else 0)
    return ch


def _bni_convs():
    """(name, in, out, kernel) of every conv, in init order."""
    yield "conv1_7x7_s2", 3, 64, 7
    yield "conv2_3x3_reduce", 64, 64, 1
    yield "conv2_3x3", 64, 192, 3
    in_ch = _bni_in_channels()
    for name, (c1, cr3, c3, crd, cd1, cd2, cp, _s, _p) in \
            _BNI_MODULES.items():
        in_c, pre = in_ch[name], f"inception_{name}_"
        if c1:
            yield pre + "1x1", in_c, c1, 1
        yield pre + "3x3_reduce", in_c, cr3, 1
        yield pre + "3x3", cr3, c3, 3
        yield pre + "double_3x3_reduce", in_c, crd, 1
        yield pre + "double_3x3_1", crd, cd1, 3
        yield pre + "double_3x3_2", cd1, cd2, 3
        if cp:
            yield pre + "pool_proj", in_c, cp, 1


def init_bninception_params(seed: int, cfg: BNInceptionConfig
                            ) -> dict[str, np.ndarray]:
    """Bit-identical to ``tpu_ac``'s ``init_bninception_params``."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}
    for name, in_c, out_c, k in _bni_convs():
        fan = in_c * k * k
        p[name + ".weight"] = (rng.standard_normal((out_c, in_c, k, k))
                               * np.sqrt(2.0 / fan)).astype(np.float32)
        p[name + ".bias"] = np.zeros((out_c,), np.float32)
        p[name + "_bn.weight"] = np.ones((out_c,), np.float32)
        p[name + "_bn.bias"] = np.zeros((out_c,), np.float32)
        p[name + "_bn.running_mean"] = np.zeros((out_c,), np.float32)
        p[name + "_bn.running_var"] = np.ones((out_c,), np.float32)
    return p


class BNInception(nn.Module):
    """BN-Inception trunk; ``forward(images, taps)`` ->
    {"inception_XY": map}."""

    family = "bninception"
    trunk_precision = "highest"

    def __init__(self, cfg: BNInceptionConfig):
        super().__init__()
        self.cfg = cfg
        for name, in_c, out_c, k in _bni_convs():
            self.add_module(name, nn.Conv2d(in_c, out_c, k))
            self.add_module(name + "_bn", FrozenBN(out_c, cfg.bn_eps))

    def _conv(self, name: str, x: torch.Tensor, stride: int = 1,
              padding: int = 0) -> torch.Tensor:
        conv = getattr(self, name)
        x = F.conv2d(x, conv.weight, conv.bias, stride, padding)
        return F.relu(getattr(self, name + "_bn")(x))

    def forward(self, images: torch.Tensor,
                taps: Sequence[str] = ("inception_3c", "inception_4e")
                ) -> dict[str, torch.Tensor]:
        tap_names = {t.split("_", 1)[1] for t in taps}
        deepest = max(_BNI_ORDER.index(n) for n in tap_names)
        x = _maxpool_ceil(self._conv("conv1_7x7_s2", images, 2, 3))
        x = self._conv("conv2_3x3_reduce", x)
        x = _maxpool_ceil(self._conv("conv2_3x3", x, 1, 1))
        out: dict[str, torch.Tensor] = {}
        for name in _BNI_ORDER[:deepest + 1]:
            c1, _, _, _, _, _, _cp, stride, pool_kind = _BNI_MODULES[name]
            pre = f"inception_{name}_"
            branches = []
            if c1:
                branches.append(self._conv(pre + "1x1", x))
            y = self._conv(pre + "3x3_reduce", x)
            branches.append(self._conv(pre + "3x3", y, stride, 1))
            y = self._conv(pre + "double_3x3_reduce", x)
            y = self._conv(pre + "double_3x3_1", y, 1, 1)
            branches.append(self._conv(pre + "double_3x3_2", y, stride, 1))
            if stride == 2:
                branches.append(_maxpool_ceil(x))
            else:
                # BN-Inception's average pools count the padded zeros
                pooled = (F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)
                          if pool_kind == "avg" else F.max_pool2d(x, 3, 1, 1))
                branches.append(self._conv(pre + "pool_proj", pooled))
            x = torch.cat(branches, 1)
            if name in tap_names:
                out[f"inception_{name}"] = x
        return out
