"""Trainable-BatchNorm ResNets for the SCAN stages (port of
``tpu_ac.models.resnet_cifar``).

Rebuild of Unsupervised-Classification-master/models/resnet_cifar.py (and
resnet_stl.py): 3x3 stem (stride 1, no maxpool for CIFAR; STL keeps the
maxpool), four BasicBlock stages [2,2,2,2] at widths 64/128/256/512.
``bottleneck=True`` + ``imagenet_stem=True`` gives the torchvision-layout
ResNet-50 of the ImageNet SCAN configs (7x7/s2 stem + maxpool, Bottleneck
blocks [3,4,6,3], stride on the 3x3 conv, ``downsample.{0,1}``), so a
remapped MoCo-v2 checkpoint loads key for key.

The state is ``tpu_ac``'s: ``params`` (the trainable tensors) and
``bn_state`` (the running statistics), flat dicts keyed like the torch
state_dict, with SCAN's names (the basic block's projection is
``shortcut``, the bottleneck's ``downsample``).  ``CifarResNet`` is an
``nn.Module`` with those names; ``cifar_resnet_forward`` binds a state to
one built on the meta device and returns the new running statistics
beside the features, the functional form ``tpu_ac`` has.  BatchNorm is
torch's (``F.batch_norm``), which ``tpu_ac``'s ``_bn`` mirrors: the biased
batch variance normalizes, the unbiased one moves the running variance,
momentum 0.1, eps 1e-5; train mode updates the statistics, eval mode reads
them.  In a ``torch.distributed`` group of more than one process, train
mode takes the statistics over the global batch (sync-BN, what ``tpu_ac``'s
jit over the sharded batch computes): the per-channel sum, sum of squares
and count all-reduced in one bucket, and in the backward the sums of the
gradient (``_GlobalBatchNorm``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_ac_torch.distributed import collectives

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CifarResNetConfig:
    block_counts: tuple[int, ...] = (2, 2, 2, 2)
    widths: tuple[int, ...] = (64, 128, 256, 512)
    stem_maxpool: bool = False  # True for the STL variant
    bottleneck: bool = False    # Bottleneck blocks + torchvision names
    imagenet_stem: bool = False  # 7x7/s2 conv + maxpool stem
    bn_eps: float = 1e-5
    bn_momentum: float = 0.1

    @property
    def expansion(self) -> int:
        return 4 if self.bottleneck else 1

    @property
    def feature_dim(self) -> int:
        return self.widths[-1] * self.expansion

    @property
    def shortcut_name(self) -> str:
        # SCAN's cifar resnet calls the projection "shortcut"
        # (resnet_cifar.py:28-33); torchvision calls it "downsample".
        return "downsample" if self.bottleneck else "shortcut"


RESNET18_CIFAR = CifarResNetConfig()
RESNET18_STL = CifarResNetConfig(stem_maxpool=True)
RESNET50_IMAGENET = CifarResNetConfig(
    block_counts=(3, 4, 6, 3), bottleneck=True, imagenet_stem=True,
    stem_maxpool=True)


def _has_projection(cfg: CifarResNetConfig, li: int, b: int,
                    in_c: int) -> bool:
    return in_c != cfg.widths[li] * cfg.expansion or (li > 0 and b == 0)


def init_cifar_resnet(seed: int, cfg: CifarResNetConfig
                      ) -> tuple[dict[str, np.ndarray],
                                 dict[str, np.ndarray]]:
    """(params, bn_state) as f32 numpy arrays: the same draws in the same
    order as ``tpu_ac``'s ``init_cifar_resnet``, so bit-identical."""
    rng = np.random.default_rng(seed)
    params: dict[str, np.ndarray] = {}
    state: dict[str, np.ndarray] = {}

    def conv(name, out_c, in_c, k):
        fan = in_c * k * k
        params[name + ".weight"] = (
            rng.standard_normal((out_c, in_c, k, k)) * math.sqrt(2.0 / fan)
        ).astype(np.float32)

    def bn(name, c):
        params[name + ".weight"] = np.ones((c,), np.float32)
        params[name + ".bias"] = np.zeros((c,), np.float32)
        state[name + ".running_mean"] = np.zeros((c,), np.float32)
        state[name + ".running_var"] = np.ones((c,), np.float32)

    conv("conv1", cfg.widths[0], 3, 7 if cfg.imagenet_stem else 3)
    bn("bn1", cfg.widths[0])
    sc = cfg.shortcut_name
    in_c = cfg.widths[0]
    for li, (n_blocks, width) in enumerate(zip(cfg.block_counts, cfg.widths)):
        for b in range(n_blocks):
            pre = f"layer{li + 1}.{b}."
            out_c = width * cfg.expansion
            if cfg.bottleneck:
                conv(pre + "conv1", width, in_c, 1)
                bn(pre + "bn1", width)
                conv(pre + "conv2", width, width, 3)
                bn(pre + "bn2", width)
                conv(pre + "conv3", out_c, width, 1)
                bn(pre + "bn3", out_c)
            else:
                conv(pre + "conv1", width, in_c, 3)
                bn(pre + "bn1", width)
                conv(pre + "conv2", width, width, 3)
                bn(pre + "bn2", width)
            if _has_projection(cfg, li, b, in_c):
                conv(pre + sc + ".0", out_c, in_c, 1)
                bn(pre + sc + ".1", out_c)
            in_c = out_c
    return params, state


class BatchNorm(nn.Module):
    """BatchNorm2d as SCAN trains it: affine, running statistics (no
    ``num_batches_tracked``, which ``tpu_ac``'s state lacks)."""

    def __init__(self, c: int, eps: float, momentum: float):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # train mode updates the running buffers in place
        if self.training and collectives.process_count() > 1:
            return self._global_batch_norm(x)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, self.training,
                            self.momentum, self.eps)

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over every rank's batch: normalized by the biased
        global variance, the running variance moved by the unbiased one, as
        F.batch_norm does on one batch."""
        y, mean, var, n = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                                 self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean * m)
            self.running_var.mul_(1 - m).add_(var * (n / (n - 1)) * m)
        return y


class _GlobalBatchNorm(torch.autograd.Function):
    """y = x_hat w + b with x_hat = (x - mean) / sqrt(var + eps), the
    statistics over the global batch: each rank's per-channel sum, sum of
    squares and count all-reduced in one bucket.  The backward is the
    analytic one of F.batch_norm (and of torch's SyncBatchNorm) over the
    global batch: the per-channel sums of dy and dy x_hat all-reduced in
    one bucket, dx = w / std (dy - mean(dy) - x_hat mean(dy x_hat)); w and
    b get this rank's sums, which the step averages over the ranks.

    The per-channel sums accumulate in float64: the variance as E[x^2] -
    E[x]^2 subtracts two terms that are large wherever a channel's mean is
    large against its spread (after a ReLU), which f32 sums would lose.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        f64 = torch.float64
        stats = collectives.all_reduce_sum(torch.cat([
            x.sum(dim=(0, 2, 3), dtype=f64),
            (x * x).sum(dim=(0, 2, 3), dtype=f64),
            x.new_full((1,), x.numel() // c, dtype=f64)]))
        n = stats[2 * c]
        mean64 = stats[:c] / n
        var64 = stats[c:2 * c] / n - mean64.square()
        mean, var = mean64.to(x.dtype), var64.to(x.dtype)
        invstd = torch.rsqrt(var64 + eps).to(x.dtype)
        x_hat = (x - mean[None, :, None, None]) * invstd[None, :, None, None]
        ctx.save_for_backward(x_hat, weight, invstd, n)
        ctx.mark_non_differentiable(mean, var, n)
        return (x_hat * weight[None, :, None, None]
                + bias[None, :, None, None], mean, var, n.to(x.dtype))

    @staticmethod
    def backward(ctx, dy, _mean, _var, _n):
        x_hat, weight, invstd, n = ctx.saved_tensors
        c = dy.shape[1]
        f64 = torch.float64
        sum_dy = dy.sum(dim=(0, 2, 3), dtype=f64)
        sum_dy_xhat = (dy * x_hat).sum(dim=(0, 2, 3), dtype=f64)
        g = collectives.all_reduce_sum(torch.cat([sum_dy, sum_dy_xhat]))
        mean_dy = (g[:c] / n).to(dy.dtype)
        mean_dy_xhat = (g[c:] / n).to(dy.dtype)
        dx = (dy - mean_dy[None, :, None, None]
              - x_hat * mean_dy_xhat[None, :, None, None]) \
            * (weight * invstd)[None, :, None, None]
        return dx, sum_dy_xhat.to(dy.dtype), sum_dy.to(dy.dtype), None


def _conv(in_c: int, out_c: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_c, out_c, k, stride=stride, padding=(k - 1) // 2,
                     bias=False)


class _Block(nn.Module):
    """BasicBlock, or the torchvision Bottleneck (ResNet v1.5: 1x1 ->
    3x3(stride) -> 1x1 expand); the projection under ``cfg.shortcut_name``."""

    def __init__(self, cfg: CifarResNetConfig, in_c: int, width: int,
                 stride: int, projection: bool):
        super().__init__()
        eps, m = cfg.bn_eps, cfg.bn_momentum
        out_c = width * cfg.expansion
        self.bottleneck = cfg.bottleneck
        if cfg.bottleneck:
            self.conv1, self.bn1 = _conv(in_c, width, 1), BatchNorm(width, eps,
                                                                    m)
            self.conv2 = _conv(width, width, 3, stride)
            self.bn2 = BatchNorm(width, eps, m)
            self.conv3, self.bn3 = _conv(width, out_c, 1), BatchNorm(out_c,
                                                                     eps, m)
        else:
            self.conv1 = _conv(in_c, width, 3, stride)
            self.bn1 = BatchNorm(width, eps, m)
            self.conv2, self.bn2 = _conv(width, width, 3), BatchNorm(width,
                                                                     eps, m)
        self.sc_name = cfg.shortcut_name
        if projection:
            self.add_module(self.sc_name, nn.Sequential(
                _conv(in_c, out_c, 1, stride), BatchNorm(out_c, eps, m)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        if self.bottleneck:
            out = F.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
        else:
            out = self.bn2(self.conv2(out))
        proj = self._modules.get(self.sc_name)
        return F.relu(out + (x if proj is None else proj(x)))


class CifarResNet(nn.Module):
    """The SCAN backbone: ``forward(images [B, 3, H, W]) -> [B,
    feature_dim]`` (global average pool of the last stage)."""

    def __init__(self, cfg: CifarResNetConfig):
        super().__init__()
        self.cfg = cfg
        w0 = cfg.widths[0]
        self.conv1 = (nn.Conv2d(3, w0, 7, stride=2, padding=3, bias=False)
                      if cfg.imagenet_stem else _conv(3, w0, 3))
        self.bn1 = BatchNorm(w0, cfg.bn_eps, cfg.bn_momentum)
        in_c = w0
        for li, (n_blocks, width) in enumerate(zip(cfg.block_counts,
                                                   cfg.widths)):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (li > 0 and b == 0) else 1
                blocks.append(_Block(cfg, in_c, width, stride,
                                     _has_projection(cfg, li, b, in_c)))
                in_c = width * cfg.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.n_stages = len(cfg.block_counts)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(images)))
        if self.cfg.stem_maxpool:
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for li in range(self.n_stages):
            x = getattr(self, f"layer{li + 1}")(x)
        return x.mean(dim=(2, 3))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.features(images)

    @contextlib.contextmanager
    def bound(self, params: Params, bn_state: Params):
        """Run the block with ``params`` and ``bn_state`` (name -> tensor,
        every parameter and buffer) in place of the module's own.  Train
        mode writes the new running statistics into the ``bn_state``
        tensors."""
        slots = self.__dict__.get("_slot_table")
        if slots is None:  # the module's structure is fixed: walk it once
            slots = self.__dict__["_slot_table"] = _slots(self)
        for kind, given in (("_parameters", params), ("_buffers", bn_state)):
            if given.keys() != slots[kind].keys():
                want = slots[kind].keys()
                raise KeyError(
                    f"{kind[1:]} do not match the model: missing "
                    f"{sorted(want - given.keys())[:3]}, unexpected "
                    f"{sorted(given.keys() - want)[:3]}")
        saved = []
        try:
            for kind, given in (("_parameters", params),
                                ("_buffers", bn_state)):
                for name, t in given.items():
                    m, attr = slots[kind][name]
                    table = getattr(m, kind)
                    saved.append((table, attr, table[attr]))
                    table[attr] = t
            yield self
        finally:
            for table, attr, orig in reversed(saved):
                table[attr] = orig


def _slots(module: nn.Module) -> dict[str, dict]:
    """{"_parameters"|"_buffers": {flat name: (submodule, attr)}}."""
    out: dict[str, dict] = {"_parameters": {}, "_buffers": {}}
    for mname, m in module.named_modules():
        for kind in out:
            for attr, t in getattr(m, kind).items():
                if t is not None:
                    out[kind][f"{mname}.{attr}" if mname else attr] = (m,
                                                                       attr)
    return out


@functools.lru_cache(maxsize=None)
def build_cifar_resnet(cfg: CifarResNetConfig) -> CifarResNet:
    """The backbone on the meta device (no storage): bind a state to it
    with ``bound``.  One module per config, shared by every caller."""
    with torch.device("meta"):
        return CifarResNet(cfg)


def run_bound(model: nn.Module, params: Params, bn_state: Params, fn,
              *, train: bool):
    """``fn(model)`` with ``params`` and ``bn_state`` bound and the
    module in train or eval mode -> (fn's result, new bn_state).  Train
    mode updates copies of the statistics (the caller's stay as they
    were), eval mode returns ``bn_state`` itself."""
    names = list(bn_state)
    if train:
        # one multi-tensor copy instead of a launch per buffer
        bn_state = dict(zip(names, torch._foreach_mul(
            [bn_state[k] for k in names], 1.0)))
    else:
        bn_state = dict(bn_state)
    if model.training != train:
        model.train(train)
    with model.bound(params, bn_state):
        out = fn(model)
    return out, bn_state


def cifar_resnet_forward(params: Params, state: Params, images: torch.Tensor,
                         cfg: CifarResNetConfig, *, train: bool = False
                         ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """images [B, 3, H, W] -> (features [B, feature_dim], new_bn_state)."""
    return run_bound(build_cifar_resnet(cfg), params, state,
                     lambda m: m.features(images), train=train)
