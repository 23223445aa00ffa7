"""Swin Transformer trunk as an ``nn.Module`` (port of
``tpu_ac.models.swin``).

Keys are the microsoft/timm ones (``layers.i.blocks.j.attn.qkv.weight``,
``...attn.relative_position_bias_table``,
``layers.i.downsample.reduction.weight``).  The relative-position index
([w^2, w^2] into the (2w-1)^2 table) is a pure function of the window
size: it is a buffer outside the state dict (``reset_buffers`` fills it
again after ``to_empty``), as are the shifted
windows' additive masks (-100 between tokens from different pre-roll
regions, added before the softmax), made once per grid size and device.

A shifted block rolls the grid by -w/2, attends within windows, and rolls
back; the shift is off where the grid is no larger than the window.
Patch merging concatenates x0, x1, x2, x3 = (even, even), (odd, even),
(even, odd), (odd, odd) rows/columns, normalises and projects 4C -> 2C.
Taps ``layers.i`` are stage outputs before their merge, as [B, C, H, W];
``forward`` stops after the deepest tap, and without taps returns the
final normed grid under "final".
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from tpu_ac_torch.models.vit import _LayerNorm, _Linear, _Mlp


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    window_size: int = 7
    embed_dim: int = 128
    depths: tuple[int, ...] = (2, 2, 18, 2)
    num_heads: tuple[int, ...] = (4, 8, 16, 32)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ln_eps: float = 1e-5

    @property
    def stage_dims(self) -> tuple[int, ...]:
        return tuple(self.embed_dim * (2 ** i)
                     for i in range(len(self.depths)))


SWIN_TINY = SwinConfig(embed_dim=96, depths=(2, 2, 6, 2),
                       num_heads=(3, 6, 12, 24))
SWIN_SMALL = SwinConfig(embed_dim=96, depths=(2, 2, 18, 2),
                        num_heads=(3, 6, 12, 24))
SWIN_BASE = SwinConfig()  # swin_base_patch4_window7_224
SWIN_LARGE = SwinConfig(embed_dim=192, num_heads=(6, 12, 24, 48))


def init_swin_params(seed: int, cfg: SwinConfig) -> dict[str, np.ndarray]:
    """Bit-identical to ``tpu_ac.models.swin.init_swin_params``."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def lin(name, out_c, in_c, bias=True):
        p[name + ".weight"] = (rng.standard_normal((out_c, in_c))
                               * 0.02).astype(np.float32)
        if bias:
            p[name + ".bias"] = np.zeros((out_c,), np.float32)

    def ln(name, c):
        p[name + ".weight"] = np.ones((c,), np.float32)
        p[name + ".bias"] = np.zeros((c,), np.float32)

    d0 = cfg.embed_dim
    p["patch_embed.proj.weight"] = (
        rng.standard_normal((d0, 3, cfg.patch_size, cfg.patch_size))
        * math.sqrt(1.0 / (3 * cfg.patch_size ** 2))).astype(np.float32)
    p["patch_embed.proj.bias"] = np.zeros((d0,), np.float32)
    ln("patch_embed.norm", d0)
    w2 = (2 * cfg.window_size - 1) ** 2
    for li, (depth, nh) in enumerate(zip(cfg.depths, cfg.num_heads)):
        d = cfg.stage_dims[li]
        hidden = int(d * cfg.mlp_ratio)
        for b in range(depth):
            pre = f"layers.{li}.blocks.{b}."
            ln(pre + "norm1", d)
            lin(pre + "attn.qkv", 3 * d, d, bias=cfg.qkv_bias)
            lin(pre + "attn.proj", d, d)
            p[pre + "attn.relative_position_bias_table"] = (
                rng.standard_normal((w2, nh)) * 0.02).astype(np.float32)
            ln(pre + "norm2", d)
            lin(pre + "mlp.fc1", hidden, d)
            lin(pre + "mlp.fc2", d, hidden)
        if li < len(cfg.depths) - 1:
            pre = f"layers.{li}.downsample."
            ln(pre + "norm", 4 * d)
            lin(pre + "reduction", 2 * d, 4 * d, bias=False)
    ln("norm", cfg.stage_dims[-1])
    return p


def relative_position_index(w: int) -> np.ndarray:
    """[w^2, w^2] indices into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def shifted_window_mask(h: int, ww: int, w: int, shift: int) -> np.ndarray:
    """Additive attention mask [nW, w^2, w^2] of the shifted windows:
    -100 between tokens from different pre-roll regions, else 0."""
    img = np.zeros((h, ww), np.float32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    windows = (img.reshape(h // w, w, ww // w, w)
               .transpose(0, 2, 1, 3).reshape(-1, w * w))
    mask = windows[:, None, :] - windows[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, w*w, C]."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _window_reverse(x: torch.Tensor, w: int, h: int, ww: int
                    ) -> torch.Tensor:
    """[B*nW, w*w, C] -> [B, H, W, C]."""
    c = x.shape[-1]
    b = x.shape[0] // ((h // w) * (ww // w))
    x = x.reshape(b, h // w, ww // w, w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, c)


class _WindowAttention(nn.Module):
    def __init__(self, d: int, nh: int, w: int, qkv_bias: bool):
        super().__init__()
        self.nh = nh
        self.qkv = _Linear(d, 3 * d, qkv_bias)
        self.proj = _Linear(d, d)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * w - 1) ** 2, nh))

    def forward(self, x: torch.Tensor, index: torch.Tensor,
                mask: torch.Tensor | None) -> torch.Tensor:
        """x: [nW*B, w*w, C] windows."""
        nwb, n, c = x.shape
        nh, hd = self.nh, c // self.nh
        qkv = self.qkv(x).reshape(nwb, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [nW*B, nh, n, hd]
        attn = torch.matmul(q, k.transpose(-2, -1)) * (hd ** -0.5)
        bias = self.relative_position_bias_table[index]  # [n*n, nh]
        attn = attn + bias.reshape(n, n, nh).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(nwb // nw, nw, nh, n, n) + mask[:, None]
            attn = attn.reshape(nwb, nh, n, n)
        out = torch.matmul(torch.softmax(attn, dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(nwb, n, c))


class _SwinBlock(nn.Module):
    def __init__(self, d: int, nh: int, cfg: SwinConfig):
        super().__init__()
        self.norm1 = _LayerNorm(d, cfg.ln_eps)
        self.attn = _WindowAttention(d, nh, cfg.window_size, cfg.qkv_bias)
        self.norm2 = _LayerNorm(d, cfg.ln_eps)
        self.mlp = _Mlp(d, int(d * cfg.mlp_ratio))

    def forward(self, x: torch.Tensor, w: int, shift: int,
                index: torch.Tensor, mask: torch.Tensor | None
                ) -> torch.Tensor:
        """x: [B, H, W, C]."""
        _, h, ww, _ = x.shape
        y = self.norm1(x)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = _window_reverse(self.attn(_window_partition(y, w), index, mask),
                            w, h, ww)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class _PatchMerging(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.norm = _LayerNorm(4 * d, eps)
        self.reduction = _Linear(4 * d, 2 * d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, C] -> [B, H/2, W/2, 2C]."""
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class Swin(nn.Module):
    """Swin trunk; ``forward(images, taps)`` -> {"layers.i": [B, C, H, W]}."""

    family = "swin"
    trunk_precision = "highest"  # tpu_ac's forward runs at HIGHEST

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        d0, ps = cfg.embed_dim, cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d0, ps, stride=ps)
        self.patch_embed.norm = _LayerNorm(d0, cfg.ln_eps)
        self.layers = nn.ModuleList()
        for li, (depth, nh) in enumerate(zip(cfg.depths, cfg.num_heads)):
            d = cfg.stage_dims[li]
            stage = nn.Module()
            stage.blocks = nn.ModuleList(_SwinBlock(d, nh, cfg)
                                         for _ in range(depth))
            if li < len(cfg.depths) - 1:
                stage.downsample = _PatchMerging(d, cfg.ln_eps)
            self.layers.append(stage)
        self.norm = _LayerNorm(cfg.stage_dims[-1], cfg.ln_eps)
        w = cfg.window_size
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(w).reshape(-1)), persistent=False)
        self._masks: dict = {}

    def reset_buffers(self) -> None:
        """Fill the buffers outside the state dict (a module built on the
        meta device and moved with ``to_empty`` holds garbage there)."""
        idx = relative_position_index(self.cfg.window_size).reshape(-1)
        with torch.no_grad():
            self.relative_position_index.copy_(torch.from_numpy(idx))
        self._masks = {}

    def _mask(self, h: int, ww: int, shift: int, like: torch.Tensor
              ) -> torch.Tensor:
        key = (h, ww, shift, like.device, like.dtype)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shifted_window_mask(
                h, ww, self.cfg.window_size, shift)).to(like.device,
                                                        like.dtype)
        return self._masks[key]

    def forward(self, images: torch.Tensor, taps: Sequence[str] = ()
                ) -> dict[str, torch.Tensor]:
        cfg, w = self.cfg, self.cfg.window_size
        tap_idx = {int(t.split(".")[1]) for t in taps}
        last = max(tap_idx) if tap_idx else len(cfg.depths) - 1
        x = self.patch_embed.proj(images).permute(0, 2, 3, 1)
        x = self.patch_embed.norm(x)
        index = self.relative_position_index
        out: dict[str, torch.Tensor] = {}
        for li in range(last + 1):
            gh, gw = x.shape[1], x.shape[2]
            if gh % w or gw % w:
                raise ValueError(
                    f"stage {li} grid {gh}x{gw} not divisible by window {w}")
            stage = self.layers[li]
            for bi, block in enumerate(stage.blocks):
                # no shift where the grid is no larger than the window
                shift = 0 if (bi % 2 == 0 or min(gh, gw) <= w) else w // 2
                mask = self._mask(gh, gw, shift, x) if shift else None
                x = block(x, w, shift, index, mask)
            if li in tap_idx:
                out[f"layers.{li}"] = x.permute(0, 3, 1, 2)
                if li == last:
                    return out
            if li < len(cfg.depths) - 1:
                x = stage.downsample(x)
        out["final"] = self.norm(x).permute(0, 3, 1, 2)
        return out
