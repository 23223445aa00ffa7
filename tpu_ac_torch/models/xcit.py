"""XCiT (cross-covariance image transformer) as an ``nn.Module`` (port of
``tpu_ac.models.xcit``), for DINO's ``dino_xcit_{small_12,medium_24}_
{p16,p8}``.

- ConvPatchEmbed (``patch_embed.proj.{0,2,4[,6]}``): stride-2 conv3x3 +
  BN stages down to the patch resolution, GELU between them.
- PositionalEncodingFourier (``pos_embeder``, the official spelling): fixed
  2-D sinusoids in f32, projected by a 1x1 conv and cast to the tokens'
  dtype at the add.
- XCA blocks: attention over channels.  q and k are L2-normalised over the
  tokens (norms clamped at 1e-12), the [hd, hd] product is scaled by a
  per-head ``temperature`` and softmaxed over channels; then LPI
  (depthwise conv3x3 -> GELU -> BN -> depthwise conv3x3 on the token grid)
  and the MLP, each with LayerScale (gamma1, gamma3, gamma2).
- Class-attention blocks: the CLS query attends over all tokens; the
  residual adds the whole concatenated tensor, which doubles the patch
  tokens, as the released code does.

``forward(images, taps)`` returns the tapped XCA blocks' [B, N, D] tokens
(no CLS) and stops after the deepest; ``xcit_cls_forward`` is the normed
CLS feature of the whole network.
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
from tpu_ac_torch.models.vit import _LayerNorm, _Linear, _Mlp


@dataclasses.dataclass(frozen=True)
class XCiTConfig:
    patch_size: int = 16
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 8
    mlp_ratio: float = 4.0
    cls_attn_layers: int = 2
    qkv_bias: bool = True
    eta: float = 1.0          # LayerScale init
    tokens_norm: bool = True
    ln_eps: float = 1e-6
    bn_eps: float = 1e-5
    pos_hidden_dim: int = 32
    pos_temperature: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def conv_stage_channels(self) -> tuple[int, ...]:
        d = self.embed_dim
        if self.patch_size == 16:
            return (d // 8, d // 4, d // 2, d)
        if self.patch_size == 8:
            return (d // 4, d // 2, d)
        raise ValueError(f"patch_size {self.patch_size} not in (8, 16)")


XCIT_SMALL_12_P16 = XCiTConfig(patch_size=16, embed_dim=384, depth=12)
XCIT_SMALL_12_P8 = XCiTConfig(patch_size=8, embed_dim=384, depth=12)
XCIT_MEDIUM_24_P16 = XCiTConfig(patch_size=16, embed_dim=512, depth=24)
XCIT_MEDIUM_24_P8 = XCiTConfig(patch_size=8, embed_dim=512, depth=24)


def init_xcit_params(seed: int, cfg: XCiTConfig) -> dict[str, np.ndarray]:
    """Bit-identical to ``tpu_ac.models.xcit.init_xcit_params``."""
    rng = np.random.default_rng(seed)
    d = cfg.embed_dim
    p: dict[str, np.ndarray] = {}

    def lin(name, out_c, in_c, bias=True):
        p[name + ".weight"] = (rng.standard_normal((out_c, in_c))
                               * 0.02).astype(np.float32)
        if bias:
            p[name + ".bias"] = np.zeros((out_c,), np.float32)

    def ln(name, c):
        p[name + ".weight"] = np.ones((c,), np.float32)
        p[name + ".bias"] = np.zeros((c,), np.float32)

    def bn(name, c):
        ln(name, c)
        p[name + ".running_mean"] = np.zeros((c,), np.float32)
        p[name + ".running_var"] = np.ones((c,), np.float32)

    in_c = 3
    for si, out_c in enumerate(cfg.conv_stage_channels):
        pre = f"patch_embed.proj.{2 * si}."
        p[pre + "0.weight"] = (rng.standard_normal((out_c, in_c, 3, 3))
                               * math.sqrt(2.0 / (in_c * 9))
                               ).astype(np.float32)
        bn(pre + "1", out_c)
        in_c = out_c
    p["cls_token"] = (rng.standard_normal((1, 1, d)) * 0.02).astype(
        np.float32)
    lin("pos_embeder.token_projection", d, 2 * cfg.pos_hidden_dim)
    # a 1x1 Conv2d: weight [d, 2*hidden, 1, 1]
    p["pos_embeder.token_projection.weight"] = p[
        "pos_embeder.token_projection.weight"].reshape(
            d, 2 * cfg.pos_hidden_dim, 1, 1)
    hidden = int(d * cfg.mlp_ratio)
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        ln(pre + "norm1", d)
        lin(pre + "attn.qkv", 3 * d, d, bias=cfg.qkv_bias)
        p[pre + "attn.temperature"] = np.ones((cfg.num_heads, 1, 1),
                                              np.float32)
        lin(pre + "attn.proj", d, d)
        ln(pre + "norm3", d)
        for conv in ("conv1", "conv2"):
            if conv == "conv2":
                bn(pre + "local_mp.bn", d)
            p[pre + f"local_mp.{conv}.weight"] = (
                rng.standard_normal((d, 1, 3, 3)) * math.sqrt(2.0 / 9)
            ).astype(np.float32)
            p[pre + f"local_mp.{conv}.bias"] = np.zeros((d,), np.float32)
        ln(pre + "norm2", d)
        lin(pre + "mlp.fc1", hidden, d)
        lin(pre + "mlp.fc2", d, hidden)
        for g in ("gamma1", "gamma2", "gamma3"):
            p[pre + g] = np.full((d,), cfg.eta, np.float32)
    for i in range(cfg.cls_attn_layers):
        pre = f"cls_attn_blocks.{i}."
        ln(pre + "norm1", d)
        lin(pre + "attn.qkv", 3 * d, d, bias=cfg.qkv_bias)
        lin(pre + "attn.proj", d, d)
        ln(pre + "norm2", d)
        lin(pre + "mlp.fc1", hidden, d)
        lin(pre + "mlp.fc2", d, hidden)
        p[pre + "gamma1"] = np.full((d,), cfg.eta, np.float32)
        p[pre + "gamma2"] = np.full((d,), cfg.eta, np.float32)
    ln("norm", d)
    return p


class _XCA(nn.Module):
    """Cross-covariance attention over channels."""

    def __init__(self, cfg: XCiTConfig):
        super().__init__()
        d, self.nh = cfg.embed_dim, cfg.num_heads
        self.qkv = _Linear(d, 3 * d, cfg.qkv_bias)
        self.temperature = nn.Parameter(torch.empty(cfg.num_heads, 1, 1))
        self.proj = _Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.nh, d // self.nh)
        q, k, v = qkv.permute(2, 0, 3, 4, 1)  # each [B, h, hd, N]
        q = F.normalize(q, dim=-1, eps=1e-12)
        k = F.normalize(k, dim=-1, eps=1e-12)
        attn = torch.matmul(q, k.transpose(-2, -1)) * self.temperature
        out = torch.matmul(torch.softmax(attn, dim=-1), v)  # [B, h, hd, N]
        return self.proj(out.permute(0, 3, 1, 2).reshape(b, n, d))


class _LPI(nn.Module):
    """Local patch interaction on the token grid."""

    def __init__(self, cfg: XCiTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.conv1 = nn.Conv2d(d, d, 3, padding=1, groups=d)
        self.bn = FrozenBN(d, cfg.bn_eps)
        self.conv2 = nn.Conv2d(d, d, 3, padding=1, groups=d)

    def forward(self, x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
        b, n, d = x.shape
        g = x.transpose(1, 2).reshape(b, d, hp, wp)
        g = self.conv2(self.bn(F.gelu(self.conv1(g), approximate="none")))
        return g.reshape(b, d, n).transpose(1, 2)


class _XCABlock(nn.Module):
    def __init__(self, cfg: XCiTConfig):
        super().__init__()
        d, eps = cfg.embed_dim, cfg.ln_eps
        self.norm1, self.attn = _LayerNorm(d, eps), _XCA(cfg)
        self.norm3, self.local_mp = _LayerNorm(d, eps), _LPI(cfg)
        self.norm2 = _LayerNorm(d, eps)
        self.mlp = _Mlp(d, int(d * cfg.mlp_ratio))
        for g in ("gamma1", "gamma2", "gamma3"):
            setattr(self, g, nn.Parameter(torch.empty(d)))

    def forward(self, x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
        x = x + self.gamma1 * self.attn(self.norm1(x))
        x = x + self.gamma3 * self.local_mp(self.norm3(x), hp, wp)
        return x + self.gamma2 * self.mlp(self.norm2(x))


class _ClassAttention(nn.Module):
    """The CLS query attends over every token; patch tokens pass."""

    def __init__(self, cfg: XCiTConfig):
        super().__init__()
        d, self.nh = cfg.embed_dim, cfg.num_heads
        self.qkv = _Linear(d, 3 * d, cfg.qkv_bias)
        self.proj = _Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.nh
        qkv = self.qkv(x).reshape(b, n, 3, self.nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each [B, h, N, hd]
        attn = torch.softmax((q[:, :, :1] * k).sum(-1) * hd ** -0.5, dim=-1)
        cls_tok = torch.einsum("bhn,bhnd->bhd", attn, v).reshape(b, 1, d)
        return torch.cat([self.proj(cls_tok), x[:, 1:]], dim=1)


class _ClassAttentionBlock(nn.Module):
    def __init__(self, cfg: XCiTConfig):
        super().__init__()
        d, eps = cfg.embed_dim, cfg.ln_eps
        self.tokens_norm = cfg.tokens_norm
        self.norm1, self.attn = _LayerNorm(d, eps), _ClassAttention(cfg)
        self.norm2 = _LayerNorm(d, eps)
        self.mlp = _Mlp(d, int(d * cfg.mlp_ratio))
        self.gamma1 = nn.Parameter(torch.empty(d))
        self.gamma2 = nn.Parameter(torch.empty(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.gamma1 * self.attn(self.norm1(x))
        if self.tokens_norm:
            x = self.norm2(x)
        else:
            x = torch.cat([self.norm2(x[:, :1]), x[:, 1:]], dim=1)
        cls_tok = self.gamma2 * self.mlp(x[:, :1])
        # the released code adds the whole concatenation: patch tokens x2
        return x + torch.cat([cls_tok, x[:, 1:]], dim=1)


class XCiT(nn.Module):
    """XCiT trunk; ``forward(images, taps)`` -> {i: [B, N, D]}."""

    family = "xcit"
    trunk_precision = "highest"  # tpu_ac's forward runs at HIGHEST

    def __init__(self, cfg: XCiTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        stages: list[nn.Module] = []
        in_c = 3
        for si, out_c in enumerate(cfg.conv_stage_channels):
            if si:
                stages.append(nn.GELU())
            stages.append(nn.Sequential(
                nn.Conv2d(in_c, out_c, 3, stride=2, padding=1, bias=False),
                FrozenBN(out_c, cfg.bn_eps)))
            in_c = out_c
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Sequential(*stages)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embeder = nn.Module()
        self.pos_embeder.token_projection = nn.Conv2d(
            2 * cfg.pos_hidden_dim, d, 1)
        self.blocks = nn.ModuleList(_XCABlock(cfg) for _ in range(cfg.depth))
        self.cls_attn_blocks = nn.ModuleList(
            _ClassAttentionBlock(cfg) for _ in range(cfg.cls_attn_layers))
        self.norm = _LayerNorm(d, cfg.ln_eps)

    def positional_encoding(self, hp: int, wp: int, device) -> torch.Tensor:
        """Fixed sinusoids in f32 -> 1x1-conv projection: [1, Hp*Wp, D]."""
        cfg = self.cfg
        hidden, scale, eps = cfg.pos_hidden_dim, 2 * math.pi, 1e-6
        f32 = dict(dtype=torch.float32, device=device)
        y = (torch.arange(1, hp + 1, **f32)[:, None] / (hp + eps) * scale
             ).expand(hp, wp)
        x = (torch.arange(1, wp + 1, **f32)[None, :] / (wp + eps) * scale
             ).expand(hp, wp)
        dim_t = torch.arange(hidden, **f32)
        dim_t = cfg.pos_temperature ** (2 * torch.div(
            dim_t, 2, rounding_mode="floor") / hidden)

        def interleave(pos):  # sin/cos over pairs, stack + flatten
            return torch.stack([torch.sin(pos[..., 0::2]),
                                torch.cos(pos[..., 1::2])],
                               dim=-1).reshape(hp, wp, hidden)

        pos = torch.cat([interleave(y[:, :, None] / dim_t),
                         interleave(x[:, :, None] / dim_t)], dim=-1)
        proj = self.pos_embeder.token_projection
        out = pos @ proj.weight[:, :, 0, 0].float().T + proj.bias.float()
        return out.reshape(1, hp * wp, cfg.embed_dim)

    def prepare_tokens(self, images: torch.Tensor
                       ) -> tuple[torch.Tensor, int, int]:
        x = self.patch_embed.proj(images)
        b, d, hp, wp = x.shape
        x = x.reshape(b, d, hp * wp).transpose(1, 2)
        pos = self.positional_encoding(hp, wp, x.device)
        return x + pos.to(x.dtype), hp, wp

    def forward(self, images: torch.Tensor, taps: Sequence[int] = ()
                ) -> dict[int, torch.Tensor]:
        """Tapped XCA block outputs; no taps runs the whole network and
        returns the normed [B, 1+N, D] tokens under -1."""
        taps = tuple(taps)
        x, hp, wp = self.prepare_tokens(images)
        out: dict[int, torch.Tensor] = {}
        for i in range(max(taps) + 1 if taps else self.cfg.depth):
            x = self.blocks[i](x, hp, wp)
            if i in taps:
                out[i] = x
        if not taps:
            x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], 1)
            for block in self.cls_attn_blocks:
                x = block(x)
            out[-1] = self.norm(x)
        return out


def xcit_cls_forward(model: XCiT, images: torch.Tensor) -> torch.Tensor:
    """The whole network -> the CLS feature [B, D]."""
    return model(images)[-1][:, 0]
