"""DINO-compatible Vision Transformer as an ``nn.Module`` (port of
``tpu_ac.models.vit``).

``state_dict`` keys are the released DINO names (``cls_token``,
``blocks.3.attn.qkv.weight``, ...), the keys ``tpu_ac`` uses for its params
dict, so one set of weights feeds both packages (``models/convert.py``).

The math is ``tpu_ac``'s: the patch projection is space-to-depth + one
matmul, attention is dense matmul -> softmax -> matmul (``_attention_xla``;
no fused SDPA, so the numerics stay those of the reference), GELU is exact,
and ``forward`` stops after the deepest tap.  ``attention_impl="flash"``
runs each block's attention through
``kernels.attention.flash_attention_impl`` instead (the port of
``tpu_ac.kernels.attention``): the CUDA flash kernel on the card, its
plain version on the CPU; ``pipeline.CategoryEmbedder`` passes it under
its default ``attention_impl="auto"`` for a bfloat16 embed on the card,
and the dense attention elsewhere.  The token
stream stays at its true length (785 at ViT-B/8, 224 px): the kernel masks
the ragged tail itself, so ``tpu_ac``'s ``seq_pad`` is not needed, and the
padded JAX forward equals the unpadded one on the real tokens
(``tests/test_seq_pad_packed.py``).  The other TPU/XLA-only levers of
``tpu_ac`` (``scan_blocks``, ``QKV_SPLIT``, ``ATTENTION_PAD_RAGGED``)
are not carried: they change compilation, not results.  ``forward_cls``
(the DINO training forward) takes ``tpu_ac``'s ``remat``: activation
checkpointing of each block, which trades recompute for memory.
``index_selfattention``, ``last_selfattention`` and ``all_selfattentions``
return the softmax maps (``tpu_ac``'s ``vit_*_selfattention``) in f32 with
TF32 off, always from the dense attention.

``DINOv2Config`` adds what DINOv2's ViT (facebookresearch/dinov2
``models/vision_transformer.py``) has and DINO's has not, under the
release's state-dict names: a SwiGLU FFN (``mlp.w12``, ``mlp.w3``;
``layers/swiglu_ffn.py``), LayerScale on both residual branches
(``ls1.gamma``, ``ls2.gamma``), prefix register tokens that take no
position (``register_tokens``, inserted after CLS once the table is added),
and the register models' resize of the position table (antialiased
bicubic straight to the grid, in f32, no offset).  ``ViTConfig`` holds the
same names as class attributes at DINO's values, so its fields, and
every row of the registry that ``tpu_ac`` shares, stay DINO's.  A
resized table is computed once a grid, dtype and device and reused until
``pos_embed`` changes (``POS_EMBED_RESIZES`` counts the resizes), except
while a gradient flows to it or the forward is traced.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt
from torch import nn

from tpu_ac_torch.device import precision_scope
from tpu_ac_torch.kernels.attention import flash_attention_impl
from tpu_ac_torch.ops.interpolate import interpolate_bicubic
from tpu_ac_torch.ops.linear import torch_linear
from tpu_ac_torch.ops.normalize import layernorm

# position tables resized since import: once a grid, dtype and device in
# an embed (``ViT.pos_table``), every forward where a gradient reaches it
POS_EMBED_RESIZES = 0


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    img_size: int = 224  # pretraining image size (defines pos_embed length)
    num_prefix_tokens: int = 1  # 2 for DeiT-distilled (CLS + dist token)
    # DINOv2's parts (``DINOv2Config`` makes them fields), at DINO's values:
    # class attributes, not fields, so asdict() stays tpu_ac's ViTConfig
    ffn_layer = "mlp"  # "mlp": GELU MLP; "swiglufused": DINOv2's SwiGLU
    layerscale = False
    num_register_tokens = 0
    interpolate_antialias = False  # False: DINO's +0.1 bicubic resize

    @property
    def ffn_hidden(self) -> int:
        """The FFN's hidden width: ``mlp_ratio`` of the width, or for the
        SwiGLU two thirds of that rounded up to a multiple of 8
        (``SwiGLUFFNFused``: 4096 at ViT-g's 1536)."""
        hidden = int(self.embed_dim * self.mlp_ratio)
        if self.ffn_layer == "swiglufused":
            return (int(hidden * 2 / 3) + 7) // 8 * 8
        return hidden

    @property
    def interpolate_offset(self) -> float:
        """The grid offset of the table's resize: DINO's 0.1 fudge, or 0
        for the register models, which resize to the size itself."""
        return 0.0 if self.interpolate_antialias else 0.1

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def scale(self) -> float:
        return self.head_dim ** -0.5


VIT_TINY = ViTConfig(embed_dim=192, num_heads=3)
VIT_SMALL = ViTConfig(embed_dim=384, num_heads=6)
VIT_BASE = ViTConfig(embed_dim=768, num_heads=12)
VIT_LARGE = ViTConfig(embed_dim=1024, depth=24, num_heads=16)


@dataclasses.dataclass(frozen=True)
class DINOv2Config(ViTConfig):
    """DINOv2's ViT: ``ViTConfig`` plus the SwiGLU FFN, LayerScale, the
    register tokens and the antialiased resize as fields (their defaults:
    ``dinov2_vitg14_reg``'s, hub/backbones.py)."""

    patch_size: int = 14
    img_size: int = 518
    ffn_layer: str = "swiglufused"
    layerscale: bool = True
    num_register_tokens: int = 4
    interpolate_antialias: bool = True


# hub/backbones.py dinov2_vitg14_reg: vit_giant2, 4 registers
VIT_GIANT2_REG4 = DINOv2Config(embed_dim=1536, depth=40, num_heads=24)


def _trunc_normal_np(rng: np.random.Generator, shape, std=0.02, a=-2.0,
                     b=2.0):
    """trunc_normal_ init by inverse CDF; a/b are absolute bounds like the
    reference's (a no-op clamp at std=0.02)."""
    from scipy.special import erfinv

    def norm_cdf(x):
        return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0

    lo, hi = norm_cdf(a / std), norm_cdf(b / std)
    x = rng.uniform(2 * lo - 1, 2 * hi - 1, size=shape)
    x = erfinv(x) * std * math.sqrt(2.0)
    return np.clip(x, a, b).astype(np.float32)


def init_vit_params(seed: int, cfg: ViTConfig) -> dict[str, np.ndarray]:
    """Seeded random init; the same draws in the same order as
    ``tpu_ac.models.vit.init_vit_params``, so the arrays are bit-identical."""
    rng = np.random.default_rng(seed)
    d = cfg.embed_dim
    p: dict[str, np.ndarray] = {}
    p["cls_token"] = _trunc_normal_np(rng, (1, 1, d))
    if cfg.num_prefix_tokens > 1:
        p["dist_token"] = _trunc_normal_np(rng, (1, 1, d))
    p["pos_embed"] = _trunc_normal_np(
        rng, (1, cfg.num_patches + cfg.num_prefix_tokens, d))
    p["patch_embed.proj.weight"] = (
        rng.standard_normal((d, 3, cfg.patch_size, cfg.patch_size)) *
        math.sqrt(1.0 / (3 * cfg.patch_size ** 2))
    ).astype(np.float32)
    p["patch_embed.proj.bias"] = np.zeros((d,), np.float32)
    if cfg.num_register_tokens:
        p["register_tokens"] = _trunc_normal_np(
            rng, (1, cfg.num_register_tokens, d))
    hidden = cfg.ffn_hidden
    # the SwiGLU's two products, or the GELU MLP's
    ffn = (("w12", 2 * hidden, d), ("w3", d, hidden)) \
        if cfg.ffn_layer == "swiglufused" else \
        (("fc1", hidden, d), ("fc2", d, hidden))
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        p[pre + "norm1.weight"] = np.ones((d,), np.float32)
        p[pre + "norm1.bias"] = np.zeros((d,), np.float32)
        p[pre + "attn.qkv.weight"] = _trunc_normal_np(rng, (3 * d, d))
        if cfg.qkv_bias:
            p[pre + "attn.qkv.bias"] = np.zeros((3 * d,), np.float32)
        p[pre + "attn.proj.weight"] = _trunc_normal_np(rng, (d, d))
        p[pre + "attn.proj.bias"] = np.zeros((d,), np.float32)
        p[pre + "norm2.weight"] = np.ones((d,), np.float32)
        p[pre + "norm2.bias"] = np.zeros((d,), np.float32)
        for name, n_out, n_in in ffn:
            p[pre + f"mlp.{name}.weight"] = _trunc_normal_np(rng,
                                                             (n_out, n_in))
            p[pre + f"mlp.{name}.bias"] = np.zeros((n_out,), np.float32)
        if cfg.layerscale:  # the hub's init_values=1.0
            p[pre + "ls1.gamma"] = np.ones((d,), np.float32)
            p[pre + "ls2.gamma"] = np.ones((d,), np.float32)
    p["norm.weight"] = np.ones((d,), np.float32)
    p["norm.bias"] = np.zeros((d,), np.float32)
    return p


class _Linear(nn.Module):
    """Holder of a torch-layout (out, in) weight and optional bias."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch_linear(x, self.weight, self.bias)


class _LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.bias = nn.Parameter(torch.empty(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, self.eps)


class _PatchProj(nn.Module):
    """Conv(ps, stride=ps) weight [D, 3, ps, ps], applied as space-to-depth
    + matmul (flatten order (c, kh, kw), the conv weight layout)."""

    def __init__(self, d: int, ps: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d, 3, ps, ps))
        self.bias = nn.Parameter(torch.empty(d))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, c, h, w = images.shape
        ps = self.weight.shape[-1]
        gh, gw = h // ps, w // ps
        x = images.reshape(b, c, gh, ps, gw, ps)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * ps * ps)
        return torch_linear(x, self.weight.reshape(self.weight.shape[0], -1),
                            self.bias)


class _PatchEmbed(nn.Module):
    def __init__(self, d: int, ps: int):
        super().__init__()
        self.proj = _PatchProj(d, ps)


class _Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.qkv = _Linear(d, 3 * d, cfg.qkv_bias)
        self.proj = _Linear(d, d)

    def forward(self, x: torch.Tensor, attention_impl: str | None = None,
                return_attention: bool = False):
        """[B, N, D] -> [B, N, D]; with ``return_attention`` the pair
        (softmax probabilities [B, nh, N, N], output), from the dense path
        whatever ``attention_impl`` says: a flash kernel never forms the
        probabilities (``tpu_ac``'s ``block_forward`` does the same)."""
        b, n, d = x.shape
        nh, hd = self.cfg.num_heads, self.cfg.head_dim
        qkv = self.qkv(x).reshape(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # each [B, nh, N, hd], strided
        attn = None
        if attention_impl == "flash" and not return_attention:
            # the kernel reads the strided views as they are and writes
            # [B, N, nh, hd] storage, so the reshape below copies nothing
            out = flash_attention_impl(q, k, v, self.cfg.scale)
        else:
            # dense softmax(QK^T * scale) V, the scale applied after the
            # product as in tpu_ac's _attention_xla
            attn = torch.matmul(q, k.transpose(-2, -1)) * self.cfg.scale
            attn = torch.softmax(attn, dim=-1)
            out = torch.matmul(attn, v)
        out = self.proj(out.transpose(1, 2).reshape(b, n, d))
        return (attn, out) if return_attention else out


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = _Linear(d, hidden)
        self.fc2 = _Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class _SwiGLU(nn.Module):
    """DINOv2's ``SwiGLUFFN``: w3(silu(a) * b), [a, b] the two halves of
    w12(x)."""

    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.w12 = _Linear(d, 2 * hidden)
        self.w3 = _Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(a) * b)


class _LayerScale(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class _Block(nn.Module):
    """One pre-LN transformer block; with ``cfg.layerscale`` each residual
    branch is scaled per channel (``ls1``, ``ls2``) before it is added."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = _LayerNorm(d, cfg.ln_eps)
        self.attn = _Attention(cfg)
        self.norm2 = _LayerNorm(d, cfg.ln_eps)
        self.mlp = _SwiGLU(d, cfg.ffn_hidden) \
            if cfg.ffn_layer == "swiglufused" else _Mlp(d, cfg.ffn_hidden)
        self.ls1 = _LayerScale(d) if cfg.layerscale else None
        self.ls2 = _LayerScale(d) if cfg.layerscale else None

    @staticmethod
    def _scaled(ls, y: torch.Tensor) -> torch.Tensor:
        return y if ls is None else ls(y)

    def forward(self, x: torch.Tensor, attention_impl: str | None = None,
                return_attention: bool = False):
        """The block's output; with ``return_attention`` the pair
        (attention [B, nh, N, N], output) from one evaluation
        (``tpu_ac``'s ``return_attention_and_output``)."""
        if return_attention:
            attn, y = self.attn(self.norm1(x), attention_impl, True)
            x = x + self._scaled(self.ls1, y)
            return attn, x + self._scaled(self.ls2, self.mlp(self.norm2(x)))
        x = x + self._scaled(self.ls1, self.attn(self.norm1(x),
                                                 attention_impl))
        return x + self._scaled(self.ls2, self.mlp(self.norm2(x)))


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of the products without batch dims (the linears' mm/addmm), recompute
    the rest (LayerNorm, GELU, softmax and the batched attention
    products), as ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable`` does for ``tpu_ac``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _run_block(blk: nn.Module, x: torch.Tensor,
               remat: bool | str) -> torch.Tensor:
    if not remat:
        return blk(x)
    if remat == "dots":
        return ckpt.checkpoint(
            blk, x, use_reentrant=False, context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    return ckpt.checkpoint(blk, x, use_reentrant=False)


def interpolate_pos_encoding(pos_embed: torch.Tensor, npatch: int, h: int,
                             w: int, cfg: ViTConfig) -> torch.Tensor:
    """Bicubic pos-embed resize for non-pretraining image sizes: DINO's,
    incl. the +0.1 scale fudge, through the port's torch-exact tables in
    the table's dtype; or, with ``cfg.interpolate_antialias``, DINOv2's
    register models', ``F.interpolate`` to the grid with antialias in f32,
    cast back.  The token grid is row-major (H rows of W), so the leading
    (row) scale comes from the image HEIGHT.  The prefix rows are kept as
    they are."""
    global POS_EMBED_RESIZES
    n_prefix = cfg.num_prefix_tokens
    n = pos_embed.shape[1] - n_prefix
    if npatch == n and w == h:
        return pos_embed
    POS_EMBED_RESIZES += 1
    dim = pos_embed.shape[-1]
    side = int(math.sqrt(n))
    grid = pos_embed[:, n_prefix:].reshape(1, side, side, dim)
    grid = grid.permute(0, 3, 1, 2)
    if cfg.interpolate_antialias:
        grid = F.interpolate(
            grid.float(), size=(h // cfg.patch_size, w // cfg.patch_size),
            mode="bicubic", antialias=True).to(pos_embed.dtype)
    else:
        h0 = h // cfg.patch_size + cfg.interpolate_offset
        w0 = w // cfg.patch_size + cfg.interpolate_offset
        grid = interpolate_bicubic(grid, scale_factor=(h0 / side, w0 / side))
    grid = grid.permute(0, 2, 3, 1).reshape(1, -1, dim)
    return torch.cat([pos_embed[:, :n_prefix], grid], dim=1)


class ViT(nn.Module):
    """DINO ViT trunk; ``forward(images, taps)`` -> {tap: [B, N+prefix, D]}.

    Parameters are allocated uninitialized: load them with
    ``models.convert.load_jax_params`` (a numpy params dict) or
    ``load_state_dict`` (a DINO ``.pth``).
    """

    family = "vit"

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        if cfg.num_prefix_tokens > 1:
            self.dist_token = nn.Parameter(torch.empty(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.num_patches + cfg.num_prefix_tokens, d))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.empty(1, cfg.num_register_tokens, d))
        self.patch_embed = _PatchEmbed(d, cfg.patch_size)
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.depth))
        self.norm = _LayerNorm(d, cfg.ln_eps)
        # (grid h, grid w, dtype, device) -> (pos_embed, its storage, its
        # version, table)
        self._pos_tables: dict = {}

    def interpolate_pos_encoding(self, npatch: int, h: int,
                                 w: int) -> torch.Tensor:
        return interpolate_pos_encoding(self.pos_embed, npatch, h, w,
                                        self.cfg)

    def pos_table(self, h: int, w: int) -> torch.Tensor:
        """The position table of an h x w image: computed once for each
        grid, dtype and device and kept while ``pos_embed`` is the same
        tensor object, on the same storage, at the same version
        (``load_state_dict`` and any other in-place write move the
        version; a tensor bound in its place, as ``DINOModel.bound`` binds
        them, is another object; ``.half()`` and ``.data =`` give it
        another storage).  Computed anew where a gradient reaches
        ``pos_embed`` or while the forward is traced."""
        ps = self.cfg.patch_size
        npatch = (h // ps) * (w // ps)
        pe = self.pos_embed
        if (torch.is_grad_enabled() and pe.requires_grad) or \
                torch.compiler.is_compiling():
            return self.interpolate_pos_encoding(npatch, h, w)
        key = (h // ps, w // ps, pe.dtype, pe.device)
        hit = self._pos_tables.get(key)
        # the entry holds pe's storage, so while it stands no other
        # storage can take that address
        if hit is None or hit[0] is not pe or \
                hit[1].data_ptr() != pe.data_ptr() or hit[2] != pe._version:
            hit = (pe, pe.detach(), pe._version,
                   self.interpolate_pos_encoding(npatch, h, w))
            self._pos_tables[key] = hit
        return hit[3]

    def prepare_tokens(self, images: torch.Tensor) -> torch.Tensor:
        """Patch tokens after the prefix (CLS, and DeiT's dist token), the
        position table added; DINOv2's registers then go in after the
        prefix, with no position."""
        b, _, h, w = images.shape
        x = self.patch_embed.proj(images)
        n_prefix = self.cfg.num_prefix_tokens
        prefix = [self.cls_token.expand(b, -1, -1)]
        if n_prefix > 1:
            prefix.append(self.dist_token.expand(b, -1, -1))
        x = torch.cat(prefix + [x], dim=1) + self.pos_table(h, w)
        if self.cfg.num_register_tokens:
            x = torch.cat([x[:, :n_prefix],
                           self.register_tokens.expand(b, -1, -1),
                           x[:, n_prefix:]], dim=1)
        return x

    def forward(self, images: torch.Tensor, taps: Sequence[int],
                attention_impl: str | None = None) -> dict[int, torch.Tensor]:
        """Raw block outputs (before the final norm) for each tapped index;
        stops after the deepest tap (the reference aborts its forward from
        the last hook).  ``attention_impl``: None (dense) or "flash"."""
        if attention_impl not in (None, "flash"):
            raise ValueError(f"attention_impl {attention_impl!r}; want None "
                             "or 'flash'")
        taps = tuple(taps)
        depth = max(taps) + 1
        x = self.prepare_tokens(images)
        out: dict[int, torch.Tensor] = {}
        for i in range(depth):
            x = self.blocks[i](x, attention_impl)
            if i in taps:
                out[i] = x
        return out

    def forward_cls(self, images: torch.Tensor,
                    remat: bool | str = False) -> torch.Tensor:
        """Every block, the final norm, the CLS token: [B, D] (``tpu_ac``'s
        ``vit_cls_forward``, the DINO training forward).  ``remat=True``
        recomputes each block's activations in the backward; ``"dots"``
        keeps the linears' outputs and recomputes the rest."""
        if remat not in (False, True, "dots"):
            raise ValueError(f"remat {remat!r}; want False, True or 'dots'")
        x = self.prepare_tokens(images)
        for blk in self.blocks:
            x = _run_block(blk, x, remat)
        return self.norm(x[:, 0])  # per token: the CLS row alone suffices

    def intermediate_layers(self, images: torch.Tensor,
                            n: int = 1) -> list[torch.Tensor]:
        """The final-norm'd outputs [B, N+prefix, D] of the last ``n``
        blocks (``tpu_ac``'s ``vit_intermediate_layers``, the reference's
        get_intermediate_layers).  Any H x W whose sides the patch divides
        is taken: the pos-embed is resized to the grid."""
        if not 1 <= n <= self.cfg.depth:
            raise ValueError(f"n {n} outside 1..{self.cfg.depth}")
        x = self.prepare_tokens(images)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i >= self.cfg.depth - n:
                outs.append(self.norm(x))
        return outs

    def index_selfattention(self, images: torch.Tensor,
                            index: int) -> torch.Tensor:
        """Softmax attention [B, nh, N+prefix, N+prefix] of block ``index``
        (``tpu_ac``'s ``vit_index_selfattention``, the Anomaly-Clustering
        fork's get_index_selfattention), in f32 with TF32 off
        (``Precision.HIGHEST``); the blocks after ``index`` do not run."""
        if not 0 <= index < self.cfg.depth:
            raise ValueError(f"block index {index} outside depth "
                             f"{self.cfg.depth}")
        with precision_scope("highest"):
            x = self.prepare_tokens(images)
            for blk in self.blocks[:index]:
                x = blk(x)
            blk = self.blocks[index]
            return blk.attn(blk.norm1(x), None, True)[0]

    def last_selfattention(self, images: torch.Tensor) -> torch.Tensor:
        """Attention of the final block (``vit_last_selfattention``)."""
        return self.index_selfattention(images, self.cfg.depth - 1)

    def all_selfattentions(self, images: torch.Tensor) -> torch.Tensor:
        """[depth, B, nh, N+prefix, N+prefix] attention of every block from
        one forward, each block evaluated once (``tpu_ac``'s
        ``vit_all_selfattentions``), in f32 with TF32 off.  Each block's
        map is copied into one preallocated tensor as it is made, so the
        peak is the result plus one block's temporaries."""
        with precision_scope("highest"):
            x = self.prepare_tokens(images)
            out = None
            for i, blk in enumerate(self.blocks):
                attn, x = blk(x, return_attention=True)
                if out is None:
                    out = attn.new_empty((self.cfg.depth, *attn.shape))
                out[i].copy_(attn)
                del attn
            return out
