"""DINOv2's ViT with registers (facebookresearch/dinov2
``models/vision_transformer.py`` and ``layers/swiglu_ffn.py``; hub
``dinov2_vitg14_reg``: ``vit_giant2``, ``ffn_layer="swiglufused"``, 4
registers, ``interpolate_antialias=True``, ``interpolate_offset=0.0``) as
plain f32 torch ops.

Tokens: the patch conv; CLS in front; the position table added, its
patch rows resized by ``F.interpolate(mode="bicubic", antialias=True)``
straight to the input's grid (CLS's row as it is); then the register
tokens after CLS, with no position.  Each block, LayerNorm eps from the
config:

    x = x + ls1 * Attn(LN1(x))      qkv and proj biases, scale Dh^-0.5
    x = x + ls2 * W3(silu(a) * b)   [a, b] = chunk(W12 LN2(x) + b12, 2)

with the SwiGLU hidden width ``(int(4 d * 2 / 3) + 7) // 8 * 8``.  The
state dict's names are the release's.  ``q`` is applied to every
product's operands.

Departures from the release, each the anomaly-clustering embed's: the
forward stops after the deepest tap and returns the tapped blocks' raw
outputs (not ``get_intermediate_layers``' normed ones), the CLS and
register tokens dropped, as [B, D, G, G] maps; no ``mask_token`` (the
embed masks nothing); the weights are drawn (``param_spec``), not the
released ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu_hidden(config: dict) -> int:
    """``SwiGLUFFNFused``'s hidden width from the MLP ratio, checked
    against the width the config states."""
    a = config["arch"]
    hidden = (int(a["embed_dim"] * a["mlp_ratio"] * 2 / 3) + 7) // 8 * 8
    if hidden != a["ffn_hidden"]:
        raise ValueError(f"SwiGLU hidden {hidden}, the config states "
                         f"{a['ffn_hidden']}")
    return hidden


def param_spec(config: dict) -> list[tuple[str, tuple, float, float]]:
    """(name, shape, std, mean) of every tensor: the products' weights as
    DINOv2's init draws them (trunc_normal std 0.02, whose bounds of +-2
    lie 100 std out; the patch conv at 1/sqrt(fan_in)); biases, norm
    gains and offsets, CLS, registers and positions drawn small around the
    release's init (zeros, ones, and the positions' own std 0.02); the
    LayerScale gammas around ``assumed``'s mean, at which every branch
    moves the stream visibly (the release's 1e-5 init would leave each
    block all but the identity)."""
    a = config["arch"]
    d, ps = a["embed_dim"], a["patch_size"]
    hidden = swiglu_hidden(config)
    g_mean, g_std = config["layerscale_draw"]
    n_tok = (a["img_size"] // ps) ** 2 + 1
    spec = [("cls_token", (1, 1, d), 0.02, 0.0),
            ("pos_embed", (1, n_tok, d), 0.02, 0.0),
            ("register_tokens", (1, a["num_register_tokens"], d), 0.02,
             0.0),
            ("patch_embed.proj.weight", (d, 3, ps, ps),
             (1.0 / (3 * ps * ps)) ** 0.5, 0.0),
            ("patch_embed.proj.bias", (d,), 0.02, 0.0)]
    for i in range(a["depth"]):
        pre = f"blocks.{i}."
        spec += [(pre + "norm1.weight", (d,), 0.02, 1.0),
                 (pre + "norm1.bias", (d,), 0.02, 0.0),
                 (pre + "attn.qkv.weight", (3 * d, d), 0.02, 0.0),
                 (pre + "attn.qkv.bias", (3 * d,), 0.02, 0.0),
                 (pre + "attn.proj.weight", (d, d), 0.02, 0.0),
                 (pre + "attn.proj.bias", (d,), 0.02, 0.0),
                 (pre + "ls1.gamma", (d,), g_std, g_mean),
                 (pre + "norm2.weight", (d,), 0.02, 1.0),
                 (pre + "norm2.bias", (d,), 0.02, 0.0),
                 (pre + "mlp.w12.weight", (2 * hidden, d), 0.02, 0.0),
                 (pre + "mlp.w12.bias", (2 * hidden,), 0.02, 0.0),
                 (pre + "mlp.w3.weight", (d, hidden), 0.02, 0.0),
                 (pre + "mlp.w3.bias", (d,), 0.02, 0.0),
                 (pre + "ls2.gamma", (d,), g_std, g_mean)]
    spec += [("norm.weight", (d,), 0.02, 1.0), ("norm.bias", (d,), 0.02, 0.0)]
    return spec


def _linear(x, w, b, q):
    return F.linear(q(x), q(w), b)


def pos_table(pos_embed: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """The release's ``interpolate_pos_encoding`` at offset 0 with
    antialias: the patch rows resized to gh x gw in f32, CLS's row kept;
    the table itself where the grid is the pretraining one."""
    n = pos_embed.shape[1] - 1
    side = int(round(n ** 0.5))
    if gh * gw == n and gh == gw:
        return pos_embed
    d = pos_embed.shape[-1]
    grid = pos_embed[:, 1:].reshape(1, side, side, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid.float(), size=(gh, gw), mode="bicubic",
                         antialias=True)
    grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, d)
    return torch.cat([pos_embed[:, :1], grid], dim=1)


def features(x: torch.Tensor, w: dict, config: dict, q) -> list:
    """Normalized f32 images [B, 3, H, W] -> the tapped blocks' maps."""
    a = config["arch"]
    d, ps, nh = a["embed_dim"], a["patch_size"], a["num_heads"]
    hd = d // nh
    eps = a["ln_eps"]
    taps = [int(name.split(".")[-1]) for name in config["layers"]]
    b = x.shape[0]
    t = F.conv2d(q(x), q(w["patch_embed.proj.weight"]),
                 w["patch_embed.proj.bias"], stride=ps)
    gh, gw = t.shape[-2:]
    t = t.flatten(2).transpose(1, 2)
    t = torch.cat([w["cls_token"].expand(b, -1, -1), t], dim=1)
    t = t + pos_table(w["pos_embed"], gh, gw)
    reg = w["register_tokens"]
    t = torch.cat([t[:, :1], reg.expand(b, -1, -1), t[:, 1:]], dim=1)
    prefix = 1 + reg.shape[1]
    n = t.shape[1]
    out = {}
    for i in range(max(taps) + 1):
        p = f"blocks.{i}."
        h = F.layer_norm(t, (d,), w[p + "norm1.weight"], w[p + "norm1.bias"],
                         eps)
        qkv = _linear(h, w[p + "attn.qkv.weight"], w[p + "attn.qkv.bias"], q)
        qkv = qkv.reshape(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        s = torch.matmul(q(qkv[0]), q(qkv[1]).transpose(-2, -1)) * hd ** -0.5
        o = torch.matmul(q(torch.softmax(s, dim=-1)), q(qkv[2]))
        o = o.transpose(1, 2).reshape(b, n, d)
        o = _linear(o, w[p + "attn.proj.weight"], w[p + "attn.proj.bias"], q)
        t = t + w[p + "ls1.gamma"] * o
        h = F.layer_norm(t, (d,), w[p + "norm2.weight"], w[p + "norm2.bias"],
                         eps)
        h12 = _linear(h, w[p + "mlp.w12.weight"], w[p + "mlp.w12.bias"], q)
        x1, x2 = h12.chunk(2, dim=-1)
        h = _linear(F.silu(x1) * x2, w[p + "mlp.w3.weight"],
                    w[p + "mlp.w3.bias"], q)
        t = t + w[p + "ls2.gamma"] * h
        if i in taps:
            out[i] = t
    return [out[i][:, prefix:].transpose(1, 2).reshape(b, d, gh, gw)
            for i in taps]
