"""DINO's ViT (facebookresearch/dino ``vision_transformer.py``) as plain
f32 torch ops: patch conv, CLS token, position embedding (no resize: the
image is the pretraining size), pre-LN blocks (LayerNorm, multi-head
softmax attention with a qkv bias, exact GELU MLP), the raw outputs of the
tapped blocks with the CLS token dropped as [B, D, G, G] maps.  The
forward stops after the deepest tap, as the anomaly-clustering embed
does.  ``q`` is applied to every product's operands.  The state dict's
names are DINO's."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def param_spec(config: dict) -> list[tuple[str, tuple, float, float]]:
    """(name, shape, std, mean) of every tensor: the products' weights as
    DINO's init draws them (trunc_normal std 0.02, whose bounds of +-2 lie
    100 std out; the patch conv at 1/sqrt(fan_in)); biases, norm gains and
    offsets drawn small around DINO's zeros and ones, so that the
    comparison sees them."""
    a = config["arch"]
    d, ps = a["embed_dim"], a["patch_size"]
    hidden = int(d * a["mlp_ratio"])
    n_tok = (a["img_size"] // ps) ** 2 + 1
    spec = [("cls_token", (1, 1, d), 0.02, 0.0),
            ("pos_embed", (1, n_tok, d), 0.02, 0.0),
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
                 (pre + "norm2.weight", (d,), 0.02, 1.0),
                 (pre + "norm2.bias", (d,), 0.02, 0.0),
                 (pre + "mlp.fc1.weight", (hidden, d), 0.02, 0.0),
                 (pre + "mlp.fc1.bias", (hidden,), 0.02, 0.0),
                 (pre + "mlp.fc2.weight", (d, hidden), 0.02, 0.0),
                 (pre + "mlp.fc2.bias", (d,), 0.02, 0.0)]
    spec += [("norm.weight", (d,), 0.02, 1.0), ("norm.bias", (d,), 0.02, 0.0)]
    return spec


def _linear(x, w, b, q):
    return F.linear(q(x), q(w), b)


def features(x: torch.Tensor, w: dict, config: dict, q) -> list:
    """Normalized f32 images [B, 3, H, W] -> the tapped blocks' maps."""
    a = config["arch"]
    d, ps, nh = a["embed_dim"], a["patch_size"], a["num_heads"]
    hd = d // nh
    taps = [int(name.split(".")[-1]) for name in config["layers"]]
    b = x.shape[0]
    t = F.conv2d(q(x), q(w["patch_embed.proj.weight"]),
                 w["patch_embed.proj.bias"], stride=ps)
    g = t.shape[-1]
    t = t.flatten(2).transpose(1, 2)
    t = torch.cat([w["cls_token"].expand(b, -1, -1), t], dim=1)
    if t.shape[1] != w["pos_embed"].shape[1]:
        raise ValueError("the reference takes the pretraining image size")
    t = t + w["pos_embed"]
    n = t.shape[1]
    out = {}
    for i in range(max(taps) + 1):
        p = f"blocks.{i}."
        h = F.layer_norm(t, (d,), w[p + "norm1.weight"], w[p + "norm1.bias"],
                         a["ln_eps"])
        qkv = _linear(h, w[p + "attn.qkv.weight"], w[p + "attn.qkv.bias"], q)
        qkv = qkv.reshape(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        s = torch.matmul(q(qkv[0]), q(qkv[1]).transpose(-2, -1)) * hd ** -0.5
        o = torch.matmul(q(torch.softmax(s, dim=-1)), q(qkv[2]))
        o = o.transpose(1, 2).reshape(b, n, d)
        t = t + _linear(o, w[p + "attn.proj.weight"],
                        w[p + "attn.proj.bias"], q)
        h = F.layer_norm(t, (d,), w[p + "norm2.weight"], w[p + "norm2.bias"],
                         a["ln_eps"])
        h = F.gelu(_linear(h, w[p + "mlp.fc1.weight"], w[p + "mlp.fc1.bias"],
                           q))
        t = t + _linear(h, w[p + "mlp.fc2.weight"], w[p + "mlp.fc2.bias"], q)
        if i in taps:
            out[i] = t
    return [out[i][:, 1:].transpose(1, 2).reshape(b, d, g, g) for i in taps]
