"""Operations of DINOv2's ViT embed with registers and a SwiGLU FFN,
reckoned from its sizes, 2 a multiply-add, over the blocks the embed runs
(up to the deepest tap).  A block over n tokens (CLS, the registers and
the patches) of width d with SwiGLU hidden h: qkv 6 n d^2, proj 2 n d^2,
w12 4 n d h, w3 2 n d h, and 4 n^2 d of attention; plus the patch conv."""


def patches(config: dict, imagesize: int) -> int:
    return (imagesize // config["arch"]["patch_size"]) ** 2


def image_flops(config: dict, imagesize: int) -> float:
    a = config["arch"]
    d, ps, h = a["embed_dim"], a["patch_size"], a["ffn_hidden"]
    depth = max(int(t.split(".")[-1]) for t in config["layers"]) + 1
    n_p = (imagesize // ps) ** 2
    n = n_p + 1 + a["num_register_tokens"]
    block = 2 * n * (4 * d * d + 3 * d * h) + 4 * n * n * d
    return depth * block + 2 * n_p * 3 * ps * ps * d
