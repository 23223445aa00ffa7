"""Operations of the ViT's embed, reckoned from its sizes: ``chip_smoke.py``'s
``_vit_flops`` (frozen here), 2 a multiply-add, over the blocks the embed
runs (up to the deepest tap)."""


def patches(config: dict, imagesize: int) -> int:
    return (imagesize // config["arch"]["patch_size"]) ** 2


def image_flops(config: dict, imagesize: int) -> float:
    a = config["arch"]
    d, ps = a["embed_dim"], a["patch_size"]
    depth = max(int(t.split(".")[-1]) for t in config["layers"]) + 1
    n_p = (imagesize // ps) ** 2
    n = n_p + 1
    hidden_ratio = a["mlp_ratio"]
    # qkv 6 n d^2, proj 2 n d^2, MLP 4 r n d^2 (16 at r = 4): 24 n d^2
    linears = (8 + 4 * hidden_ratio) * n * d * d
    return depth * (linears + 4 * n * n * d) + 2 * n_p * 3 * ps * ps * d
