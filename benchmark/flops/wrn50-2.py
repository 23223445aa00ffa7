"""Operations of the ResNet trunk's embed, reckoned from its sizes:
2 H_out W_out C_in C_out k^2 / groups over every convolution up to the
deepest tapped stage (the stem, each bottleneck's three, the downsample);
BatchNorm, ReLU, the pool and the adds are not counted."""

_STAGES = ("layer1", "layer2", "layer3", "layer4")


def _convs(config: dict, imagesize: int):
    """(H_out, W_out, C_in, C_out, k, groups) of every conv the embed
    runs."""
    a = config["arch"]
    deepest = max(_STAGES.index(t) for t in config["layers"])
    s = (imagesize + 2 * 3 - 7) // 2 + 1  # conv1, 7 x 7 stride 2 pad 3
    yield s, s, 3, 64, 7, 1
    s = (s + 2 - 3) // 2 + 1  # max pool 3 stride 2 pad 1
    in_c = 64
    for li, n in enumerate(a["block_counts"][:deepest + 1]):
        planes = 64 * 2 ** li
        width = planes * a["width_per_group"] // 64 * a["groups"]
        out_c = planes * a["expansion"]
        for b in range(n):
            stride = 2 if (li > 0 and b == 0) else 1
            s_out = (s - 1) // stride + 1
            yield s, s, in_c, width, 1, 1
            yield s_out, s_out, width, width, 3, a["groups"]
            yield s_out, s_out, width, out_c, 1, 1
            if b == 0:
                yield s_out, s_out, in_c, out_c, 1, 1
            s, in_c = s_out, out_c


def patches(config: dict, imagesize: int) -> int:
    """Sites of the first tapped stage's grid (the grid the tail aligns
    the others onto)."""
    first = _STAGES.index(config["layers"][0])
    s = imagesize // 4
    for _ in range(first):
        s = (s - 1) // 2 + 1
    return s * s


def image_flops(config: dict, imagesize: int) -> float:
    return float(sum(2 * h * w * ci * co * k * k // g
                     for h, w, ci, co, k, g in _convs(config, imagesize)))
