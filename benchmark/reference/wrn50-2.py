"""torchvision's ResNet (``resnet.py``: Bottleneck with the stride on the
3 x 3 conv, v1.5) as plain f32 torch ops, frozen BatchNorm with running
statistics; ``wide_resnet50_2`` is Bottleneck [3, 4, 6, 3] with
``width_per_group`` 128.  The forward stops after the deepest tapped
stage; the tapped stages' maps are returned.  ``q`` is applied to every
convolution's operands.  The state dict's names are torchvision's."""

from __future__ import annotations

import torch.nn.functional as F

_STAGES = ("layer1", "layer2", "layer3", "layer4")


def _blocks(arch: dict):
    """(stage index, block, in_c, width, out_c, stride) of every block."""
    in_c = 64
    for li, n in enumerate(arch["block_counts"]):
        planes = 64 * 2 ** li
        width = planes * arch["width_per_group"] // 64 * arch["groups"]
        out_c = planes * arch["expansion"]
        for b in range(n):
            yield li, b, in_c, width, out_c, 2 if (li > 0 and b == 0) else 1
            in_c = out_c


def param_spec(config: dict) -> list[tuple[str, tuple, float, float]]:
    """(name, shape, std, mean): convs N(0, 2 / fan_in), the port's init;
    BN gains,
    offsets and running means drawn small around torchvision's ones and
    zeros, running variances 1; the classifier, which the embed never
    reaches, at std 0.01."""
    a = config["arch"]
    spec = []

    def conv(name, out_c, in_c, k):
        spec.append((name + ".weight", (out_c, in_c, k, k),
                     (2.0 / (in_c * k * k)) ** 0.5, 0.0))

    def bn(name, c):
        spec.extend([(name + ".weight", (c,), 0.02, 1.0),
                     (name + ".bias", (c,), 0.02, 0.0),
                     (name + ".running_mean", (c,), 0.02, 0.0),
                     (name + ".running_var", (c,), 0.0, 1.0)])

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    for li, b, in_c, width, out_c, _ in _blocks(a):
        pre = f"{_STAGES[li]}.{b}."
        conv(pre + "conv1", width, in_c, 1)
        bn(pre + "bn1", width)
        conv(pre + "conv2", width, width // a["groups"], 3)
        bn(pre + "bn2", width)
        conv(pre + "conv3", out_c, width, 1)
        bn(pre + "bn3", out_c)
        if b == 0:
            conv(pre + "downsample.0", out_c, in_c, 1)
            bn(pre + "downsample.1", out_c)
    spec += [("fc.weight", (a["num_classes"], 512 * a["expansion"]), 0.01,
              0.0),
             ("fc.bias", (a["num_classes"],), 0.02, 0.0)]
    return spec


def features(x, w: dict, config: dict, q) -> list:
    """Normalized f32 images [B, 3, H, W] -> the tapped stages' maps."""
    a = config["arch"]
    eps = a["bn_eps"]

    def conv(x, name, stride=1, groups=1):
        wt = w[name + ".weight"]
        return F.conv2d(q(x), q(wt), None, stride, (wt.shape[-1] - 1) // 2,
                        1, groups)

    def bn(x, name):
        return F.batch_norm(x, w[name + ".running_mean"],
                            w[name + ".running_var"], w[name + ".weight"],
                            w[name + ".bias"], False, 0.0, eps)

    taps = list(config["layers"])
    deepest = max(_STAGES.index(t) for t in taps)
    x = F.relu(bn(conv(x, "conv1", 2), "bn1"))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    out = {}
    for li, b, _, _, _, stride in _blocks(a):
        if li > deepest:
            break
        pre = f"{_STAGES[li]}.{b}."
        y = F.relu(bn(conv(x, pre + "conv1"), pre + "bn1"))
        y = F.relu(bn(conv(y, pre + "conv2", stride, a["groups"]),
                      pre + "bn2"))
        y = bn(conv(y, pre + "conv3"), pre + "bn3")
        idn = x if b else bn(conv(x, pre + "downsample.0", stride),
                             pre + "downsample.1")
        x = F.relu(y + idn)
        if b == a["block_counts"][li] - 1:
            out[_STAGES[li]] = x
    return [out[t] for t in taps]
