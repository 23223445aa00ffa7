"""Layer "embed" (``features/embedding.py`` over ``models/vit.py`` or
``models/resnet.py``): the backbone's operations in the window at the bf16
peak over the device time of every kernel that is not a ``min_dists``
kernel.  That time also holds the embedding tail, the operand preparation
of the distance kernel, alpha's softmax and the X product."""

from benchmark.harness.peaks import PEAK_BF16_FLOPS


def read(w):
    flops = w.work.get("embed_flops", 0.0)
    t = w.kernel_s(lambda base: not base.startswith("min_dists"))
    if flops <= 0 or t <= 0:
        return None
    return 100.0 * flops / PEAK_BF16_FLOPS / t
