"""Layer "embed" (``features/embedding.py`` over ``models/vit.py`` or
``models/resnet.py``): the device milliseconds, per test image in the
window, of every kernel that is not a ``min_dists`` kernel.  That time
also holds the embedding tail, the operand preparation of the distance
kernel, alpha's softmax and the X product, as ``embed_flops_pct``'s does.
It falls as the trunk's kernels get faster, as ``sweep_busy_s`` does, and
does not move with the distance kernel."""


def read(w):
    n = w.work.get("test_images", 0.0)
    t = w.kernel_s(lambda base: not base.startswith("min_dists"))
    if n <= 0 or t <= 0:
        return None
    return 1000.0 * t / n
