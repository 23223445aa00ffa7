"""Layer "kernels" (``compute_alpha_X`` → ``cluster/alpha.py``): the share of
the device time of the kernels launched inside the program's ``ac.alpha``
ranges (``harness/spans.py``) that is not a ``min_dists`` kernel: the
bucket padding, the distance operands' preparation, softmax, the X
product and the packing."""


def read(w):
    spans = getattr(w, "spans", None)
    total = spans.kernel_s.get("ac.alpha", 0.0) if spans else 0.0
    if total <= 0:
        return None
    tail = spans.tail_s("ac.alpha",
                        lambda base: not base.startswith("min_dists"))
    return 100.0 * tail / total
