"""Layer "embed" (``CategoryEmbedder`` → ``features/embedding.py`` over the
backbone): the backbone's operations in the window at the bf16 peak over
the device time of the kernels launched inside the program's ``ac.embed``
ranges (``harness/spans.py``).  What ``embed_flops_pct`` reads by
exclusion, read where the embed runs: alpha's tail is not in its time."""

from benchmark.harness.peaks import PEAK_BF16_FLOPS


def read(w):
    spans = getattr(w, "spans", None)
    flops = w.work.get("embed_flops", 0.0)
    t = spans.kernel_s.get("ac.embed", 0.0) if spans else 0.0
    if flops <= 0 or t <= 0:
        return None
    return 100.0 * flops / PEAK_BF16_FLOPS / t
