"""Layer "sweep": the whole sweep's share of the card's bf16 peak.  The
window's operations as the benchmark reckons them from the shapes (the
backbone forward of every image embedded; 2 P^2 D for each min-distance
product the result needs) at 989 TFLOP/s, over the seconds in which the
card was busy in the window.  It bounds the kernels' roofline shares: a
kernel taken off the path leaves its own share silent, not this one."""

from benchmark.harness.peaks import PEAK_BF16_FLOPS


def read(w):
    flops = w.work.get("embed_flops", 0.0) + w.work.get("min_dists_flops",
                                                        0.0)
    if flops <= 0 or w.busy_s <= 0:
        return None
    return 100.0 * flops / PEAK_BF16_FLOPS / w.busy_s
