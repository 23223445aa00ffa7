"""Layer "kernels" (``csrc/min_dists.cu`` through ``kernels/distances.py``):
the least time of the window's min-distance products (the larger of their
operations at the bf16 peak and their bytes, each input byte read once and
each output byte written once, at the HBM peak; the products the result
needs: one per unordered pair of distinct images, or per test-train pair
in the supervised mode) over the device time of the kernels whose names
start with ``min_dists``."""


def read(w):
    least = w.work.get("min_dists_least_s", 0.0)
    t = w.kernel_s(lambda base: base.startswith("min_dists"))
    if least <= 0 or t <= 0:
        return None
    return 100.0 * least / t
