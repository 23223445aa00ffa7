"""The card's published peaks and the least time of a piece of work.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the full 700 W
power limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM.  ``least_s`` is
``chip_smoke.py``'s ``_bound_ms`` (frozen here, in seconds): the larger of
the operations at the bf16 peak and the bytes, each input byte read once
and each output byte written once, at the HBM peak.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def least_s(flops: float, in_bytes: float, out_bytes: float
            ) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes", whichever bounds it)."""
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = (in_bytes + out_bytes) / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
