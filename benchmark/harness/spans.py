"""The program's ``ac.*`` ranges in the traced window, with the kernels each
launched and the idle time each holds.

``tpu_ac_torch.pipeline.run_category_sweep`` opens a ``record_function``
range named ``ac.<layer>`` around each layer of a category (``ac.embed``,
``ac.alpha``, ``ac.prefetch_wait``, ...).  A kernel belongs to every
``ac.*`` range open around its runtime launch (``cudaLaunchKernel``,
``cuLaunchKernelEx``, ...) on the launching thread: CUPTI gives the launch
and the kernel one correlation id.  The ranges' mirrors on the device's
timeline are ranges (``tracewin._kind``), never kernels.  Kernels and gaps
are clipped to the ``bench.window`` range as ``tracewin.read_events``
clips them; an idle gap is put down to the innermost ``ac.*`` range open
on the harness's thread at its middle, else to the innermost harness
range (``bench.sweep``), else to "(no op)".

The program's image counters (``IMAGES_DECODED``, ``IMAGES_EMBEDDED``)
are read with ``counters()`` before and after the window; ``counted``
turns the two readings into the window's work keys.  Where the program has
no such range or counter, every map is empty and ``counted`` gives {}.
A run attaches ``read_spans``' result to its ``TraceWindow`` as
``spans`` and merges ``counted`` into its ``work``; the readers
(``metrics/embed_span_flops_pct.py``, ``alpha_tail_pct.py``,
``embed_pad_pct.py``) take them from there.
"""

from __future__ import annotations

import dataclasses
import re

from benchmark.harness import tracewin

SPAN_PREFIX = "ac."
# runtime calls that launch a kernel (CUDA runtime and driver API)
_LAUNCH_RE = re.compile(r"^cu(da)?(Launch|GraphLaunch)")
# the program's counters, and the window's work keys they give
COUNTERS = {"IMAGES_DECODED": "images_decoded",
            "IMAGES_EMBEDDED": "images_embedded"}


@dataclasses.dataclass
class Spans:
    kernel_s: dict[str, float]  # range name -> device seconds of its kernels
    kernels: dict[str, int]  # range name -> kernels launched inside it
    kernel_s_by_name: dict[str, dict[str, float]]  # range -> kernel -> s
    idle_s: dict[str, float]  # innermost range at a gap's middle -> s
    unattributed: int  # kernels launched outside every ac.* range

    def tail_s(self, span: str, pred) -> float:
        """Device seconds of ``span``'s kernels whose ``kernel_base``
        ``pred`` accepts."""
        return sum(s for n, s in self.kernel_s_by_name.get(span, {}).items()
                   if pred(tracewin.kernel_base(n)))


def _is_host(e) -> bool:
    return "CUDA" not in str(e.device_type())


def _enclosing(ranges, points):
    """{key: names of the ranges open at t} for ``points`` (t, key) on one
    thread; ``ranges``: (start, end, name), nested."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, k = {}, [], 0
    for t, key in sorted(points):
        while k < len(ranges) and ranges[k][0] <= t:
            stack.append(ranges[k])
            k += 1
        stack = [r for r in stack if r[1] > t]
        out[key] = frozenset(r[2] for r in stack)
    return out


def read_spans(events) -> Spans:
    """The ``ac.*`` ranges of ``prof.profiler.kineto_results.events()``."""
    events = list(events)
    window = None
    for e in events:
        if e.name() == tracewin.WINDOW_RANGE and _is_host(e):
            window = e
    if window is None:
        raise RuntimeError(f"no {tracewin.WINDOW_RANGE!r} range in the trace")
    w0 = window.start_ns()
    w1 = w0 + window.duration_ns()
    tid = window.start_thread_id()
    ranges: dict[int, list] = {}
    launches: dict[int, list] = {}
    labels = []  # the harness thread's ranges that may label a gap
    kernels, device = [], []
    for e in events:
        kind = tracewin._kind(e)
        if kind in ("kernel", "copy"):
            s = max(e.start_ns(), w0)
            t = min(e.start_ns() + e.duration_ns(), w1)
            if t > s:
                device.append((s, t))
                if kind == "kernel":
                    kernels.append((e, (t - s) * 1e-9))
            continue
        if kind == "range" and not _is_host(e):  # a mirror on the device
            continue
        name = e.name()
        if kind == "host" and not name.startswith(SPAN_PREFIX):
            if _LAUNCH_RE.match(name):
                launches.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.correlation_id()))
            continue
        s = e.start_ns()
        t = s + e.duration_ns()
        thread = e.start_thread_id()
        if name.startswith(SPAN_PREFIX):
            ranges.setdefault(thread, []).append((s, t, name))
        if thread == tid and e is not window:
            labels.append((s, t, name))
    open_at: dict[int, frozenset] = {}
    for thread, points in launches.items():
        open_at.update(_enclosing(ranges.get(thread, []), points))
    kernel_s: dict[str, float] = {}
    count: dict[str, int] = {}
    by_name: dict[str, dict[str, float]] = {}
    unattributed = 0
    for e, sec in kernels:
        names = open_at.get(e.correlation_id(), frozenset())
        if not names:
            unattributed += 1
        for n in names:
            kernel_s[n] = kernel_s.get(n, 0.0) + sec
            count[n] = count.get(n, 0) + 1
            mine = by_name.setdefault(n, {})
            k = e.name()[:tracewin._NAME_CHARS]
            mine[k] = mine.get(k, 0.0) + sec
    gaps, cur = [], w0
    for s, t in tracewin._union(device):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if w1 > cur:
        gaps.append((cur, w1))
    # an ac.* range wins over a harness range that holds it: both nest on
    # the harness's thread, so the innermost open one is the program's
    idle = tracewin._label_gaps(gaps, labels)
    return Spans(kernel_s=kernel_s, kernels=count, kernel_s_by_name=by_name,
                 idle_s=idle, unattributed=unattributed)


def counters() -> dict[str, int]:
    """The program's image counters as they stand (those it has)."""
    from tpu_ac_torch import pipeline

    return {k: getattr(pipeline, k) for k in COUNTERS
            if isinstance(getattr(pipeline, k, None), int)}


def counted(before: dict, after: dict) -> dict[str, int]:
    """The window's work keys from two ``counters()`` readings."""
    return {COUNTERS[k]: after[k] - before[k] for k in COUNTERS
            if k in before and k in after}
