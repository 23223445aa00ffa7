"""The traced window, read from ``torch.profiler``'s raw events.

The window is the interval of the harness's ``bench.window`` range (in a
``--trace 0`` profile, which records no host range, the whole trace).  A
device operation is a kernel, a copy or a memset that CUPTI recorded;
``busy_s`` is the length of the union of their intervals inside the
window.  The idle gaps (the window less that union) are labelled by the
innermost host range or op open on the harness's thread at each gap's
middle, or "(no op)" when none is.  ``TraceWindow`` carries the numbers
that the per-layer readers (``metrics/<name>.py``) take, with the work of
the window as the benchmark reckons it.
"""

from __future__ import annotations

import dataclasses
import re

WINDOW_RANGE = "bench.window"
_NAME_CHARS = 160


def _kind(e) -> str:
    """"kernel", "copy" (a copy or a memset), "range" (a ``record_function``
    range, on either side) or "host" (an op or a runtime call).  From the
    event's device and name: ``_KinetoEvent`` has no activity type in
    every torch release."""
    if getattr(e, "is_user_annotation", lambda: False)() or \
            e.name().startswith("bench."):
        return "range"
    if "CUDA" not in str(e.device_type()):
        return "host"
    if e.name().startswith(("Memcpy", "Memset")):
        return "copy"
    return "kernel"


def kernel_base(name: str) -> str:
    """A kernel's own name: without ``void``, its namespaces, template
    arguments and parameters (``void (anonymous namespace)::
    min_dists_kernel<false, 1>(...)`` -> ``min_dists_kernel``)."""
    name = re.sub(r"^void\s+", "", name.strip())
    name = name.replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.rsplit("::", 1)[-1]


@dataclasses.dataclass
class TraceWindow:
    window_s: float
    busy_s: float
    n_kernels: int
    kernel_s_by_name: dict[str, float]
    device_ops: list[list]
    idle_gaps: list[list]
    work: dict = dataclasses.field(default_factory=dict)

    def kernel_s(self, pred) -> float:
        """Device seconds of the kernels whose ``kernel_base`` ``pred``
        accepts."""
        return sum(s for n, s in self.kernel_s_by_name.items()
                   if pred(kernel_base(n)))


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label_gaps(gaps, host):
    """{label: seconds} of the gaps, each labelled by the innermost host
    interval open at its middle (``host``: (start, end, name), one thread,
    nested)."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out: dict[str, float] = {}
    stack, k = [], 0
    for s, e in sorted(gaps):
        t = (s + e) / 2
        while k < len(host) and host[k][0] <= t:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        label = stack[-1][2][:_NAME_CHARS] if stack else "(no op)"
        out[label] = out.get(label, 0.0) + (e - s) * 1e-9
    return out


def device_busy_s(events) -> float:
    """The length of the union of every kernel, copy and memset interval
    of a trace of the window alone (the ``--trace 0`` profile, which
    records the device's activity and nothing else)."""
    merged = _union((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in events if _kind(e) in ("kernel", "copy"))
    return sum(e - s for s, e in merged) * 1e-9


def read_events(events, top: int = 10) -> TraceWindow:
    """The window of ``prof.profiler.kineto_results.events()``."""
    events = list(events)
    window = None
    for e in events:
        if e.name() == WINDOW_RANGE and "CUDA" not in str(e.device_type()):
            window = e
    if window is None:
        raise RuntimeError(f"no {WINDOW_RANGE!r} range in the trace")
    w0 = window.start_ns()
    w1 = w0 + window.duration_ns()
    tid = window.start_thread_id()
    device, host = [], []
    by_name: dict[str, float] = {}
    n_kernels = 0
    for e in events:
        kind = _kind(e)
        s = e.start_ns()
        t = s + e.duration_ns()
        if kind in ("kernel", "copy"):
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            device.append((s, t))
            if kind == "kernel":
                n_kernels += 1
                name = e.name()[:_NAME_CHARS]
                by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-9
        elif ("CUDA" not in str(e.device_type())
              and e.start_thread_id() == tid and e is not window
              and t > w0 and s < w1):
            host.append((s, t, e.name()))
    merged = _union(device)
    busy = sum(e - s for s, e in merged) * 1e-9
    gaps, cur = [], w0
    for s, e in merged:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    labelled = _label_gaps(gaps, host)

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return TraceWindow(window_s=(w1 - w0) * 1e-9, busy_s=busy,
                       n_kernels=n_kernels, kernel_s_by_name=by_name,
                       device_ops=ranked(by_name),
                       idle_gaps=ranked(labelled))
