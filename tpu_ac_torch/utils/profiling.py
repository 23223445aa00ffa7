"""torch.profiler integration (``--profile`` on ``cli.main`` and
``cli.dino``; port of ``tpu_ac.utils.profiling``).

``maybe_profile`` writes a chrome trace (``trace.json``, viewable in
Perfetto) of everything inside the block; ``step_annotation`` labels a
region of it.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """Trace the block into ``trace_dir/trace.json`` (no-op if None): the
    host's ops, and the card's kernels where there is a card."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def step_annotation(name: str, step: int | None = None):
    """Label a region of the trace, ``name#step`` when a step is given."""
    label = name if step is None else f"{name}#{step}"
    return torch.profiler.record_function(label)
