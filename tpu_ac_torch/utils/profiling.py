"""torch.profiler integration (``--profile`` on ``cli.main`` and
``cli.dino``; port of ``tpu_ac.utils.profiling``).

``maybe_profile`` writes a chrome trace (``trace.json``, viewable in
Perfetto) of everything inside the block, on every thread where this
torch can record them all; ``step_annotation`` labels a region of it
(``pipeline.run_category_sweep``'s ``ac.*`` ranges are such labels).
"""

from __future__ import annotations

import contextlib
import os

import torch


def all_threads_config():
    """The profiler option that records the ranges and ops of every thread
    (the sweep's prefetch thread too; by default the profiler records the
    thread that started it), or None where this torch lacks it."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def maybe_profile(trace_dir: str | None):
    """Trace the block into ``trace_dir/trace.json`` (no-op if None): the
    host's ops of every thread, and the card's kernels where there is a
    card."""
    if not trace_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    config = all_threads_config()
    kw = {} if config is None else {"experimental_config": config}
    with torch.profiler.profile(activities=acts, **kw) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def step_annotation(name: str, step: int | None = None):
    """Label a region of the trace, ``name#step`` when a step is given."""
    label = name if step is None else f"{name}#{step}"
    return torch.profiler.record_function(label)
