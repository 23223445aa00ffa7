"""``harness/spans.py`` and the readers of the program's ranges and counters
(``embed_span_flops_pct``, ``alpha_tail_pct``, ``embed_pad_pct``) on a
fabricated event list: kernels tied to the ``ac.*`` range around their
launch by correlation id, the ranges' device mirrors never counted as
kernels, idle time put down to the innermost range, and
``tracewin.read_events``' numbers the same as on the list without the
program's ranges."""

import os

import pytest
import torch

from benchmark.harness import manifest, spans, tracewin
from benchmark.harness.peaks import PEAK_BF16_FLOPS
from benchmark.tests.test_bench_run import root as tiny_root  # noqa: F401

S = 10 ** 8  # ns: times below are tenths of a second


class _Event:
    def __init__(self, name, dev, s, e, corr=0, tid=1, annotation=False):
        self._v = (name, dev, s * S, e * S, corr, tid, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return 0

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _range(name, s, e, dev="CPU", tid=1):
    return _Event(name, dev, s, e, tid=tid, annotation=True)


HARNESS = [_range("bench.window", 0, 100), _range("bench.window", 0, 100,
                                                  "CUDA"),
           _range("bench.sweep", 0, 100)]
PROGRAM = [_range("ac.dispatch", 10, 60), _range("ac.embed", 10, 29),
           _range("ac.alpha", 30, 50), _range("ac.prefetch_wait", 60, 74),
           # the device mirror of a range, over kernels and a gap
           _range("ac.embed", 15, 40, "CUDA"),
           # a range of another thread (the prefetch thread's decode)
           _range("ac.decode", 0, 90, tid=2)]
WORK = [
    # a host op whose correlation id repeats a launch's (another id space)
    _Event("aten::mm", "CPU", 12, 13, corr=104),
    _Event("cudaLaunchKernel", "CPU", 12, 13, corr=101),
    _Event("cuLaunchKernelEx", "CPU", 31, 32, corr=102),
    _Event("cudaLaunchKernelExC", "CPU", 33, 34, corr=103),
    _Event("cudaLaunchKernel", "CPU", 75, 76, corr=104),
    _Event("cudaMemcpyAsync", "CPU", 77, 78, corr=105),
    _Event("gemm_kernel", "CUDA", 15, 25, corr=101),
    _Event("void (anonymous namespace)::min_dists_kernel<false, 1>()",
           "CUDA", 35, 45, corr=102),
    _Event("softmax_warp_forward", "CUDA", 45, 50, corr=103),
    _Event("other_kernel", "CUDA", 75, 80, corr=104),
    _Event("Memcpy DtoH (Device -> Pinned)", "CUDA", 80, 85, corr=105),
]


def test_kernels_tied_to_the_ranges_around_their_launch():
    sp = spans.read_spans(HARNESS + PROGRAM + WORK)
    assert sp.kernels == {"ac.dispatch": 3, "ac.embed": 1, "ac.alpha": 2}
    assert sp.kernel_s == pytest.approx(
        {"ac.dispatch": 2.5, "ac.embed": 1.0, "ac.alpha": 1.5})
    assert sp.unattributed == 1  # other_kernel, launched outside them
    assert sp.tail_s("ac.alpha", lambda b: b.startswith("min_dists")) == \
        pytest.approx(1.0)
    assert sp.tail_s("ac.embed", lambda b: True) == pytest.approx(1.0)


def test_idle_time_put_down_to_the_innermost_range():
    """Device busy 15-25, 35-50, 75-85: the gaps' middles fall in
    bench.sweep (7.5, 92.5), ac.alpha (30) and ac.prefetch_wait (62.5);
    the device mirror and the other thread's range label nothing."""
    sp = spans.read_spans(HARNESS + PROGRAM + WORK)
    assert sp.idle_s == pytest.approx(
        {"bench.sweep": 1.5 + 1.5, "ac.alpha": 1.0, "ac.prefetch_wait": 2.5})


def test_unchanged_reader_gives_the_same_numbers():
    """The program's ranges, on the host and mirrored on the device, leave
    ``tracewin.read_events``' busy time, kernel count and kernel table as
    they are without them; its idle gaps keep their sum and move from
    bench.sweep to the program's ranges and the ops inside them."""
    without = tracewin.read_events(HARNESS + WORK)
    with_ranges = tracewin.read_events(HARNESS + PROGRAM + WORK)
    for w in (without, with_ranges):
        assert w.busy_s == pytest.approx(3.5) and w.n_kernels == 4
    assert with_ranges.device_ops == without.device_ops
    assert with_ranges.kernel_s_by_name == without.kernel_s_by_name
    assert sum(v for _, v in with_ranges.idle_gaps) == \
        pytest.approx(sum(v for _, v in without.idle_gaps))
    assert dict(without.idle_gaps) == pytest.approx({"bench.sweep": 6.5})
    assert dict(with_ranges.idle_gaps) == pytest.approx(
        {"bench.sweep": 3.0, "ac.alpha": 1.0, "ac.prefetch_wait": 2.5})
    sp = spans.read_spans(HARNESS + PROGRAM + WORK)
    assert sp.kernels["ac.dispatch"] + sp.unattributed == \
        with_ranges.n_kernels
    assert sum(sp.idle_s.values()) == \
        pytest.approx(with_ranges.window_s - with_ranges.busy_s)


def test_without_the_programs_ranges_nothing_is_attributed():
    sp = spans.read_spans(HARNESS + WORK)
    assert sp.kernels == {} and sp.kernel_s == {} and sp.unattributed == 4
    assert sp.idle_s == pytest.approx({"bench.sweep": 6.5})
    with pytest.raises(RuntimeError, match="bench.window"):
        spans.read_spans(WORK)


def _reader(name):
    return manifest.load_module(
        os.path.join(manifest.BENCH_DIR, "metrics", f"{name}.py"),
        f"m_{name}").read


def _window(**work):
    w = tracewin.TraceWindow(window_s=10.0, busy_s=3.0, n_kernels=4,
                             kernel_s_by_name={}, device_ops=[],
                             idle_gaps=[])
    w.work = work
    return w


def test_readers_of_the_ranges():
    w = _window(embed_flops=0.5 * PEAK_BF16_FLOPS)
    embed, tail = _reader("embed_span_flops_pct"), _reader("alpha_tail_pct")
    assert embed(w) is None and tail(w) is None  # no ranges read
    w.spans = spans.read_spans(HARNESS + PROGRAM + WORK)
    assert embed(w) == pytest.approx(50.0)  # 0.5 s of work in 1.0 s
    assert tail(w) == pytest.approx(100.0 / 3)  # softmax: 0.5 of 1.5 s
    w.spans = spans.read_spans(HARNESS + WORK)
    assert embed(w) is None and tail(w) is None


def test_embed_pad_share_from_the_counters():
    read = _reader("embed_pad_pct")
    assert read(_window()) is None
    # a sweep of the mix: 1,725 images decoded, 1,768 rows in batches of 8
    work = spans.counted({"IMAGES_DECODED": 10, "IMAGES_EMBEDDED": 16},
                         {"IMAGES_DECODED": 1735, "IMAGES_EMBEDDED": 1784})
    assert work == {"images_decoded": 1725, "images_embedded": 1768}
    assert read(_window(**work)) == pytest.approx(100.0 * 43 / 1768)
    assert spans.counted({}, {}) == {}


def test_counters_read_the_program(monkeypatch):
    from tpu_ac_torch import pipeline

    monkeypatch.setattr(pipeline, "IMAGES_DECODED", 7)
    monkeypatch.setattr(pipeline, "IMAGES_EMBEDDED", 8)
    assert spans.counters() == {"IMAGES_DECODED": 7, "IMAGES_EMBEDDED": 8}
    monkeypatch.delattr(pipeline, "IMAGES_EMBEDDED")
    assert spans.counters() == {"IMAGES_DECODED": 7}


def test_a_real_profile_is_read():
    """``torch.profiler``'s own events (CPU activity here: no kernel) with
    the harness's and the program's ranges."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracewin.WINDOW_RANGE):
            with record_function("bench.sweep"):
                with record_function("ac.dispatch"):
                    torch.ones(64).sum()
    events = list(prof.profiler.kineto_results.events())
    sp = spans.read_spans(events)
    assert sp.kernels == {} and sp.unattributed == 0
    w = tracewin.read_events(events)
    assert sum(sp.idle_s.values()) == pytest.approx(w.window_s)


def test_a_traced_run_wired_to_the_ranges(tiny_root, capsys, monkeypatch):
    """A ``--trace 1`` run of a tiny cell on the CPU with the program's
    counters read around the window and ``read_spans`` attached to its
    ``TraceWindow``, as a run wired to them would: the padded share is the
    mix's (12 images a sweep in 14 rows of batches of 2), and no kernel
    runs here, so the ranges' device readers read nothing."""
    import json

    from benchmark import run

    box = {}
    read_events, run_window = tracewin.read_events, run.run_window

    def wired_window(*a, **k):
        before = spans.counters()
        w = run_window(*a, **k)
        box["work"] = spans.counted(before, spans.counters())
        return w

    def wired_read(events, top=10):
        events = list(events)
        tw = read_events(events, top)
        tw.spans = spans.read_spans(events)
        box["tw"] = tw
        return tw

    monkeypatch.setattr(run, "run_window", wired_window)
    monkeypatch.setattr(tracewin, "read_events", wired_read)
    assert run.main(["--workload", "rn-u", "--seed", str(2 ** 33 + 9),
                     "--seconds", "0.2", "--trace", "1"], root=tiny_root,
                    device="cpu") == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["correct"]
    tw = box["tw"]
    sweeps = box["work"]["images_decoded"] // 12
    assert sweeps >= 1
    assert box["work"] == {"images_decoded": 12 * sweeps,
                           "images_embedded": 14 * sweeps}
    tw.work.update(box["work"])
    assert _reader("embed_pad_pct")(tw) == pytest.approx(100.0 / 7)
    assert tw.spans.kernels == {} and tw.spans.unattributed == 0
    assert _reader("embed_span_flops_pct")(tw) is None
    assert _reader("alpha_tail_pct")(tw) is None
    # no device work here: one gap, the window, labelled by the range
    # open at its middle
    assert sum(tw.spans.idle_s.values()) == pytest.approx(tw.window_s)
    assert len(tw.spans.idle_s) == 1
    label, = tw.spans.idle_s
    assert label.startswith("ac.") or label == "bench.sweep"
