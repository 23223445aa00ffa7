"""The benchmark's own arithmetic and its traffic generator."""

import hashlib
import json
import os

import numpy as np
import pytest

from benchmark.harness import manifest, traffic
from benchmark.harness.peaks import least_s

BENCH = manifest.BENCH_DIR


def _config(name):
    return json.load(open(os.path.join(BENCH, "configs", name + ".json")))


def _flops(name):
    return manifest.load_module(os.path.join(BENCH, "flops", name + ".py"),
                                "flops_" + name.replace("-", "_"))


def _mix(name):
    return traffic.Mix.from_dict(json.load(open(
        os.path.join(BENCH, "traffic", name + ".json"))))


@pytest.mark.parametrize("config,gflop", [("dino-vitb8", 156.295),
                                          ("wrn50-2", 18.373)])
def test_image_flops(config, gflop):
    f = _flops(config)
    cfg = _config(config)
    assert f.patches(cfg, 224) == 784
    assert f.image_flops(cfg, 224) / 1e9 == pytest.approx(gflop, abs=1e-3)


def test_sweep_min_dists_flops():
    """106,773 distinct pairs (537.6 TFLOP) unsupervised; N x N_train
    (1,083.9 TFLOP) supervised, at P = 784 and D = 4096."""
    per_pair = 2 * 784 * 784 * 4096
    unsup, sup = _mix("mvtec15-unsup"), _mix("mvtec15-sup")
    assert sum(n for _, n in unsup.categories) == 1725
    pairs = sum(n * (n - 1) // 2 for _, n in unsup.categories)
    assert pairs == 106773
    assert pairs * per_pair / 1e12 == pytest.approx(537.630, abs=1e-3)
    rect = sum(n * sup.n_train(n) for _, n in sup.categories)
    assert rect * per_pair / 1e12 == pytest.approx(1083.946, abs=1e-3)


def test_least_time_takes_the_larger_bound():
    assert least_s(989e12, 0, 0) == (1.0, "operations")
    assert least_s(0, 3.35e12, 3.35e12) == (2.0, "bytes")


def test_mixes_share_sizes_and_order():
    unsup, sup = _mix("mvtec15-unsup"), _mix("mvtec15-sup")
    assert unsup.categories == sup.categories
    assert unsup.names[0] == "bottle" and unsup.names[-1] == "zipper"
    assert (unsup.mode, sup.mode) == ("unsupervised", "supervised")
    assert sup.n_train(167) == 167 and unsup.n_train(167) == 0


def _tree_digest(root):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            p = os.path.join(d, f)
            h.update(os.path.relpath(p, root).encode())
            h.update(open(p, "rb").read())
    return h.hexdigest()


TINY = traffic.Mix(name="t", categories=(("a", 5), ("b", 3)),
                   mode="supervised", train_ratio=1.0, source_image_size=48,
                   resize=40, imagesize=32, anomaly_types=3, train_seed=1,
                   check_categories=1)


def test_tree_is_a_function_of_the_seed(tmp_path):
    big = 2 ** 33 + 5
    for i, seed in enumerate((big, big, big + 1)):
        traffic.write_tree(str(tmp_path / str(i)), TINY, seed)
    d = [_tree_digest(str(tmp_path / str(i))) for i in range(3)]
    assert d[0] == d[1] != d[2]


def test_tree_layout(tmp_path):
    from PIL import Image

    traffic.write_tree(str(tmp_path), TINY, 7)
    for cat, n in TINY.categories:
        test = tmp_path / cat / "test"
        got = {a: len(os.listdir(test / a)) for a in os.listdir(test)}
        assert got == dict(traffic.anomaly_split(n, 3))
        for a in got:
            if a != "good":
                assert len(os.listdir(tmp_path / cat / "ground_truth" / a)) \
                    == got[a]
        assert len(os.listdir(tmp_path / cat / "train" / "good")) == n
        img = Image.open(next((test / "good").iterdir()))
        assert img.size == (48, 48) and img.mode == "RGB"


def test_check_sample_is_drawn_from_the_seed():
    mix = _mix("mvtec15-unsup")
    picks = {tuple(traffic.check_sample(mix, s)) for s in range(40)}
    assert len(picks) > 10
    for p in picks:
        assert len(p) == 3 and list(p) == [c for c in mix.names if c in p]
        # the largest and the smallest category are always compared
        assert "pill" in p and "toothbrush" in p
    assert traffic.check_sample(mix, 2 ** 40) == \
        traffic.check_sample(mix, 2 ** 40)


def test_weights_are_a_function_of_the_seed():
    import torch

    from benchmark.harness.weights import make_weights

    spec = [("a", (3, 4), 0.02, 0.0), ("b", (5,), 0.0, 1.0),
            ("c", (2, 2), 0.5, 1.0)]
    w1 = make_weights(spec, 2 ** 35, "cpu", torch.bfloat16)
    w2 = make_weights(spec, 2 ** 35, "cpu", torch.bfloat16)
    w3 = make_weights(spec, 2 ** 35 + 1, "cpu", torch.bfloat16)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["a"], w3["a"])
    assert w1["a"].dtype == torch.bfloat16 and w1["a"].shape == (3, 4)
    assert torch.equal(w1["b"], torch.ones(5, dtype=torch.bfloat16))
    assert abs(float(w1["c"].float().mean()) - 1.0) < 1.5
    assert np.isfinite(w1["a"].float().numpy()).all()


@pytest.mark.parametrize("name,base", [
    ("void (anonymous namespace)::min_dists_kernel<false, 1>((anonymous "
     "namespace)::Maps, (anonymous namespace)::Params)", "min_dists_kernel"),
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN",
     "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel"
     "<c10::BFloat16, float, false>(int, float)",
     "vectorized_layer_norm_kernel")])
def test_kernel_base_names(name, base):
    from benchmark.harness.tracewin import kernel_base

    assert kernel_base(name) == base


class _Event:
    def __init__(self, name, dev, s, e, tid=1, annotation=False):
        self._v = (name, dev, s, e, tid, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def start_thread_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_trace_window_busy_idle_and_labels():
    from benchmark.harness import tracewin

    s = 10 ** 9  # ns
    ev = [_Event("bench.window", "CPU", 0, 10 * s, annotation=True),
          _Event("bench.window", "CUDA", 0, 10 * s, annotation=True),
          _Event("bench.sweep", "CPU", 0, 10 * s, annotation=True),
          _Event("void (anonymous namespace)::min_dists_kernel<false, 1>()",
                 "CUDA", 1 * s, 3 * s),
          _Event("gemm", "CUDA", 2 * s, 4 * s),
          _Event("Memcpy HtoD (Pinned -> Device)", "CUDA", 5 * s, 6 * s),
          _Event("cudaEventSynchronize", "CPU", 6 * s, 8 * s),
          _Event("aten::other_thread", "CPU", 0, 10 * s, tid=2),
          _Event("gemm", "CUDA", 9 * s, 12 * s)]
    w = tracewin.read_events(ev)
    assert w.window_s == 10.0 and w.busy_s == 5.0 and w.n_kernels == 3
    assert w.kernel_s(lambda b: b.startswith("min_dists")) == 2.0
    assert w.kernel_s(lambda b: b == "gemm") == 3.0  # clipped at the end
    assert dict(w.idle_gaps) == {"bench.sweep": 2.0,
                                 "cudaEventSynchronize": 3.0}


def test_device_busy_is_the_union_of_device_intervals():
    """``--trace 0``'s reading: kernels, copies and memsets merged where
    they overlap; host events and ranges are not device time."""
    from benchmark.harness import tracewin

    s = 10 ** 9  # ns
    ev = [_Event("bench.window", "CUDA", 0, 10 * s, annotation=True),
          _Event("min_dists_kernel", "CUDA", 1 * s, 3 * s),
          _Event("gemm", "CUDA", 2 * s, 4 * s),
          _Event("Memset (Device)", "CUDA", 5 * s, 6 * s),
          _Event("cudaLaunchKernel", "CPU", 6 * s, 9 * s),
          _Event("gemm", "CUDA", 9 * s, 12 * s)]
    assert tracewin.device_busy_s(ev) == 7.0
    assert tracewin.device_busy_s([]) == 0.0


def test_sweep_mfu_is_the_work_over_busy_time():
    from benchmark.harness import tracewin
    from benchmark.harness.peaks import PEAK_BF16_FLOPS

    read = manifest.load_module(os.path.join(BENCH, "metrics",
                                             "sweep_mfu.py"), "m_sweep_mfu").read
    w = tracewin.TraceWindow(window_s=4.0, busy_s=2.0, n_kernels=1,
                             kernel_s_by_name={}, device_ops=[],
                             idle_gaps=[])
    assert read(w) is None  # no work reckoned
    w.work = {"embed_flops": 0.25 * PEAK_BF16_FLOPS,
              "min_dists_flops": 0.75 * PEAK_BF16_FLOPS}
    assert read(w) == pytest.approx(50.0)
    w.busy_s = 0.0
    assert read(w) is None
