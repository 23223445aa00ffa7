"""``metrics/embed_ms_per_img.py``: the device time of every kernel but
``min_dists*`` over the window's test images."""

import os

import pytest

from benchmark.harness import manifest, tracewin


def test_embed_ms_per_img_leaves_out_the_distance_kernel():
    read = manifest.load_module(
        os.path.join(manifest.BENCH_DIR, "metrics", "embed_ms_per_img.py"),
        "m_embed_ms_per_img").read
    w = tracewin.TraceWindow(
        window_s=4.0, busy_s=3.0, n_kernels=3,
        kernel_s_by_name={"min_dists_kernel": 1.0, "nvjet_tst": 1.5,
                          "flash_fwd_bf16": 0.5},
        device_ops=[], idle_gaps=[])
    assert read(w) is None  # no images in the window
    w.work = {"test_images": 1000.0}
    assert read(w) == pytest.approx(2.0)
    w.kernel_s_by_name = {"min_dists_kernel": 1.0}
    assert read(w) is None  # nothing but the distance kernel ran
