"""Both DINO CLIs (tpu_ac.cli.dino and tpu_ac_torch.cli.dino --device
cpu) on tests/test_dino_cli.py's 12-image 40 px folder.

A checkpoint of this model is 170 MB (vit_tiny's 12 blocks and the
2048-wide head, four copies), so the runs skip the periodic copy
(--saveckp_freq 0) and each output dir that no later test reads is
removed as soon as its losses are read.

Tolerances: the PIL crops are bit-equal, so in f32 the two runs differ
only in summation order: each epoch's train_loss within 1e-5 relative,
every checkpoint leaf within 2e-6 plus Adam's sign swing on gradients
near zero, 2 x lr a step (lr here is at most 7.8e-6: 0.0005 x 4/256; see
tests/test_torch_dino_train.py).  The port's own flag runs are equal to
its plain run.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from tpu_ac_torch.cli import dino as tcli

STEPS, EPOCHS = 2, 2
MAX_LR = 0.0005 * 4 / 256


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny model gains nothing from more threads, and the suite runs
    several test processes at once: one intra-op thread avoids
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("dino_data")
    rng = np.random.default_rng(0)
    for cls in ("a", "b"):
        d = root / cls
        d.mkdir()
        for i in range(6):
            arr = rng.integers(0, 255, (40, 40, 3)).astype(np.uint8)
            Image.fromarray(arr).save(d / f"{i}.png")
    return str(root)


def _args(folder, out, use_fp16="false", extra=()):
    return ["--arch", "vit_tiny", "--patch_size", "16",
            "--data_path", folder, "--output_dir", out,
            "--global_size", "32", "--local_size", "16",
            "--local_crops_number", "2", "--out_dim", "128",
            "--batch_size_per_gpu", "4", "--epochs", str(EPOCHS),
            "--max_steps_per_epoch", str(STEPS), "--warmup_epochs", "0",
            "--saveckp_freq", "0", "--use_fp16", use_fp16, *extra]


def _losses(out):
    with open(os.path.join(out, "log.txt")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == list(range(len(rows)))
    return [r["train_loss"] for r in rows]


def _run(folder, out, extra=(), use_fp16="false", keep=False):
    tcli.main(_args(folder, out, use_fp16,
                    ["--device", "cpu", *extra]))
    losses = _losses(out)
    if not keep:
        shutil.rmtree(out)
    return losses


def _leaves(out, epoch):
    with np.load(os.path.join(out, f"checkpoint-{epoch:08d}",
                              "arrays.npz")) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


@pytest.fixture(scope="module")
def tpu_ac_run(folder, tmp_path_factory):
    from tpu_ac.cli.dino import main

    out = str(tmp_path_factory.mktemp("tpu_ac_out"))
    main(_args(folder, out))
    yield out
    shutil.rmtree(out)


@pytest.fixture(scope="module")
def port_run(folder, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_out"))
    _run(folder, out, keep=True)
    yield out
    shutil.rmtree(out)


def _assert_leaves_close(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=2e-6 + 2 * MAX_LR * STEPS * EPOCHS,
                                   err_msg=f"leaf {i}")


def test_f32_matches_tpu_ac(tpu_ac_run, port_run):
    np.testing.assert_allclose(_losses(port_run), _losses(tpu_ac_run),
                               rtol=1e-5)
    _assert_leaves_close(_leaves(port_run, EPOCHS - 1),
                         _leaves(tpu_ac_run, EPOCHS - 1))
    assert sorted(os.listdir(port_run)) == sorted(os.listdir(tpu_ac_run))


def test_resume_from_a_tpu_ac_checkpoint(folder, tpu_ac_run, tmp_path):
    """tpu_ac's run cut after epoch 0, resumed by the port: epoch 1 as in
    tpu_ac's uninterrupted run."""
    out = str(tmp_path / "resumed")
    shutil.copytree(tpu_ac_run, out)
    shutil.rmtree(os.path.join(out, f"checkpoint-{EPOCHS - 1:08d}"))
    with open(os.path.join(out, "log.txt")) as f:
        first = f.readline()
    with open(os.path.join(out, "log.txt"), "w") as f:
        f.write(first)
    losses = _run(folder, out, keep=True)
    np.testing.assert_allclose(losses, _losses(tpu_ac_run), rtol=1e-5)
    _assert_leaves_close(_leaves(out, EPOCHS - 1),
                         _leaves(tpu_ac_run, EPOCHS - 1))
    shutil.rmtree(out)


def test_bf16_finite(folder, tmp_path):
    losses = _run(folder, str(tmp_path / "bf16"), use_fp16="true")
    assert np.isfinite(losses).all()


def test_flags_equal_the_plain_run(folder, port_run, tmp_path):
    """--steps_per_dispatch 2 (one group an epoch), --remat,
    --host_normalize and a serial loader run the same ops on the same
    crops (the step-level tests hold --host_schedules and "dots")."""
    extra = ["--steps_per_dispatch", "2", "--remat", "true",
             "--host_normalize", "--num_workers", "0"]
    assert _run(folder, str(tmp_path / "flags"), extra) == _losses(port_run)


def test_device_aug_deterministic_and_grouped(folder, tmp_path):
    """One epoch of 3 steps: grouped by 2 (a group and a ragged tail) and
    from the base cache, the crops and losses of the plain run."""
    extra = ["--device_aug", "--base_size", "48", "--epochs", "1",
             "--max_steps_per_epoch", "3"]
    a = _run(folder, str(tmp_path / "a"), extra)
    assert np.isfinite(a).all()
    k2 = _run(folder, str(tmp_path / "k2"),
              extra + ["--steps_per_dispatch", "2"])
    assert k2 == a
    cache = str(tmp_path / "cache")
    cached = _run(folder, str(tmp_path / "c"),
                  extra + ["--data_cache", cache])
    assert cached == a and len(os.listdir(cache)) == 1
    shutil.rmtree(cache)


def test_flag_conflicts_exit(folder, tmp_path):
    for extra, match in ((["--data_cache", "x"], "--device_aug"),
                         (["--device_aug", "--host_schedules"],
                          "resident"),
                         (["--steps_per_dispatch", "2", "--host_schedules"],
                          "resident")):
        with pytest.raises(SystemExit, match=match):
            tcli.main(_args(folder, str(tmp_path / "bad"),
                            extra=["--device", "cpu", *extra]))


def test_nan_loss_stops_training(folder, tmp_path):
    with pytest.raises(SystemExit) as e:
        tcli.main(_args(folder, str(tmp_path / "nan"),
                        extra=["--device", "cpu", "--lr", "1e38"]))
    assert e.value.code == 1
    assert not os.path.exists(tmp_path / "nan" / "log.txt")
    assert not any(n.startswith("checkpoint")
                   for n in os.listdir(tmp_path / "nan"))


def test_profile_writes_a_trace(folder, tmp_path):
    trace = str(tmp_path / "trace")
    tcli.main(_args(folder, str(tmp_path / "p"),
                    extra=["--device", "cpu", "--profile", trace,
                           "--epochs", "1", "--max_steps_per_epoch", "1"]))
    with open(os.path.join(trace, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "dino_step#0" in names
    shutil.rmtree(tmp_path / "p")


def test_remat_flag_parses():
    assert tcli._remat_flag("DOTS") == "dots"
    assert tcli._remat_flag("true") is True
    assert tcli._remat_flag("off") is False


def test_default_device_raises_without_a_card(folder, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = tmp_path / "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--data_path", folder, "--output_dir", str(out)])
    assert not out.exists()
