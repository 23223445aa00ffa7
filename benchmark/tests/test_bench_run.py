"""The harness end to end on the CPU, at tiny sizes, from a throwaway
manifest in a temporary directory: a configuration, mixes and limits that
the repository does not hold, found by name like any other.  The port runs
its CPU path (the kernels' plain versions); the look for a card is
skipped.  The same tiny cells show that the comparison passes the program,
fails the precision control, and fails each fault planted in the timed
path."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.harness import manifest

BENCH = manifest.BENCH_DIR
ROOT = manifest.REPO_ROOT
SEED = 2 ** 33 + 7

_VIT_ARCH = {"patch_size": 8, "embed_dim": 32, "depth": 2, "num_heads": 2,
             "mlp_ratio": 4.0, "qkv_bias": True, "ln_eps": 1e-6,
             "img_size": 32, "num_prefix_tokens": 1}
_RN_ARCH = {"block_counts": [1, 1, 1, 1], "width_per_group": 16,
            "expansion": 4, "block": "bottleneck", "groups": 1,
            "bn_eps": 1e-5, "num_classes": 10}

# the tiny cells: (name, config, mix, precision)
CELLS = [("vit-u", "tiny-vit", "tiny-unsup", "highest"),
         ("vit-s", "tiny-vit", "tiny-sup", "highest"),
         ("rn-u", "tiny-rn", "tiny-unsup", "highest"),
         ("vit-u-bf16", "tiny-vit-bf16", "tiny-unsup", "bfloat16"),
         ("vit-s-bf16", "tiny-vit-bf16", "tiny-sup", "bfloat16")]
# f32: the compensated distance mode drops lo x lo', which leaves a
# self-distance floor of about |z| 2^-9 in the j = i term that the program
# sums into W and the reference, exactly, does not (about 1e-3 of a row
# of alpha at N = 3-5); bf16: between the program's readings (2e-3 to
# 5e-3) and the fp8 control's (2e-2 to 2e-1) at these sizes
LIMITS = {"highest": {"alpha_gap": 5e-3, "x_gap": 5e-3},
          "bfloat16": {"alpha_gap": 1e-2, "x_gap": 2e-2}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from tpu_ac_torch.models.registry import (
        BACKBONE_CONFIGS,
        BackboneSpec,
        register_backbone,
    )
    from tpu_ac_torch.models.resnet import ResNetConfig
    from tpu_ac_torch.models.vit import ViTConfig

    vit = ViTConfig(**{k: v for k, v in _VIT_ARCH.items()})
    rn = ResNetConfig(**{**_RN_ARCH, "block_counts": (1, 1, 1, 1)})
    register_backbone("bench_tiny_vit", BackboneSpec("vit", vit, None))
    register_backbone("bench_tiny_rn", BackboneSpec("resnet", rn, None))
    root = tmp_path_factory.mktemp("bench_root")
    bd = root / "tinybench"
    shutil.copytree(os.path.join(BENCH, "metrics"), bd / "metrics")
    for d in ("configs", "traffic", "limits"):
        (bd / d).mkdir()
    base = {"layers": ["blocks.0", "blocks.1"],
            "pretrain_embed_dimension": 16, "target_embed_dimension": 32,
            "patchsize": 3, "tau": 1.0, "batch_size": 2,
            "attention_impl": "auto", "reduced": [],
            "flops": os.path.join(BENCH, "flops", "dino-vitb8.py"),
            "reference": os.path.join(BENCH, "reference", "dino-vitb8.py")}
    f32 = {"precision": "highest", "alpha_precision": "f32",
           "weights_dtype": "float32"}
    bf16 = {"precision": "bfloat16", "alpha_precision": "bf16",
            "weights_dtype": "bfloat16"}
    configs = {
        "tiny-vit": {**base, **f32, "backbone": "bench_tiny_vit",
                     "arch": _VIT_ARCH},
        "tiny-vit-bf16": {**base, **bf16, "backbone": "bench_tiny_vit",
                          "arch": _VIT_ARCH},
        "tiny-rn": {**base, **f32, "backbone": "bench_tiny_rn",
                    "arch": _RN_ARCH, "layers": ["layer2", "layer3"],
                    "flops": os.path.join(BENCH, "flops", "wrn50-2.py"),
                    "reference": os.path.join(BENCH, "reference",
                                              "wrn50-2.py")}}
    for name, cfg in configs.items():
        (bd / "configs" / f"{name}.json").write_text(
            json.dumps({"name": name, **cfg}))
    for name, mode in (("tiny-unsup", "unsupervised"),
                       ("tiny-sup", "supervised")):
        (bd / "traffic" / f"{name}.json").write_text(json.dumps({
            "name": name, "categories": [["a", 5], ["b", 3], ["c", 4]],
            "mode": mode, "train_ratio": 1.0, "source_image_size": 40,
            "resize": 40, "imagesize": 32, "anomaly_types": 2,
            "train_seed": 2023, "check_categories": 2}))
    for name, _, _, prec in CELLS:
        (bd / "limits" / f"{name}.json").write_text(json.dumps(
            {k: {"limit": v} for k, v in LIMITS[prec].items()}))
    m = manifest.load_manifest()
    m["paths"] = ["tinybench"]
    m["configs"] = [{"name": n, "file": f"tinybench/configs/{n}.json"}
                    for n in configs]
    m["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1}
                      for n, c, t, _ in CELLS]
    for metric in m["per_layer"]:
        metric.pop("workloads")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    yield str(root)
    for name in ("bench_tiny_vit", "bench_tiny_rn"):
        BACKBONE_CONFIGS.pop(name, None)


def _run(root, cell, capsys, trace=0, control=False, seed=SEED):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.2", "--trace", str(trace)], root=root, device="cpu",
                  control=control)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", ["vit-u", "vit-s", "rn-u"])
def test_reference_matches_the_port(root, cell, capsys):
    """A configuration and mixes that only a temporary directory holds;
    the reference against the port's CPU path in f32."""
    r = _run(root, cell, capsys)
    assert r["correct"] is True
    assert r["failed"] == 0 and r["attempted"] >= 3
    # sweep_busy_s is read from the card's activity: none on the CPU
    assert list(r["metrics"]) == ["peak_mem_gib", "setup_s"]
    assert list(r)[-1] == "check"
    assert r["check"]["alpha_gap"]["value"] < LIMITS["highest"]["alpha_gap"]
    if cell == "vit-s":  # no self term: the two agree to f32 rounding
        assert r["check"]["alpha_gap"]["value"] < 1e-4


@pytest.mark.parametrize("cell", ["vit-u-bf16", "vit-s-bf16"])
def test_precision_control_is_not_correct(root, cell, capsys):
    """The program in bf16 passes; the reference in fp8 e4m3 in its
    place does not."""
    assert _run(root, cell, capsys)["correct"] is True
    r = _run(root, cell, capsys, control=True)
    assert r["correct"] is False
    assert any(r["check"][n]["value"] > r["check"][n]["limit"]
               for n in ("alpha_gap", "x_gap"))


def _half_batch(monkeypatch):
    """W's mean over the other images taken over half of them."""
    from tpu_ac_torch import pipeline
    from tpu_ac_torch.kernels.distances import min_dists_all_pairs

    def weights(z, n_valid=None, precision="f32"):
        n = int(n_valid) if n_valid is not None else z.shape[0]
        mins = min_dists_all_pairs(z, z, precision=precision,
                                   symmetric=True, n_valid=n)
        h = max(n // 2, 1)
        w = mins[:, :h].sum(dim=1) / h
        return torch.where(torch.arange(z.shape[0])[:, None] < n, w, 0.0)

    monkeypatch.setattr(pipeline, "weight_distance_unsupervised", weights)


def _answer_altered(monkeypatch):
    """One image's X is the plain mean of its patches."""
    from tpu_ac_torch import pipeline

    orig = pipeline.weighted_embedding

    def altered(alpha, z):
        x = orig(alpha, z).clone()
        x[0] = z[0].mean(dim=0)
        return x

    monkeypatch.setattr(pipeline, "weighted_embedding", altered)


def _state_unchanged(monkeypatch):
    """Every second batch of the embed returns the batch before it."""
    from tpu_ac_torch import pipeline

    orig = pipeline.CategoryEmbedder._embed
    last = {}

    def stale(self, batch, model):
        k = last.get("k", 0)
        last["k"] = k + 1
        if k % 2 and "z" in last:
            return last["z"]
        last["z"] = orig(self, batch, model)
        return last["z"]

    monkeypatch.setattr(pipeline.CategoryEmbedder, "_embed", stale)


@pytest.mark.parametrize("fault", [_half_batch, _answer_altered,
                                   _state_unchanged],
                         ids=lambda f: f.__name__.strip("_"))
def test_planted_fault_is_not_correct(root, fault, capsys, monkeypatch):
    fault(monkeypatch)
    r = _run(root, "vit-u", capsys)
    assert r["correct"] is False


def test_traced_run_reports_the_window(root, capsys):
    r = _run(root, "rn-u", capsys, trace=1)
    dev = r["device"]
    assert dev["window_s"] > 0 and dev["busy_s"] == 0.0  # no card here
    assert r["metrics"] == {}  # no kernel to read on the CPU
    assert len(r["breakdown"]["idle_gaps"]) >= 1
    assert r["correct"] is True


def _cli(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "benchmark", "run.py"),
         "--workload", "vitb8-mvtec15-unsup", "--seed", "1", "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120)


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    p = _cli(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_bare_directory_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder (no
    program) gives no result, with or without a card."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""
