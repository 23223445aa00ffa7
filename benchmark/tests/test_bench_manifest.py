"""``BENCHMARK.json`` and the files it names, against the benchmark's
contract: keys, names and units, paths, bounds, the time budget, and what
the harness may import."""

import ast
import json
import os
import re

import pytest

from benchmark.harness import manifest

ROOT = manifest.REPO_ROOT
BENCH = manifest.BENCH_DIR
M = manifest.load_manifest()

# this benchmark's first cells and metrics; later entries add to them
E2E = ["sweep_busy_s", "peak_mem_gib", "setup_s"]
PER_LAYER = ["min_dists_roofline_pct", "embed_flops_pct",
             "launches_per_img", "sweep_mfu"]
CELLS = ["vitb8-mvtec15-unsup", "wrn50-mvtec15-unsup", "vitb8-mvtec15-sup"]
ALL_CELLS = [w["name"] for w in M["workloads"]]
LINE_RE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths():
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in M["command"]:
        assert LINE_RE.match(word)


def test_names_and_units():
    assert manifest.check_names(M) == []


def test_cells():
    assert ALL_CELLS[:3] == CELLS
    assert all(w["chips"] == 1 for w in M["workloads"][:3])
    assert 1 <= len(ALL_CELLS) <= 24
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(
        1, len(ALL_CELLS) // 4)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    configs = {c["name"] for c in M["configs"]}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert LINE_RE.match(w["why"])
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           w["name"] + ".json"))
    assert {w["config"] for w in M["workloads"]} == configs


@pytest.mark.parametrize("entry", M["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith(M["paths"][0] + "/")
    assert len(entry["reduced"]) <= 16
    cfg = json.load(open(os.path.join(ROOT, entry["file"])))
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    for key in ("flops", "reference"):
        assert os.path.exists(os.path.join(BENCH, cfg[key]))


def test_metrics():
    assert [m["name"] for m in M["end_to_end"]][:3] == E2E
    assert [m["name"] for m in M["per_layer"]][:4] == PER_LAYER
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert M["end_to_end"][2]["bound"] == 0.25
    for m in M["per_layer"][:4]:
        assert m["moves"] == "sweep_busy_s" and m["workloads"] == CELLS
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in M["end_to_end"]]
        assert LINE_RE.match(m["layer"])
        assert set(m["workloads"]) <= set(ALL_CELLS)
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def test_run_seconds_fits_the_check_budget():
    rs = M["run_seconds"]
    assert 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_forbidden_imports():
    """Nothing of the benchmark imports JAX, the JAX package, or the old
    JAX-era harness (``chip_smoke.py``, ``bench.py``)."""
    bad = {"jax", "jaxlib", "flax", "tpu_ac", "chip_smoke", "bench"}
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in bad, (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("tpu_ac_torch", "tpu_ac"), \
                (path, mod)


def test_forbidden_module_check_compares_whole_top_level_names():
    mods = {"tpu_ac_torch": 1, "tpu_ac_torch.pipeline": 1, "jaxtyping": 1,
            "tpu_ac.models": 1, "jax": 1, "flax.linen": 1, "numpy": 1}
    assert manifest.forbidden_modules(mods) == ["flax.linen", "jax",
                                                "tpu_ac.models"]
