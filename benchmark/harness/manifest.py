"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's entry names its file (``configs/<name>.json``),
which names its FLOP module and its plain reference module; the mix is
``traffic/<mix>.json``; the comparison's limits are
``limits/<cell>.json``; a per-layer metric is read by
``metrics/<metric>.py``.  A later cell, mix, configuration or metric is
new files and new entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# the top-level module names that no process of the benchmark may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpu_ac")


@dataclasses.dataclass
class Cell:
    """One workload with everything it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    bench_dir: str

    def path(self, rel: str) -> str:
        """A path of the manifest (relative to the repository root) or of
        a config (relative to this folder) as a file name."""
        return os.path.join(self.bench_dir, rel)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: str = REPO_ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def check_names(manifest: dict) -> list[str]:
    """Every name, unit and ``better`` of the manifest against the
    contract's characters; the list of faults (empty when sound)."""
    bad = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in manifest[key]]
        if len(set(names)) != len(names):
            bad.append(f"{key}: a name twice")
        for e in manifest[key]:
            for field in ("name", "config", "traffic"):
                if field in e and not NAME_RE.match(e[field]):
                    bad.append(f"{key}: {field} {e[field]!r}")
            if "unit" in e and not UNIT_RE.match(e["unit"]):
                bad.append(f"{key}: unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                bad.append(f"{key}: better {e['better']!r}")
            for k in e.get("reduced", []):
                if not NAME_RE.match(k):
                    bad.append(f"{key}: reduced key {k!r}")
    return bad


def load_cell(name: str, root: str = REPO_ROOT) -> Cell:
    """The workload ``name`` of ``root``'s manifest with its config,
    traffic, limits and metric entries; raises ``KeyError`` for a name the
    manifest lacks."""
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"workload {name!r}; the manifest has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench_dir = os.path.join(root, manifest["paths"][0])
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(bench_dir, "traffic",
                                      f"{w['traffic']}.json"))
    limits = _read_json(os.path.join(bench_dir, "limits", f"{name}.json"))

    def mine(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in manifest["end_to_end"] if mine(m)],
                per_layer=[m for m in manifest["per_layer"] if mine(m)],
                bench_dir=bench_dir)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module of its own (file names carry
    the configs' and metrics' names, which hold dots and dashes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_module(cell: Cell, key: str):
    """The config's ``flops`` or ``reference`` module."""
    rel = cell.config[key]
    tag = re.sub(r"\W", "_", f"{key}_{cell.config['name']}")
    return load_module(cell.path(rel), f"bench_{tag}")


def metric_reader(cell: Cell, metric: str):
    """``metrics/<metric>.py``'s ``read`` function."""
    tag = re.sub(r"\W", "_", metric)
    mod = load_module(os.path.join(cell.bench_dir, "metrics",
                                   f"{metric}.py"), f"bench_metric_{tag}")
    return mod.read


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is one the benchmark may not load."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)
