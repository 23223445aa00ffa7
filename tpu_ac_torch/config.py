"""The SCAN config system (port of ``tpu_ac.config``).

SCAN's two-file YAML (env.yml + experiment.yml merged into an EasyDict
with derived artifact paths, Unsupervised-Classification-master/utils/
config.py:10-52): YAML/dict configs with attribute access, a recursive
merge, and the derived output paths of each stage.  The paths are
``tpu_ac``'s, so a stage of either package finds the artifacts of the
other.  ``tpu_ac_torch/configs/`` is the port's own copy of the
experiment files.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs")


class Config(dict):
    """dict with attribute access (EasyDict equivalent)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj


def load_yaml(path: str) -> Config:
    import yaml

    with open(path) as f:
        return Config.wrap(yaml.safe_load(f) or {})


def merge(base: Mapping, override: Mapping) -> Config:
    """Recursive merge; override wins."""
    out = Config.wrap(dict(base))
    for k, v in override.items():
        if (k in out and isinstance(out[k], Mapping)
                and isinstance(v, Mapping)):
            out[k] = merge(out[k], v)
        else:
            out[k] = Config.wrap(v)
    return out


def create_config(env_file: str, exp_file: str,
                  makedirs: bool = True) -> Config:
    """SCAN create_config (utils/config.py:10-52): env + experiment YAML
    merge plus the derived per-stage artifact paths."""
    env = load_yaml(env_file)
    cfg = merge(env, load_yaml(exp_file))

    root = cfg.get("root_dir", env.get("root_dir", "./outputs"))
    db = cfg.get("train_db_name", "dataset")
    base = os.path.join(root, db)
    pretext_dir = os.path.join(base, "pretext")
    cfg["pretext_dir"] = pretext_dir
    cfg["pretext_checkpoint"] = os.path.join(pretext_dir, "checkpoint.pth.tar")
    cfg["pretext_model"] = os.path.join(pretext_dir, "model.pth.tar")
    cfg["topk_neighbors_train_path"] = os.path.join(
        base, f"top{cfg.get('num_neighbors', 20)}-train-neighbors.npy")
    # val mining always uses top-5 (moco.py:103-110, simclr.py final eval)
    cfg["topk_neighbors_val_path"] = os.path.join(
        base, f"top{cfg.get('num_neighbors_val', 5)}-val-neighbors.npy")
    for stage in ("scan", "selflabel"):
        sdir = os.path.join(base, stage)
        cfg[f"{stage}_dir"] = sdir
        cfg[f"{stage}_checkpoint"] = os.path.join(sdir, "checkpoint.pth.tar")
        cfg[f"{stage}_model"] = os.path.join(sdir, "model.pth.tar")
    if makedirs:
        for d in (pretext_dir, cfg["scan_dir"], cfg["selflabel_dir"]):
            os.makedirs(d, exist_ok=True)
    return cfg
