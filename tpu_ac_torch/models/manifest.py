"""Frozen per-backbone checkpoint manifests: key -> shape inventories (port
of ``tpu_ac.models.manifest``).

``manifests.json`` beside this module holds, for every built-in registry
name, the exact state_dict keys and shapes the architecture expects (150
keys for ``dino_vitbase8``); its entries equal ``tpu_ac``'s.  An
architecture's inventory is read from its module built on the meta device
(``registry.build_on_meta``): no storage and no random init, so the
0.9 G-parameter ``resnetv2_152_*`` names cost no more than a small one.
It makes two failures visible without any weights:

1. architecture drift: a change to a model's parameter inventory breaks
   ``tests/test_torch_checkpoints.py``;
2. checkpoint mismatch: ``python -m tpu_ac_torch.cli.convert ckpt
   --backbone X --verify`` diffs a real checkpoint against the manifest
   before anything is installed.

Regenerate after an intentional architecture change with
``python -m tpu_ac_torch.cli.convert --update_manifests``.  The names that
only the port has (``registry.PORT_BACKBONES``) are frozen beside it, in
``port_manifests.json``, so that ``manifests.json`` stays ``tpu_ac``'s.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np

MANIFEST_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "manifests.json")
PORT_MANIFEST_PATH = os.path.join(os.path.dirname(MANIFEST_PATH),
                                  "port_manifests.json")


def params_inventory(params: Mapping[str, object]) -> dict[str, list[int]]:
    """{key: shape list} of a params dict or state_dict (sorted keys)."""
    return {k: [int(n) for n in np.shape(params[k])] for k in sorted(params)}


def generate_manifest(name: str) -> dict[str, list[int]]:
    """Inventory of one registry name's architecture (built on meta)."""
    from tpu_ac_torch.models.registry import build_on_meta

    return params_inventory(build_on_meta(name).state_dict())


def generate_all(names=None) -> dict[str, dict[str, list[int]]]:
    # the built-in names by default, never a spec registered at run time
    from tpu_ac_torch.models.registry import BUILTIN_BACKBONES

    names = sorted(BUILTIN_BACKBONES) if names is None else names
    return {name: generate_manifest(name) for name in names}


def load_manifests(path: str = MANIFEST_PATH
                   ) -> dict[str, dict[str, list[int]]]:
    with open(path) as f:
        return json.load(f)


def save_manifests(manifests: dict, path: str = MANIFEST_PATH) -> None:
    with open(path, "w") as f:
        json.dump(manifests, f, indent=0, sort_keys=True)
        f.write("\n")


def diff_inventory(expected: Mapping[str, list[int]],
                   got: Mapping[str, list[int]]) -> dict[str, list]:
    """missing / unexpected / shape_mismatch of ``got`` vs ``expected``."""
    missing = sorted(k for k in expected if k not in got)
    unexpected = sorted(k for k in got if k not in expected)
    mismatch = sorted(
        (k, list(expected[k]), list(got[k]))
        for k in expected if k in got and list(expected[k]) != list(got[k]))
    return {"missing": missing, "unexpected": unexpected,
            "shape_mismatch": mismatch}


def verify_checkpoint(params: Mapping[str, object], backbone: str
                      ) -> dict[str, list]:
    """Diff a converted checkpoint's inventory against the frozen manifest."""
    manifests = {**load_manifests(), **load_manifests(PORT_MANIFEST_PATH)}
    if backbone not in manifests:
        raise KeyError(f"no frozen manifest for {backbone!r}; regenerate "
                       "with --update_manifests")
    return diff_inventory(manifests[backbone], params_inventory(params))
