"""Torch checkpoints and ``tpu_ac`` params dicts into ``tpu_ac_torch``
modules (port of ``tpu_ac.models.convert``).

Param keys mirror the torch state_dict names of the released DINO, timm
and torchvision checkpoints, and a params dict is numpy arrays under those
keys, so one set of weights feeds both packages.
``load_torch_checkpoint`` reads a ``.pth`` the way ``tpu_ac`` does (sub-dict
key, ``state_dict`` wrapper, torchvision's legacy DenseNet keys remapped,
``module.`` / ``backbone.`` prefixes, BN counters dropped) into such a
dict; ``load_jax_params`` is the checked copy of a params dict into a
module; ``moco_to_contrastive_params`` renames a MoCo-v2 checkpoint for
SCAN's contrastive model.
"""

from __future__ import annotations

import logging
import pickle
import re
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

LOGGER = logging.getLogger(__name__)


def strip_prefixes(state_dict: Mapping[str, Any],
                   prefixes: tuple[str, ...] = ("module.", "backbone.")
                   ) -> dict[str, Any]:
    """Remove DDP / MultiCropWrapper prefixes (dino-main/utils.py:103-105)."""
    out = {}
    for k, v in state_dict.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        if k in out:
            LOGGER.warning(
                "prefix-stripped key collision: %r — the later entry wins "
                "(checkpoint holds e.g. both 'module.%s' and '%s')",
                k, k, k)
        out[k] = v
    return out


def torch_state_dict_to_params(state_dict: Mapping[str, Any]
                               ) -> dict[str, np.ndarray]:
    """A torch state_dict (tensors or arrays) -> a params dict of numpy
    arrays, prefixes stripped.

    ``num_batches_tracked`` BN counters are dropped: no forward reads them,
    and keeping them would fail manifest verification spuriously."""
    params = {}
    for k, v in strip_prefixes(state_dict).items():
        if k.endswith("num_batches_tracked"):
            continue
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        params[k] = np.asarray(v)
    return params


def load_torch_checkpoint(path: str, checkpoint_key: str | None = None
                          ) -> dict[str, np.ndarray]:
    """Load a ``.pth`` from disk and convert it to a params dict.

    The file is read with ``weights_only=True``.  A full training checkpoint
    (the case ``checkpoint_key`` exists for: "teacher"/"student" of DINO,
    dino-main/utils.py:84-92) carries non-tensor entries, argparse
    Namespaces and the like, that ``weights_only`` refuses; such a file is
    then read again with ``weights_only=False``, like the reference's own
    ``torch.load``, which unpickles arbitrary objects: load only files you
    trust.  A ``state_dict`` wrapper is unwrapped.
    """
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if checkpoint_key is not None and checkpoint_key in ckpt:
        ckpt = ckpt[checkpoint_key]
    if "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if any(".denselayer" in k for k in ckpt):
        ckpt = remap_densenet_keys(ckpt)
    return torch_state_dict_to_params(ckpt)


def moco_to_contrastive_params(state_dict: Mapping[str, Any]
                               ) -> dict[str, np.ndarray]:
    """An official MoCo-v2 checkpoint in ContrastiveModel names, as numpy
    arrays: ``module.encoder_q.*`` becomes the backbone's keys and its
    ``fc.0``/``fc.2`` the ``contrastive_head.0``/``.2``; every other key
    (the key encoder, the queue) is dropped
    (Unsupervised-Classification-master/moco.py:64-88)."""
    out: dict[str, np.ndarray] = {}
    for k, v in state_dict.items():
        if not k.startswith("module.encoder_q."):
            continue
        name = k[len("module.encoder_q."):]
        if name.startswith("fc."):
            name = "contrastive_head." + name[len("fc."):]
        out[name] = np.asarray(v.detach().cpu().numpy()
                               if isinstance(v, torch.Tensor) else v)
    return out


def remap_densenet_keys(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """torchvision's DenseNet files spell the dense layers' norms and convs
    the legacy way (``denselayer1.norm.1.weight``); rename them as
    torchvision's own loader does (``denselayer1.norm1.weight``)."""
    pattern = re.compile(
        r"^(.*denselayer\d+\.(?:norm|relu|conv))\.((?:[12])\.(?:weight|bias|"
        r"running_mean|running_var))$")
    out = {}
    for k, v in state_dict.items():
        m = pattern.match(k)
        if m:
            k = m.group(1) + m.group(2)
        out[k] = v
    return out


def validate_params_against_backbone(params: Mapping[str, Any],
                                     name: str) -> dict:
    """Key-coverage report of converted params against a registry
    backbone's structure: {"missing", "unexpected", "shape_mismatch"}, each
    a list of keys."""
    from tpu_ac_torch.models.manifest import (
        diff_inventory,
        generate_manifest,
        params_inventory,
    )

    # the structure comes from the architecture, never from a cached
    # checkpoint (which would compare the checkpoint with itself)
    report = diff_inventory(generate_manifest(name),
                            params_inventory(params))
    report["shape_mismatch"] = [k for k, *_ in report["shape_mismatch"]]
    return report


def state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """{name: array} -> {name: f32-preserving CPU tensor} (copies)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


# the inverse conversion, for a torch.save of converted params (the
# installed checkpoint format of both packages)
params_to_torch_state_dict = state_dict_from_jax


def load_jax_params(module: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Copy ``params`` into ``module`` in place, after checking that its
    keys and shapes are exactly the module's; returns the module."""
    want = module.state_dict()
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise KeyError(f"params do not match the module: missing {missing}, "
                       f"extra {extra}")
    sd = state_dict_from_jax(params)
    bad = [(k, tuple(sd[k].shape), tuple(want[k].shape))
           for k in want if sd[k].shape != want[k].shape]
    if bad:
        raise ValueError(f"shape mismatch (key, given, module): {bad}")
    module.load_state_dict(sd, strict=True)
    return module
