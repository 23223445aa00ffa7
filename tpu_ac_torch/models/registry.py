"""Backbone registry for the DINO ViT and the torchvision ResNet names
(port of those specs of ``tpu_ac.models.registry``, with its checkpoint
contract).

Weights come from ``checkpoint_path`` if given, else from the first file
named by the spec under ``checkpoint_dir`` and then the default cache dirs
``_DEFAULT_CKPT_DIRS``, the same two as ``tpu_ac``'s: its own install dir
(``cli/convert.py --install``) and torch.hub's, where the reference keeps
``dino_vitbase8_pretrain.pth`` and torchvision keeps
``wide_resnet50_2-95faca4d.pth``.  One installed file feeds both packages.
The file is read by ``models.convert.load_torch_checkpoint`` (the spec's
``checkpoint_key``, ``state_dict`` wrappers, prefixes, BN counters
dropped); tensors the model does not have are ignored, as ``tpu_ac``
ignores them, and a missing key or a wrong shape raises.  Without a file:
the seeded random init that ``tpu_ac`` uses, with the same warning.  The
other backbone families are still to be ported (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from tpu_ac_torch.models import resnet as _resnet
from tpu_ac_torch.models.convert import load_jax_params, load_torch_checkpoint
from tpu_ac_torch.models.vit import VIT_BASE, VIT_SMALL, ViT, init_vit_params

LOGGER = logging.getLogger(__name__)

_DEFAULT_CKPT_DIRS = (
    os.path.expanduser("~/.cache/tpu_ac/checkpoints"),
    os.path.expanduser("~/.cache/torch/hub/checkpoints"),
)


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    family: str  # "vit" | "resnet"
    config: object
    checkpoint: str | None  # filename of the released weights
    checkpoint_key: str | None = None


BACKBONE_CONFIGS: dict[str, BackboneSpec] = {
    "dino_vitbase8": BackboneSpec(
        "vit", dataclasses.replace(VIT_BASE, patch_size=8),
        "dino_vitbase8_pretrain.pth"),
    "dino_vitbase16": BackboneSpec(
        "vit", dataclasses.replace(VIT_BASE, patch_size=16),
        "dino_vitbase16_pretrain.pth"),
    "dino_deitsmall16": BackboneSpec(
        "vit", dataclasses.replace(VIT_SMALL, patch_size=16),
        "dino_deitsmall16_pretrain.pth"),
    "dino_deitsmall8_300ep": BackboneSpec(
        "vit", dataclasses.replace(VIT_SMALL, patch_size=8),
        "dino_deitsmall8_300ep_pretrain.pth"),
    "dino_deitsmall8": BackboneSpec(
        "vit", dataclasses.replace(VIT_SMALL, patch_size=8),
        "dino_deitsmall8_pretrain.pth"),
    # torchvision names of the reference registry (backbones.py:7-50)
    "resnet18": BackboneSpec("resnet", _resnet.RESNET18,
                             "resnet18-f37072fd.pth"),
    "resnet34": BackboneSpec("resnet", _resnet.RESNET34,
                             "resnet34-b627a593.pth"),
    "resnet50": BackboneSpec("resnet", _resnet.RESNET50,
                             "resnet50-0676ba61.pth"),
    "resnet101": BackboneSpec("resnet", _resnet.RESNET101,
                              "resnet101-63fe2227.pth"),
    "wideresnet50": BackboneSpec("resnet", _resnet.WIDE_RESNET50_2,
                                 "wide_resnet50_2-95faca4d.pth"),
    "wideresnet101": BackboneSpec("resnet", _resnet.WIDE_RESNET101_2,
                                  "wide_resnet101_2-32ee1156.pth"),
    "resnet200": BackboneSpec("resnet", _resnet.RESNET200, "resnet200.pth"),
    "resnext101": BackboneSpec("resnet", _resnet.RESNEXT101_32X8D,
                               "resnext101_32x8d-8ba56ff5.pth"),
    "dino_resnet50": BackboneSpec("resnet", _resnet.RESNET50,
                                  "dino_resnet50_pretrain.pth"),
}

# the shipped registry, before any runtime register_backbone (tests
# register tiny architectures): the frozen manifests cover exactly this set
BUILTIN_BACKBONES = frozenset(BACKBONE_CONFIGS)

# family -> (module class, numpy init); a family not here is not ported
FAMILY_MODELS = {
    "vit": (ViT, init_vit_params),
    "resnet": (_resnet.ResNet, _resnet.init_resnet_params),
}


def register_backbone(name: str, spec: BackboneSpec) -> None:
    BACKBONE_CONFIGS[name] = spec


def _find_checkpoint(filename: str | None,
                     checkpoint_dir: str | None) -> str | None:
    if filename is None:
        return None
    dirs = ((checkpoint_dir,) if checkpoint_dir else ()) + _DEFAULT_CKPT_DIRS
    for d in dirs:
        path = os.path.join(d, filename)
        if os.path.exists(path):
            return path
    return None


def load_backbone(name: str, *, checkpoint_dir: str | None = None,
                  checkpoint_path: str | None = None, seed: int = 0,
                  use_checkpoint: bool = True):
    """Resolve a backbone name to (module on the CPU in f32, config,
    family).  ``use_checkpoint=False`` forces the random init even when a
    checkpoint is cached (structure probes need the architecture's own
    keys)."""
    if name not in BACKBONE_CONFIGS:
        raise KeyError(f"Unknown backbone '{name}'. "
                       f"Registered: {sorted(BACKBONE_CONFIGS)}")
    spec = BACKBONE_CONFIGS[name]
    if spec.family not in FAMILY_MODELS:
        raise NotImplementedError(
            f"family {spec.family} is not ported (ROADMAP.md Queue 1 item 9)")
    module_cls, init = FAMILY_MODELS[spec.family]
    path = None
    if use_checkpoint:
        path = checkpoint_path or _find_checkpoint(spec.checkpoint,
                                                   checkpoint_dir)
    # built without initialising its tensors: every one is loaded below
    with torch.device("meta"):
        model = module_cls(spec.config)
    model = model.to_empty(device="cpu")
    if path is not None:
        params = load_torch_checkpoint(path, spec.checkpoint_key)
        want = model.state_dict()
        params = {k: v for k, v in params.items() if k in want}
    else:
        LOGGER.warning(
            "No checkpoint found for %s — using random init (seed=%d). "
            "Place the released weights in %s for metric parity.",
            name, seed, _DEFAULT_CKPT_DIRS[0])
        params = init(seed, spec.config)
    load_jax_params(model, params)
    return model.eval().requires_grad_(False), spec.config, spec.family
