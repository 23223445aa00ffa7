"""Backbone registry: every name of ``tpu_ac.models.registry``, with its
config, checkpoint filename and ``checkpoint_key``.

Weights come from ``checkpoint_path`` if given, else from the first file
named by the spec under ``checkpoint_dir`` and then the default cache dirs
``_DEFAULT_CKPT_DIRS``, the same two as ``tpu_ac``'s: its own install dir
(``cli/convert.py --install``) and torch.hub's, where the reference keeps
``dino_vitbase8_pretrain.pth`` and torchvision keeps
``wide_resnet50_2-95faca4d.pth``.  One installed file feeds both packages.
The file is read by ``models.convert.load_torch_checkpoint`` (the spec's
``checkpoint_key``, ``state_dict`` wrappers, prefixes, BN counters
dropped, torchvision's DenseNet keys remapped); tensors the model does not
have are ignored, as ``tpu_ac`` ignores them, and a missing key or a wrong
shape raises.  Without a file: the seeded random init that ``tpu_ac``
uses, with the same warning.  ``FAMILY_MODELS`` maps each family to its
module class and numpy init; a family not there raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch

from tpu_ac_torch.models import densenet as _densenet
from tpu_ac_torch.models import efficientnet as _effnet
from tpu_ac_torch.models import inception as _inception
from tpu_ac_torch.models import resnest as _resnest
from tpu_ac_torch.models import resnet as _resnet
from tpu_ac_torch.models import resnetv2 as _resnetv2
from tpu_ac_torch.models import swin as _swin
from tpu_ac_torch.models import vgg as _vgg
from tpu_ac_torch.models import vit_hybrid as _hybrid
from tpu_ac_torch.models import xcit as _xcit
from tpu_ac_torch.models.convert import load_jax_params, load_torch_checkpoint
from tpu_ac_torch.models.vit import (
    VIT_BASE,
    VIT_GIANT2_REG4,
    VIT_LARGE,
    VIT_SMALL,
    ViT,
    init_vit_params,
)

LOGGER = logging.getLogger(__name__)

_DEFAULT_CKPT_DIRS = (
    os.path.expanduser("~/.cache/tpu_ac/checkpoints"),
    os.path.expanduser("~/.cache/torch/hub/checkpoints"),
)


@dataclasses.dataclass(frozen=True)
class BackboneSpec:
    family: str  # a key of FAMILY_MODELS
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
    "densenet121": BackboneSpec("densenet", _densenet.DENSENET121,
                                "densenet121-a639ec97.pth"),
    "densenet169": BackboneSpec("densenet", _densenet.DENSENET169,
                                "densenet169-b2777c0a.pth"),
    "densenet201": BackboneSpec("densenet", _densenet.DENSENET201,
                                "densenet201-c1103571.pth"),
    "alexnet": BackboneSpec("alexnet", _vgg.ALEXNET,
                            "alexnet-owt-7be5be79.pth"),
    "vgg11": BackboneSpec("vgg", _vgg.VGG11, "vgg11-8a719046.pth"),
    "vgg19": BackboneSpec("vgg", _vgg.VGG19, "vgg19-dcbb9e9d.pth"),
    "vgg19_bn": BackboneSpec("vgg", _vgg.VGG19_BN, "vgg19_bn-c79401a0.pth"),
    # timm names of the reference registry (backbones.py:14-49)
    "vit_small": BackboneSpec(
        "vit", dataclasses.replace(VIT_SMALL, patch_size=8),
        "vit_small_patch8_224.pth"),
    "vit_base": BackboneSpec(
        "vit", dataclasses.replace(VIT_BASE, patch_size=8),
        "vit_base_patch8_224.pth"),
    "vit_large": BackboneSpec(
        "vit", dataclasses.replace(VIT_LARGE, patch_size=8),
        "vit_large_patch8_224.pth"),
    "vit_deit_base": BackboneSpec(
        "vit", dataclasses.replace(VIT_BASE, patch_size=8),
        "deit_base_patch8_224.pth"),
    "vit_deit_distilled": BackboneSpec(
        "vit", dataclasses.replace(VIT_BASE, patch_size=8,
                                   num_prefix_tokens=2),
        "deit_base_distilled_patch8_224.pth"),
    "vit_r50": BackboneSpec("vit_hybrid", _hybrid.VIT_LARGE_R50_S32,
                            "vit_large_r50_s32_224.pth"),
    "inception_v4": BackboneSpec("inception_v4", _inception.INCEPTION_V4,
                                 "inception_v4.pth"),
    "bninception": BackboneSpec("bninception", _inception.BNINCEPTION,
                                "bn_inception.pth"),
    "resnest50": BackboneSpec("resnest", _resnest.RESNEST50D_4S2X40D,
                              "resnest50d_4s2x40d.pth"),
    "efficientnet_b1": BackboneSpec("efficientnet", _effnet.EFFICIENTNET_B1,
                                    "tf_efficientnet_b1.pth"),
    "efficientnet_b3": BackboneSpec("efficientnet", _effnet.EFFICIENTNET_B3,
                                    "tf_efficientnet_b3.pth"),
    "efficientnet_b5": BackboneSpec("efficientnet", _effnet.EFFICIENTNET_B5,
                                    "tf_efficientnet_b5.pth"),
    "efficientnet_b7": BackboneSpec("efficientnet", _effnet.EFFICIENTNET_B7,
                                    "tf_efficientnet_b7.pth"),
    # b3a: the B3 architecture trained natively, not a tf_ port: symmetric
    # k//2 padding and torch's BN eps
    "efficientnet_b3a": BackboneSpec(
        "efficientnet", dataclasses.replace(
            _effnet.EFFICIENTNET_B3, tf_same=False, bn_eps=1e-5),
        "efficientnet_b3a.pth"),
    "efficientnetv2_m": BackboneSpec(
        "efficientnetv2", _effnet.EFFICIENTNETV2_M,
        "tf_efficientnetv2_m.pth"),
    "efficientnetv2_l": BackboneSpec(
        "efficientnetv2", _effnet.EFFICIENTNETV2_L,
        "tf_efficientnetv2_l.pth"),
    "mnasnet_100": BackboneSpec("mnasnet", _effnet.MNASNET_B1,
                                "mnasnet_100.pth"),
    "mnasnet_b1": BackboneSpec("mnasnet", _effnet.MNASNET_B1,
                               "mnasnet_b1.pth"),
    "mnasnet_a1": BackboneSpec("mnasnet", _effnet.MNASNET_A1,
                               "mnasnet_a1.pth"),
}
# DINO's hub XCiTs (dino-main/hubconf.py:98-151)
for _name, _cfg in (("dino_xcit_small_12_p16", _xcit.XCIT_SMALL_12_P16),
                    ("dino_xcit_small_12_p8", _xcit.XCIT_SMALL_12_P8),
                    ("dino_xcit_medium_24_p16", _xcit.XCIT_MEDIUM_24_P16),
                    ("dino_xcit_medium_24_p8", _xcit.XCIT_MEDIUM_24_P8)):
    BACKBONE_CONFIGS[_name] = BackboneSpec("xcit", _cfg,
                                           f"{_name}_pretrain.pth")
for _name, _cfg, _file in (
        ("vit_swin_base", _swin.SWIN_BASE, "swin_base_patch4_window7_224"),
        ("vit_swin_large", _swin.SWIN_LARGE,
         "swin_large_patch4_window7_224"),
        ("swin_tiny", _swin.SWIN_TINY, "swin_tiny_patch4_window7_224"),
        ("swin_small", _swin.SWIN_SMALL, "swin_small_patch4_window7_224")):
    BACKBONE_CONFIGS[_name] = BackboneSpec("swin", _cfg, _file + ".pth")
for _name, _cfg, _file in (
        ("resnetv2_50_bit", _resnetv2.RESNETV2_50X3, "resnetv2_50x3_bitm"),
        ("resnetv2_50_21k", _resnetv2.RESNETV2_50X3,
         "resnetv2_50x3_bitm_in21k"),
        ("resnetv2_101_bit", _resnetv2.RESNETV2_101X3,
         "resnetv2_101x3_bitm"),
        ("resnetv2_101_21k", _resnetv2.RESNETV2_101X3,
         "resnetv2_101x3_bitm_in21k"),
        ("resnetv2_152_bit", _resnetv2.RESNETV2_152X4,
         "resnetv2_152x4_bitm"),
        ("resnetv2_152_21k", _resnetv2.RESNETV2_152X4,
         "resnetv2_152x4_bitm_in21k"),
        ("resnetv2_152_384", _resnetv2.RESNETV2_152X2,
         "resnetv2_152x2_bit_teacher_384"),
        ("resnetv2_101", _resnetv2.RESNETV2_101, "resnetv2_101")):
    BACKBONE_CONFIGS[_name] = BackboneSpec("resnetv2", _cfg, _file + ".pth")

# the shipped registry, before any runtime register_backbone (tests
# register tiny architectures): the frozen manifests cover exactly this set
BUILTIN_BACKBONES = frozenset(BACKBONE_CONFIGS)

# names the port has and tpu_ac has not; their inventories are frozen in
# manifest.PORT_MANIFEST_PATH.  DINOv2 ViT-g/14 with 4 registers
# (facebookresearch/dinov2 hub/backbones.py dinov2_vitg14_reg): the
# release's state-dict keys, its mask_token ignored on load
PORT_BACKBONES = {
    "dinov2_vitg14_reg": BackboneSpec(
        "vit", VIT_GIANT2_REG4, "dinov2_vitg14_reg4_pretrain.pth"),
}
BACKBONE_CONFIGS.update(PORT_BACKBONES)

# family -> (module class, numpy init); a family not here is not ported
FAMILY_MODELS = {
    "vit": (ViT, init_vit_params),
    "resnet": (_resnet.ResNet, _resnet.init_resnet_params),
    "vgg": (_vgg.VGG, _vgg.init_vgg_params),
    "alexnet": (_vgg.AlexNet, _vgg.init_alexnet_params),
    "densenet": (_densenet.DenseNet, _densenet.init_densenet_params),
    "inception_v4": (_inception.InceptionV4,
                     _inception.init_inception_v4_params),
    "bninception": (_inception.BNInception,
                    _inception.init_bninception_params),
    "resnest": (_resnest.ResNeSt, _resnest.init_resnest_params),
    "resnetv2": (_resnetv2.ResNetV2, _resnetv2.init_resnetv2_params),
    "efficientnet": (_effnet.EfficientNet, _effnet.init_efficientnet_params),
    "efficientnetv2": (_effnet.EfficientNetV2,
                       _effnet.init_efficientnetv2_params),
    "mnasnet": (_effnet.MnasNet, _effnet.init_mnasnet_params),
    "vit_hybrid": (_hybrid.HybridViT, _hybrid.init_hybrid_vit_params),
    "swin": (_swin.Swin, _swin.init_swin_params),
    "xcit": (_xcit.XCiT, _xcit.init_xcit_params),
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


def _family_model(family: str):
    if family not in FAMILY_MODELS:
        raise NotImplementedError(
            f"family {family!r} is not ported; ported: "
            f"{sorted(FAMILY_MODELS)}")
    return FAMILY_MODELS[family]


def build_on_meta(name: str) -> torch.nn.Module:
    """The registry name's module on the meta device: its structure and
    state_dict shapes, with no storage allocated and no init run."""
    if name not in BACKBONE_CONFIGS:
        raise KeyError(f"Unknown backbone '{name}'. "
                       f"Registered: {sorted(BACKBONE_CONFIGS)}")
    spec = BACKBONE_CONFIGS[name]
    module_cls, _ = _family_model(spec.family)
    with torch.device("meta"):
        return module_cls(spec.config)


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
    _, init = _family_model(spec.family)
    path = None
    if use_checkpoint:
        path = checkpoint_path or _find_checkpoint(spec.checkpoint,
                                                   checkpoint_dir)
    # built without initialising its tensors: every one is loaded below
    model = build_on_meta(name).to_empty(device="cpu")
    if hasattr(model, "reset_buffers"):  # buffers outside the state dict
        model.reset_buffers()
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
