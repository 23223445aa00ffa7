"""Model-hub style factories for DINO's ViTs, ResNet-50 and XCiTs and for
torchvision's WRN50-2 (port of ``tpu_ac.hub``, dino-main/hubconf.py:22-151).

Each factory returns (module, config, family) with the released weights
when a converted checkpoint is in the checkpoint cache (nothing is
downloaded; see ``tpu_ac_torch.models.registry`` for the search path),
else the seeded random init.
"""

from __future__ import annotations

from tpu_ac_torch.models.registry import load_backbone


def dino_vits16(**kw):
    """ViT-S/16 DINO backbone (hubconf.py:22-33)."""
    return load_backbone("dino_deitsmall16", **kw)


def dino_vits8(**kw):
    """ViT-S/8 DINO backbone (hubconf.py:36-47)."""
    return load_backbone("dino_deitsmall8", **kw)


def dino_vitb16(**kw):
    """ViT-B/16 DINO backbone (hubconf.py:50-61)."""
    return load_backbone("dino_vitbase16", **kw)


def dino_vitb8(**kw):
    """ViT-B/8 DINO backbone, the anomaly-clustering flagship
    (hubconf.py:64-75)."""
    return load_backbone("dino_vitbase8", **kw)


def dino_resnet50(**kw):
    """ResNet-50 DINO backbone (hubconf.py:78-92)."""
    return load_backbone("dino_resnet50", **kw)


def dino_xcit_small_12_p16(**kw):
    """XCiT-S12/16 DINO backbone (hubconf.py:98-109)."""
    return load_backbone("dino_xcit_small_12_p16", **kw)


def dino_xcit_small_12_p8(**kw):
    """XCiT-S12/8 DINO backbone (hubconf.py:112-123)."""
    return load_backbone("dino_xcit_small_12_p8", **kw)


def dino_xcit_medium_24_p16(**kw):
    """XCiT-M24/16 DINO backbone (hubconf.py:126-137)."""
    return load_backbone("dino_xcit_medium_24_p16", **kw)


def dino_xcit_medium_24_p8(**kw):
    """XCiT-M24/8 DINO backbone (hubconf.py:140-151)."""
    return load_backbone("dino_xcit_medium_24_p8", **kw)


def wide_resnet50_2(**kw):
    """torchvision WRN50-2 (PatchCore default backbone)."""
    return load_backbone("wideresnet50", **kw)
