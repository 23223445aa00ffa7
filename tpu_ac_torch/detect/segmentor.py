"""Patch-score -> pixel-mask segmentation (port of
``tpu_ac.detect.segmentor``; reference common.py:186-208).

Bilinear upsample of the patch-score grid to the image size
(``ops.interpolate``), then the sigma = 4 Gaussian blur of
``scipy.ndimage.gaussian_filter`` (``ops.gaussian``), both on the device;
only the masks come back.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ac_torch.device import resolve_device
from tpu_ac_torch.ops.gaussian import gaussian_blur
from tpu_ac_torch.ops.interpolate import interpolate_bilinear


class RescaleSegmentor:
    def __init__(self, target_size=(224, 224), smoothing: float = 4.0,
                 device="cuda"):
        """``device``: where numpy patch scores are uploaded; a tensor is
        segmented on its own device."""
        if isinstance(target_size, int):
            target_size = (target_size, target_size)
        self.target_size = tuple(target_size)
        self.smoothing = smoothing
        self.device = device

    def segment(self, patch_scores: torch.Tensor) -> torch.Tensor:
        """[B, gh, gw] patch scores -> [B, H, W] smoothed masks, on the
        scores' device."""
        x = interpolate_bilinear(patch_scores[:, None].float(),
                                 size=self.target_size)[:, 0]
        return gaussian_blur(x, sigma=self.smoothing)

    def convert_to_segmentation(self, patch_scores) -> np.ndarray:
        """[B, gh, gw] patch scores (numpy or tensor) -> [B, H, W] numpy."""
        if not isinstance(patch_scores, torch.Tensor):
            patch_scores = torch.from_numpy(np.asarray(patch_scores)).to(
                resolve_device(self.device))
        with torch.inference_mode():
            return self.segment(patch_scores).cpu().numpy()
