"""Host-side image augmentation: the DINO multi-crop (port of the DINO
half of ``tpu_ac.data.augment``, a copy of its PIL code).

DataAugmentationDINO (dino-main/main_dino.py:419-464) with PIL + numpy
only.  Given the same ``random.Random`` stream, every op draws the same
numbers and calls the same PIL functions as ``tpu_ac``'s, so the crops are
bit-identical.  The SCAN transforms (RandAugment, Cutout, the SimCLR,
strong, weak and val transforms) come with the SCAN port (ROADMAP Queue 1
item 12).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

from tpu_ac_torch.data.mvtec import IMAGENET_MEAN, IMAGENET_STD

Transform = Callable[[Image.Image], Image.Image]


# --------------------------------------------------------------------------
# Elementary ops
# --------------------------------------------------------------------------

def random_resized_crop(img: Image.Image, size: int,
                        scale: tuple[float, float],
                        ratio: tuple[float, float] = (3 / 4, 4 / 3),
                        rng: random.Random = random,
                        interpolation=Image.BICUBIC) -> Image.Image:
    """torchvision RandomResizedCrop semantics (10 tries, center fallback)."""
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = float(np.exp(rng.uniform(*log_ratio)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            crop = img.crop((left, top, left + cw, top + ch))
            return crop.resize((size, size), interpolation)
    # fallback: center crop of the constrained aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return img.crop((left, top, left + cw, top + ch)).resize(
        (size, size), interpolation)


def color_jitter(img: Image.Image, brightness: float, contrast: float,
                 saturation: float, hue: float,
                 rng: random.Random = random) -> Image.Image:
    """torchvision ColorJitter: random order of the four adjustments."""
    ops = []
    if brightness:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast:
        f2 = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
    if saturation:
        f3 = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
    if hue:
        shift = rng.uniform(-hue, hue)

        def hue_op(im, shift=shift):
            hsv = np.asarray(im.convert("HSV"), dtype=np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(shift * 255)) % 256
            return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")

        ops.append(hue_op)
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


def gaussian_blur_pil(img: Image.Image, radius_min=0.1, radius_max=2.0,
                      rng: random.Random = random) -> Image.Image:
    """utils.GaussianBlur (dino-main/utils.py:48-63)."""
    return img.filter(ImageFilter.GaussianBlur(
        radius=rng.uniform(radius_min, radius_max)))


def solarize(img: Image.Image) -> Image.Image:
    """utils.Solarization (dino-main/utils.py:66-77)."""
    return ImageOps.solarize(img)


def to_normalized_array(img: Image.Image,
                        mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = (arr - mean) / std
    return arr.transpose(2, 0, 1)


def to_uint8_array(img: Image.Image) -> np.ndarray:
    """Raw uint8 CHW: the device-side-normalization path (4x less
    host-to-device transfer; ``data.mvtec.normalize_on_device`` inside the
    train step computes the same f32 (x/255-mean)/std)."""
    return np.asarray(img, dtype=np.uint8).transpose(2, 0, 1)


# --------------------------------------------------------------------------
# DINO multi-crop (main_dino.py:419-464)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DINOAugmentation:
    global_crops_scale: tuple[float, float] = (0.4, 1.0)
    local_crops_scale: tuple[float, float] = (0.05, 0.4)
    local_crops_number: int = 8
    global_size: int = 224
    local_size: int = 96
    seed: int | None = None
    normalize: bool = True

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self._to_array = to_normalized_array if self.normalize \
            else to_uint8_array

    def _flip_and_jitter(self, img: Image.Image,
                         rng: random.Random) -> Image.Image:
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if rng.random() < 0.8:
            img = color_jitter(img, 0.4, 0.4, 0.2, 0.1, rng)
        if rng.random() < 0.2:
            img = img.convert("L").convert("RGB")
        return img

    def __call__(self, img: Image.Image,
                 rng: random.Random | None = None) -> list[np.ndarray]:
        """-> [2 global crops, N local crops] CHW arrays (normalized f32,
        or raw uint8 with ``normalize=False`` — the device-side
        normalization path; the rng draw sequence is identical, so the
        two modes produce the same crops).

        ``rng``: optional private stream for this call — the parallel
        loader (data/prefetch.py) keys one per (seed, epoch, position) so
        augmentation is deterministic regardless of worker scheduling
        (the instance stream is NOT thread-safe).
        """
        rng = self._rng if rng is None else rng
        crops = []
        # global 1: always blurred
        g1 = random_resized_crop(img, self.global_size,
                                 self.global_crops_scale, rng=rng)
        g1 = self._flip_and_jitter(g1, rng)
        g1 = gaussian_blur_pil(g1, rng=rng)
        crops.append(self._to_array(g1))
        # global 2: blur p=0.1, solarize p=0.2
        g2 = random_resized_crop(img, self.global_size,
                                 self.global_crops_scale, rng=rng)
        g2 = self._flip_and_jitter(g2, rng)
        if rng.random() < 0.1:
            g2 = gaussian_blur_pil(g2, rng=rng)
        if rng.random() < 0.2:
            g2 = solarize(g2)
        crops.append(self._to_array(g2))
        # locals: blur p=0.5
        for _ in range(self.local_crops_number):
            lc = random_resized_crop(img, self.local_size,
                                     self.local_crops_scale, rng=rng)
            lc = self._flip_and_jitter(lc, rng)
            if rng.random() < 0.5:
                lc = gaussian_blur_pil(lc, rng=rng)
            crops.append(self._to_array(lc))
        return crops
