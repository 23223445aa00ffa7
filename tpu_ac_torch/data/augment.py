"""Host-side image augmentation: the DINO multi-crop and the SCAN
transforms (port of ``tpu_ac.data.augment``, a copy of its PIL code).

DataAugmentationDINO (dino-main/main_dino.py:419-464) and the SCAN stack
(Unsupervised-Classification-master/data/augment.py RandAugment-style
ops + Cutout, utils/common_config.py transform factories) with PIL +
numpy only.  Given the same ``random.Random`` stream, every op draws the
same numbers and calls the same PIL functions as ``tpu_ac``'s, so the
arrays are bit-identical.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Sequence

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


def cutout(arr: np.ndarray, n_holes: int, length: int,
           rng: random.Random = random, random_hole: bool = True
           ) -> np.ndarray:
    """Cutout on a CHW float array (data/augment.py:121-160)."""
    _, h, w = arr.shape
    mask = np.ones((h, w), np.float32)
    for _ in range(n_holes):
        y, x = rng.randrange(h), rng.randrange(w)
        ln = rng.randint(length // 2, length) if random_hole else length
        y1, y2 = np.clip(y - ln // 2, 0, h), np.clip(y + ln // 2, 0, h)
        x1, x2 = np.clip(x - ln // 2, 0, w), np.clip(x + ln // 2, 0, w)
        mask[y1:y2, x1:x2] = 0.0
    return arr * mask[None]


# RandAugment op table (data/augment.py:11-117 equivalents)
def _randaugment_ops(rng: random.Random) -> list[Callable]:
    def lvl(low, high):
        return rng.uniform(low, high)

    return [
        lambda im: ImageOps.autocontrast(im),
        lambda im: ImageOps.equalize(im),
        lambda im: im.rotate(lvl(-30, 30)),
        lambda im: ImageOps.posterize(im, int(lvl(4, 8))),
        lambda im: ImageOps.solarize(im, int(lvl(5, 256))),
        lambda im: ImageEnhance.Color(im).enhance(lvl(0.1, 1.9)),
        lambda im: ImageEnhance.Contrast(im).enhance(lvl(0.1, 1.9)),
        lambda im: ImageEnhance.Brightness(im).enhance(lvl(0.1, 1.9)),
        lambda im: ImageEnhance.Sharpness(im).enhance(lvl(0.1, 1.9)),
        lambda im: im.transform(im.size, Image.AFFINE,
                                (1, lvl(-0.3, 0.3), 0, 0, 1, 0)),
        lambda im: im.transform(im.size, Image.AFFINE,
                                (1, 0, 0, lvl(-0.3, 0.3), 0, 1)),
        lambda im: im.transform(im.size, Image.AFFINE,
                                (1, 0, lvl(-10, 10), 0, 1, 0)),
        lambda im: im.transform(im.size, Image.AFFINE,
                                (1, 0, 0, 0, 1, lvl(-10, 10))),
    ]


def randaugment(img: Image.Image, n: int = 4,
                rng: random.Random = random) -> Image.Image:
    """Apply n randomly-chosen ops (SCAN's strong augmentation,
    data/augment.py Augment(n=4) in configs/selflabel*.yml).

    Drawn WITH replacement (``random.choices``, Augment.__call__ at
    data/augment.py:107) — the same op can apply repeatedly, which widens
    the strong-augmentation distribution vs sampling without replacement.
    """
    ops = _randaugment_ops(rng)
    for i in rng.choices(range(len(ops)), k=n):
        img = ops[i](img)
    return img


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


# --------------------------------------------------------------------------
# SCAN transforms (utils/common_config.py:150-210 factories)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SimCLRAugmentation:
    """Pretext transform: RRC + jitter + grayscale (common_config.py:158-171)."""
    size: int = 32
    scale: tuple[float, float] = (0.2, 1.0)
    jitter_strength: float = 0.4
    seed: int | None = None

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def __call__(self, img: Image.Image,
                 rng: random.Random | None = None) -> np.ndarray:
        rng = self._rng if rng is None else rng
        img = random_resized_crop(img, self.size, self.scale, rng=rng,
                                  interpolation=Image.BILINEAR)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if rng.random() < 0.8:
            s = self.jitter_strength
            img = color_jitter(img, s, s, s, s / 4, rng)
        if rng.random() < 0.2:
            img = img.convert("L").convert("RGB")
        return to_normalized_array(img)


@dataclasses.dataclass
class StrongAugmentation:
    """Self-labeling strong transform: crop + flip + RandAugment(n) + Cutout
    (common_config.py:173-191, configs/selflabel_*.yml)."""
    size: int = 32
    num_ops: int = 4
    cutout_holes: int = 1
    cutout_length: int = 16
    seed: int | None = None

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def __call__(self, img: Image.Image,
                 rng: random.Random | None = None) -> np.ndarray:
        rng = self._rng if rng is None else rng
        img = random_resized_crop(img, self.size, (0.5, 1.0), rng=rng,
                                  interpolation=Image.BILINEAR)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        img = randaugment(img, self.num_ops, rng)
        arr = to_normalized_array(img)
        return cutout(arr, self.cutout_holes, self.cutout_length, rng)


@dataclasses.dataclass
class WeakAugmentation:
    """Standard/weak transform: crop + flip (common_config.py:150-156)."""
    size: int = 32
    seed: int | None = None

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def __call__(self, img: Image.Image,
                 rng: random.Random | None = None) -> np.ndarray:
        rng = self._rng if rng is None else rng
        w, h = img.size
        pad = self.size // 8
        img = ImageOps.expand(img, border=pad, fill=0)
        left = rng.randint(0, 2 * pad)
        top = rng.randint(0, 2 * pad)
        img = img.crop((left, top, left + self.size, top + self.size))
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return to_normalized_array(img)


@dataclasses.dataclass
class ValTransform:
    """Deterministic eval transform: CenterCrop(size) + normalize
    (get_val_transformations, common_config.py:247-251).  The reference
    fills memory banks and computes predictions through its val/base
    dataloaders with THIS transform — not the random weak train transform —
    so neighbor mining and every hungarian/contrastive eval must use it.
    Torchvision CenterCrop semantics: round-half-even coords, zero-pad when
    the image is smaller than the crop."""
    size: int = 32

    def __call__(self, img: Image.Image) -> np.ndarray:
        w, h = img.size
        if w < self.size or h < self.size:
            pw, ph = max(self.size - w, 0), max(self.size - h, 0)
            img = ImageOps.expand(
                img, border=(pw // 2, ph // 2, pw - pw // 2, ph - ph // 2),
                fill=0)
            w, h = img.size
        left = int(round((w - self.size) / 2.0))
        top = int(round((h - self.size) / 2.0))
        img = img.crop((left, top, left + self.size, top + self.size))
        return to_normalized_array(img)


def augment_batch(images: Sequence[Image.Image], transform) -> np.ndarray:
    return np.stack([transform(img) for img in images])
