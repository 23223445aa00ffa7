"""MVTec AD dataset, host side (port of ``tpu_ac.data.mvtec``).

The directory walk, the (classname, anomaly, filename) iteration order and
the PIL transform (shorter-edge bilinear resize -> centre crop) are the
reference's.  Images decode to uint8 CHW on the host and are normalized on
the device by ``normalize_on_device`` (4x fewer bytes to upload);
ground-truth masks decode to f32 on the host (``load_mask``).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import os

import numpy as np
import torch
from PIL import Image

CLASSNAMES = [
    "bottle", "cable", "capsule", "carpet", "grid",
    "hazelnut", "leather", "metal_nut", "pill", "screw",
    "tile", "toothbrush", "transistor", "wood", "zipper",
]

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


class DatasetSplit(enum.Enum):
    TRAIN = "train"
    VAL = "val"
    TEST = "test"


def _resize_shorter_edge(img: Image.Image, size: int) -> Image.Image:
    """torchvision transforms.Resize(int) semantics: shorter edge -> size."""
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, round(h * size / w))
    else:
        new_w, new_h = max(1, round(w * size / h)), size
    return img.resize((new_w, new_h), Image.BILINEAR)


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    """transforms.CenterCrop on an HWC array (torch rounding of offsets)."""
    h, w = arr.shape[:2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return arr[top:top + size, left:left + size]


def load_image_uint8(path: str, resize: int = 256,
                     imagesize: int = 224) -> np.ndarray:
    """Decode to raw uint8 [3, imagesize, imagesize]."""
    img = Image.open(path).convert("RGB")
    img = _resize_shorter_edge(img, resize)
    arr = _center_crop(np.asarray(img, dtype=np.uint8), imagesize)
    return arr.transpose(2, 0, 1)


def load_mask(path: str | None, resize: int = 256,
              imagesize: int = 224) -> np.ndarray:
    """Decode a ground-truth mask to [1, imagesize, imagesize] float32 in
    [0, 1] (zeros for a normal image, whose ``path`` is None)."""
    if path is None:
        return np.zeros((1, imagesize, imagesize), dtype=np.float32)
    img = _resize_shorter_edge(Image.open(path), resize)
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return _center_crop(arr / 255.0, imagesize)[None]


@functools.lru_cache(maxsize=8)
def _channel_stats(mean: tuple[float, ...], std: tuple[float, ...],
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """[3, 1, 1] f32 mean and std on ``device``, copied there once: a
    pageable host-to-device copy on every batch would make the host wait
    for the device's queue to drain."""
    t = torch.tensor([mean, std], dtype=torch.float32)[:, :, None, None]
    t = t.to(device)
    return t[0], t[1]


def normalize_on_device(batch_u8: torch.Tensor, mean=IMAGENET_MEAN,
                        std=IMAGENET_STD) -> torch.Tensor:
    """(x/255 - mean)/std in f32 for a uint8 [B, 3, H, W] batch, on the
    batch's device."""
    m, s = _channel_stats(tuple(float(v) for v in mean),
                          tuple(float(v) for v in std), batch_u8.device)
    return (batch_u8.to(torch.float32) / 255.0 - m) / s


@dataclasses.dataclass
class Item:
    classname: str
    anomaly: str
    image_path: str
    mask_path: str | None

    @property
    def is_anomaly(self) -> int:
        return int(self.anomaly != "good")

    @property
    def image_name(self) -> str:
        return "/".join(self.image_path.split("/")[-4:])


class MVTecDataset:
    """Walks ``<source>/<class>/<split>/<anomaly>/*.png``.

    ``train_val_split`` < 1 keeps the first ``int(n * train_val_split)``
    files of each anomaly folder for TRAIN and the rest for VAL; as in
    the reference, each split walks its own folder (``val/`` for VAL)."""

    def __init__(self, source: str, classname: str | None = None,
                 resize: int = 256, imagesize: int = 224,
                 split: DatasetSplit = DatasetSplit.TRAIN,
                 train_val_split: float = 1.0):
        self.source = source
        self.split = split
        self.resize = resize
        self.imagesize = imagesize
        self.classnames_to_use = ([classname] if classname is not None
                                  else CLASSNAMES)
        self.train_val_split = train_val_split
        self.items = self._walk()

    def _walk(self) -> list[Item]:
        items: list[Item] = []
        for classname in sorted(self.classnames_to_use):
            classpath = os.path.join(self.source, classname, self.split.value)
            maskroot = os.path.join(self.source, classname, "ground_truth")
            for anomaly in sorted(os.listdir(classpath)):
                apath = os.path.join(classpath, anomaly)
                paths = [os.path.join(apath, f)
                         for f in sorted(os.listdir(apath))]
                if self.train_val_split < 1.0:
                    cut = int(len(paths) * self.train_val_split)
                    if self.split == DatasetSplit.TRAIN:
                        paths = paths[:cut]
                    elif self.split == DatasetSplit.VAL:
                        paths = paths[cut:]
                masks = None
                if self.split == DatasetSplit.TEST and anomaly != "good":
                    mpath = os.path.join(maskroot, anomaly)
                    masks = [os.path.join(mpath, f)
                             for f in sorted(os.listdir(mpath))]
                for i, ipath in enumerate(paths):
                    items.append(Item(classname, anomaly, ipath,
                                      masks[i] if masks else None))
        return items

    def __len__(self) -> int:
        return len(self.items)

    def load_all_images(self, num_workers: int | None = None) -> np.ndarray:
        """Decode the whole split to one uint8 [N, 3, H, W] array on
        threads (PIL releases the GIL while decoding)."""
        from concurrent.futures import ThreadPoolExecutor

        if num_workers is None:
            num_workers = min(16, os.cpu_count() or 1)

        def load(it):
            return load_image_uint8(it.image_path, self.resize,
                                    self.imagesize)

        if num_workers <= 1 or len(self.items) < 4:
            return np.stack([load(it) for it in self.items])
        with ThreadPoolExecutor(num_workers) as pool:
            return np.stack(list(pool.map(load, self.items)))


def make_synthetic_mvtec(root: str, classname: str = "bottle",
                         anomalies: tuple[str, ...] = ("good", "broken_large",
                                                       "contamination"),
                         n_per_anomaly: int = 4, n_train: int = 6,
                         image_size: int = 64, seed: int = 0) -> str:
    """Write a tiny MVTec-layout tree of synthetic PNGs, byte-identical to
    ``tpu_ac.data.make_synthetic_mvtec`` for the same arguments.

    Each anomaly type gets a visually distinct defect so clustering is
    learnable; ground-truth masks are written for test anomalies.
    """
    rng = np.random.default_rng(seed)
    s = image_size

    def base_texture():
        return (rng.uniform(90, 140, size=(s, s, 3))).astype(np.uint8)

    def save(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path)

    for i in range(n_train):
        save(os.path.join(root, classname, "train", "good", f"{i:03d}.png"),
             base_texture())
    for anomaly in anomalies:
        for i in range(n_per_anomaly):
            img = base_texture()
            mask = np.zeros((s, s), dtype=np.uint8)
            if anomaly != "good":
                # deterministic defect geometry per anomaly type (builtin
                # hash() is randomized per process — use a stable digest)
                if sum(anomaly.encode()) % 2 == 0:
                    lo, hi = s // 4, s // 2
                    img[lo:hi, lo:hi] = [220, 40, 40]
                    mask[lo:hi, lo:hi] = 255
                else:
                    c = s // 2 + (i % 3) - 1
                    img[:, c - 2:c + 2] = [40, 40, 220]
                    mask[:, c - 2:c + 2] = 255
                save(os.path.join(root, classname, "ground_truth", anomaly,
                                  f"{i:03d}_mask.png"), mask)
            save(os.path.join(root, classname, "test", anomaly,
                              f"{i:03d}.png"), img)
    return root
