"""Classification datasets for the SCAN workload: CIFAR-10/20, STL-10,
ImageNet subsets (port of ``tpu_ac.data.classification``, a copy of its
numpy and PIL code).

Rebuilds Unsupervised-Classification-master/data/{cifar.py,stl.py,
imagenet.py,custom_dataset.py}: the loaders read the standard on-disk
formats (CIFAR python pickles, STL-10 binary, an ImageFolder tree with a
subset list); nothing downloads.  The wrapper datasets reproduce the
AugmentedDataset / NeighborsDataset semantics that drive the three SCAN
training stages.  Everything here is host-side numpy: the arrays are the
same bytes as ``tpu_ac``'s.
"""

from __future__ import annotations

import os
import pickle
import warnings

import numpy as np
from PIL import Image


def shuffled_batches(n: int, batch_size: int, seed: int,
                     multiple_of: int = 1):
    """Shuffled drop-last batch indices for one epoch; datasets smaller
    than one batch yield the whole (shuffled) set as a single batch
    instead of zero steps.

    ``multiple_of`` (a data-parallel mesh size): every yielded batch is
    trimmed to a multiple so a dp-sharded leading axis always divides, as
    ``tpu_ac``'s sharded step requires (torch DataParallel splits ragged
    batches silently); the port trims the same way, so both packages
    train on the same batches.  Trimming that changes the effective batch
    size is warned about (the reference's DataParallel would have trained
    the full ragged batch).
    """
    if n <= 0:
        raise ValueError("dataset has no images")
    order = np.random.default_rng(seed).permutation(n)
    if n < batch_size:
        m = n // multiple_of * multiple_of
        if m == 0:
            raise ValueError(
                f"dataset of {n} images cannot fill one {multiple_of}-way "
                f"data-parallel batch (train_dp/--dp {multiple_of})")
        if m != n:
            warnings.warn(
                f"whole-set fallback batch trimmed {n} -> {m} images to "
                f"divide the {multiple_of}-way data-parallel axis")
        yield order[:m]
        return
    bs = batch_size // multiple_of * multiple_of
    if bs == 0:
        raise ValueError(
            f"batch_size {batch_size} is smaller than the data-parallel "
            f"width (train_dp/--dp {multiple_of})")
    if bs != batch_size:
        warnings.warn(
            f"batch_size trimmed {batch_size} -> {bs} to divide the "
            f"{multiple_of}-way data-parallel axis")
    end = n // bs * bs
    for i in range(0, end, bs):
        yield order[i:i + bs]


def num_shuffled_batches(n: int, batch_size: int,
                         multiple_of: int = 1) -> int:
    """Batch count :func:`shuffled_batches` yields (for schedule sizing)."""
    if n < batch_size:
        return 1
    bs = max(batch_size // multiple_of * multiple_of, 1)
    return max(1, n // bs)

# CIFAR-100 coarse mapping: fine label -> 20 superclasses
# (data/cifar.py:120-183 _cifar100_to_cifar20)
_C100_TO_C20 = {
    0: 4, 1: 1, 2: 14, 3: 8, 4: 0, 5: 6, 6: 7, 7: 7, 8: 18, 9: 3,
    10: 3, 11: 14, 12: 9, 13: 18, 14: 7, 15: 11, 16: 3, 17: 9, 18: 7,
    19: 11, 20: 6, 21: 11, 22: 5, 23: 10, 24: 7, 25: 6, 26: 13, 27: 15,
    28: 3, 29: 15, 30: 0, 31: 11, 32: 1, 33: 10, 34: 12, 35: 14, 36: 16,
    37: 9, 38: 11, 39: 5, 40: 5, 41: 19, 42: 8, 43: 8, 44: 15, 45: 13,
    46: 14, 47: 17, 48: 18, 49: 10, 50: 16, 51: 4, 52: 17, 53: 4, 54: 2,
    55: 0, 56: 17, 57: 4, 58: 18, 59: 17, 60: 10, 61: 3, 62: 2, 63: 12,
    64: 12, 65: 16, 66: 12, 67: 1, 68: 9, 69: 19, 70: 2, 71: 10, 72: 0,
    73: 1, 74: 16, 75: 12, 76: 9, 77: 13, 78: 15, 79: 13, 80: 16, 81: 19,
    82: 2, 83: 4, 84: 6, 85: 19, 86: 5, 87: 5, 88: 8, 89: 19, 90: 18,
    91: 1, 92: 2, 93: 15, 94: 6, 95: 0, 96: 17, 97: 8, 98: 14, 99: 13,
}


class ArrayDataset:
    """In-memory image classification dataset: uint8 HWC images + labels."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 classes: list[str] | None = None):
        assert images.dtype == np.uint8 and images.ndim == 4
        self.images = images
        self.labels = np.asarray(labels, np.int64)
        self.classes = classes or [str(c) for c in
                                   sorted(set(self.labels.tolist()))]

    def __len__(self) -> int:
        return len(self.images)

    def get_pil(self, idx: int) -> Image.Image:
        return Image.fromarray(self.images[idx])

    def __getitem__(self, idx: int) -> dict:
        return {"image": self.get_pil(idx), "target": int(self.labels[idx]),
                "meta": {"index": idx}}


def load_cifar10(root: str, split: str = "train") -> ArrayDataset:
    """CIFAR-10 from the standard python-pickle batches
    (cifar-10-batches-py/)."""
    base = os.path.join(root, "cifar-10-batches-py")
    files = ([f"data_batch_{i}" for i in range(1, 6)] if split == "train"
             else ["test_batch"])
    imgs, labels = [], []
    for fname in files:
        with open(os.path.join(base, fname), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.extend(d[b"labels"])
    return ArrayDataset(np.concatenate(imgs), np.asarray(labels))


def load_cifar20(root: str, split: str = "train") -> ArrayDataset:
    """CIFAR-100 remapped to 20 superclasses (data/cifar.py:120-183)."""
    base = os.path.join(root, "cifar-100-python")
    with open(os.path.join(base, split if split != "val" else "test"),
              "rb") as f:
        d = pickle.load(f, encoding="bytes")
    imgs = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    fine = np.asarray(d[b"fine_labels"])
    coarse = np.asarray([_C100_TO_C20[int(c)] for c in fine])
    return ArrayDataset(imgs, coarse)


def load_stl10(root: str, split: str = "train") -> ArrayDataset:
    """STL-10 binary format (stl10_binary/)."""
    base = os.path.join(root, "stl10_binary")
    with open(os.path.join(base, f"{split}_X.bin"), "rb") as f:
        imgs = np.frombuffer(f.read(), np.uint8).reshape(-1, 3, 96, 96)
        imgs = imgs.transpose(0, 3, 2, 1)  # STL stores column-major
    with open(os.path.join(base, f"{split}_y.bin"), "rb") as f:
        labels = np.frombuffer(f.read(), np.uint8).astype(np.int64) - 1
    return ArrayDataset(np.ascontiguousarray(imgs), labels)


def load_imagenet(root: str, split: str = "train",
                  subset_file: str | None = None,
                  size: int = 224,
                  mmap_cache: str | None = None) -> ArrayDataset:
    """ImageNet / ImageNetSubset as an ArrayDataset.

    Mirrors data/imagenet.py:1-102: walks <root>/<split>/<wnid>/ for the
    wnids in ``subset_file`` (one per line, "wnid name"), or every class
    directory when no subset is given.  Images are resize(shorter side
    -> size*8/7) + center-crop(size), the reference's val transform; the
    SCAN augmentations re-crop from the stored PIL image.

    ``mmap_cache``: directory for a decoded .npy cache that is memory-
    MAPPED instead of held in RAM — required at ImageNet-100/200 scale,
    where the decoded train split is tens of GB (the array pages in on
    demand and is reused across runs).  Without it the decode is fully
    in-memory (fine for the _50 subsets and tests).
    """
    split_dir = os.path.join(root, split)
    if subset_file:
        with open(subset_file) as f:
            wnids = [ln.strip().split(" ", 1)[0] for ln in f if ln.strip()]
    else:
        wnids = sorted(d for d in os.listdir(split_dir)
                       if os.path.isdir(os.path.join(split_dir, d)))
    resize = int(size * 8 / 7)  # 256 for 224

    paths, labels = [], []
    for ci, wnid in enumerate(wnids):
        cdir = os.path.join(split_dir, wnid)
        if not os.path.isdir(cdir):
            continue
        for fname in sorted(os.listdir(cdir)):
            paths.append(os.path.join(cdir, fname))
            labels.append(ci)
    labels = np.asarray(labels)

    def decode(path: str) -> np.ndarray:
        with Image.open(path) as im:
            im = im.convert("RGB")
            w, h = im.size
            s = resize / min(w, h)
            im = im.resize((round(w * s), round(h * s)), Image.BILINEAR)
            left = (im.width - size) // 2
            top = (im.height - size) // 2
            im = im.crop((left, top, left + size, top + size))
            return np.asarray(im, np.uint8)

    if mmap_cache:
        # key on a digest of the exact ordered file list (not just the
        # count): two different subsets/roots with coincidentally equal
        # image counts must not silently reuse each other's decoded cache
        import hashlib

        digest = hashlib.sha1("\n".join(paths).encode()).hexdigest()[:12]
        tag = f"{split}_{len(paths)}_{size}_{digest}"
        os.makedirs(mmap_cache, exist_ok=True)
        cache_path = os.path.join(mmap_cache, f"imagenet_{tag}.npy")
        if not os.path.exists(cache_path):
            arr = np.lib.format.open_memmap(
                cache_path + ".tmp", mode="w+", dtype=np.uint8,
                shape=(len(paths), size, size, 3))
            for i, p in enumerate(paths):
                arr[i] = decode(p)
            arr.flush()
            del arr
            os.replace(cache_path + ".tmp", cache_path)
        imgs = np.load(cache_path, mmap_mode="r")
    else:
        imgs = np.stack([decode(p) for p in paths])
    return ArrayDataset(imgs, labels, classes=wnids)


def make_synthetic_classification(n_per_class: int = 20, n_classes: int = 4,
                                  size: int = 32, seed: int = 0
                                  ) -> ArrayDataset:
    """Synthetic clusterable dataset for tests/demos (distinct hue and
    texture per class)."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for c in range(n_classes):
        base = np.zeros((size, size, 3), np.float32)
        base[..., c % 3] = 150 + 25 * (c // 3)
        for _ in range(n_per_class):
            noise = rng.uniform(0, 60, (size, size, 3))
            imgs.append(np.clip(base + noise, 0, 255).astype(np.uint8))
            labels.append(c)
    return ArrayDataset(np.stack(imgs), np.asarray(labels))


class AugmentedDataset:
    """(image) -> {image, image_augmented} pairs for SimCLR
    (data/custom_dataset.py:13-42)."""

    def __init__(self, dataset: ArrayDataset, standard_transform,
                 augmentation_transform):
        self.dataset = dataset
        self.standard = standard_transform
        self.augment = augmentation_transform

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict:
        img = self.dataset.get_pil(idx)
        return {
            "image": self.standard(img),
            "image_augmented": self.augment(img),
            "target": int(self.dataset.labels[idx]),
        }

    def batch(self, indices) -> dict:
        items = [self[int(i)] for i in indices]
        return {
            "image": np.stack([it["image"] for it in items]),
            "image_augmented": np.stack([it["image_augmented"]
                                         for it in items]),
            "target": np.asarray([it["target"] for it in items]),
        }


class NeighborsDataset:
    """(anchor, random mined neighbor) pairs for SCAN training
    (data/custom_dataset.py:45-82)."""

    def __init__(self, dataset: ArrayDataset, transform,
                 neighbor_indices: np.ndarray, num_neighbors: int | None = None,
                 seed: int = 0):
        self.dataset = dataset
        self.transform = transform
        if num_neighbors is not None:
            neighbor_indices = neighbor_indices[:, :num_neighbors + 1]
        self.indices = neighbor_indices
        self._rng = np.random.default_rng(seed)
        assert self.indices.shape[0] == len(dataset)

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> dict:
        nbr = int(self._rng.choice(self.indices[idx]))
        return {
            "anchor": self.transform(self.dataset.get_pil(idx)),
            "neighbor": self.transform(self.dataset.get_pil(nbr)),
            "possible_neighbors": self.indices[idx],
            "target": int(self.dataset.labels[idx]),
        }

    def batch(self, indices) -> dict:
        items = [self[int(i)] for i in indices]
        return {
            "anchor": np.stack([it["anchor"] for it in items]),
            "neighbor": np.stack([it["neighbor"] for it in items]),
            "target": np.asarray([it["target"] for it in items]),
        }


# ImageNet subsets (data/imagenet.py ImageNetSubset: a class-name list file
# selects a subset of an ImageFolder tree)
def load_imagenet_subset(root: str, subset_file: str, split: str = "train",
                         size: int = 224):
    """Returns (paths, labels, classes): the reference's ImageNetSubset
    walks <root>/<split>/<wnid>/ for the wnids listed in subset_file."""
    with open(subset_file) as f:
        wnids = [line.strip().split(" ", 1)[0] for line in f if line.strip()]
    paths: list[str] = []
    labels: list[int] = []
    for ci, wnid in enumerate(wnids):
        cdir = os.path.join(root, split, wnid)
        if not os.path.isdir(cdir):
            continue
        for fname in sorted(os.listdir(cdir)):
            paths.append(os.path.join(cdir, fname))
            labels.append(ci)
    return paths, np.asarray(labels, np.int64), wnids
