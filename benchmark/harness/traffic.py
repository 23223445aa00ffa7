"""The general generator of a traffic mix: an MVTec-layout tree of seeded
PNGs (``traffic/<mix>.json`` gives the sizes, their order and the mode).

The layout is the one ``tpu_ac_torch.data.mvtec.MVTecDataset`` walks
(after ``tpu_ac_torch.data.mvtec.make_synthetic_mvtec``, whose writer this
follows, frozen here and written on threads):
``<root>/<category>/test/<anomaly>/<k>.png``, a mask per defect image
under ``ground_truth/<anomaly>/<k>_mask.png``, and for the supervised mode
``train/good/<k>.png``.  Every seed gives every
category the same image count, split over the same anomaly folders; the
seed draws the pixels: a smooth texture (8 x 8 noise, bicubic to the
source size) tinted per category, fine noise of +-4, and for a defect
image a rectangle of the anomaly's colour at a seeded place.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

# a seed is any whole number; the generators take it modulo 2**64
SEED_MOD = 2 ** 64
_DEFECT_COLOURS = ((220, 40, 40), (40, 40, 220), (40, 200, 60),
                   (230, 200, 40), (200, 60, 200), (40, 200, 220),
                   (250, 250, 250), (10, 10, 10))


@dataclasses.dataclass(frozen=True)
class Mix:
    """A traffic mix as its file states it."""

    name: str
    categories: tuple[tuple[str, int], ...]
    mode: str  # "unsupervised" | "supervised"
    train_ratio: float
    source_image_size: int
    resize: int
    imagesize: int
    anomaly_types: int
    train_seed: int
    check_categories: int

    @classmethod
    def from_dict(cls, d: dict) -> "Mix":
        return cls(name=d["name"],
                   categories=tuple((c, int(n)) for c, n in d["categories"]),
                   mode=d["mode"], train_ratio=float(d["train_ratio"]),
                   source_image_size=int(d["source_image_size"]),
                   resize=int(d["resize"]), imagesize=int(d["imagesize"]),
                   anomaly_types=int(d["anomaly_types"]),
                   train_seed=int(d["train_seed"]),
                   check_categories=int(d["check_categories"]))

    @property
    def names(self) -> list[str]:
        return [c for c, _ in self.categories]

    def n_train(self, n_test: int) -> int:
        """Train images a category holds: the supervised sweep keeps
        ``int(train_ratio * n_test)`` of them (``pipeline``'s rule), so the
        tree holds exactly that many and the sweep keeps them all."""
        return int(self.train_ratio * n_test) if self.mode == "supervised" \
            else 0


def anomaly_split(n: int, types: int) -> list[tuple[str, int]]:
    """(folder, count) of a category's test images: "good" and
    ``types - 1`` defects, as even as ``n`` allows, "good" first."""
    names = ["good"] + [f"defect_{i}" for i in range(types - 1)]
    base, extra = divmod(n, types)
    return [(a, base + (i < extra)) for i, a in enumerate(names)]


def _image(seed: int, index: int, k: int, size: int, defect: int | None
           ) -> tuple[np.ndarray, np.ndarray | None]:
    """Image ``k`` of category ``index`` and its mask (None for a normal
    image, ``defect`` None): its own stream (seed, index, k), so the
    pixels do not depend on how the writing is split."""
    rng = np.random.default_rng([seed % SEED_MOD, index, k])
    tint = np.random.default_rng([seed % SEED_MOD, index]).integers(
        40, 216, 3).astype(np.int16)
    low = Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    a = np.asarray(low.resize((size, size), Image.BICUBIC), np.int16)
    fine = rng.integers(-4, 5, a.shape, dtype=np.int16)
    img = np.clip((a + tint) // 2 + fine, 0, 255).astype(np.uint8)
    if defect is None:
        return img, None
    h, w = rng.integers(size // 8, size // 3, 2)
    y, x = rng.integers(0, size - h), rng.integers(0, size - w)
    img[y:y + h, x:x + w] = _DEFECT_COLOURS[defect % len(_DEFECT_COLOURS)]
    mask = np.zeros((size, size), np.uint8)
    mask[y:y + h, x:x + w] = 255
    return img, mask


def _files(mix: Mix) -> list[tuple]:
    """(category index, category, image number, relative path, defect or
    None, mask path or None) of every image of the tree; the image number
    runs over the category's test images and then its train images."""
    out = []
    for index, (cat, n) in enumerate(mix.categories):
        k = 0
        for t, (anomaly, count) in enumerate(anomaly_split(
                n, mix.anomaly_types)):
            for i in range(count):
                rel = os.path.join(cat, "test", anomaly, f"{i:03d}.png")
                mask = None if anomaly == "good" else os.path.join(
                    cat, "ground_truth", anomaly, f"{i:03d}_mask.png")
                out.append((index, k, rel, None if mask is None else t - 1,
                            mask))
                k += 1
        for i in range(mix.n_train(n)):
            out.append((index, k, os.path.join(cat, "train", "good",
                                                f"{i:03d}.png"), None, None))
            k += 1
    return out


def _write_files(root: str, seed: int, size: int, files: list) -> int:
    written = 0
    for index, k, rel, defect, mask_rel in files:
        img, mask = _image(seed, index, k, size, defect)
        for r, a in ((rel, img), (mask_rel, mask)):
            if r is None:
                continue
            path = os.path.join(root, r)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(a).save(path, compress_level=1)
            written += os.path.getsize(path)
    return written


def write_tree(root: str, mix: Mix, seed: int, workers: int = 8) -> int:
    """Write the mix's tree under ``root`` from ``seed`` on ``workers``
    threads (PIL's resize and encoder and numpy's loops run without the
    interpreter lock); the bytes written."""
    files = _files(mix)
    with ThreadPoolExecutor(workers) as pool:
        futures = [pool.submit(_write_files, root, seed,
                               mix.source_image_size, files[i::workers])
                   for i in range(workers)]
        return sum(f.result() for f in futures)


def check_sample(mix: Mix, seed: int) -> list[str]:
    """The categories whose answers the run compares with the reference
    (the mix's ``check_categories`` of them, in the mix's order): always
    the largest and the smallest, whose alpha shapes and last batches are
    the extremes of the window's, and the rest drawn from the seed."""
    sizes = [n for _, n in mix.categories]
    k = min(mix.check_categories, len(sizes))
    fixed = [int(np.argmax(sizes)), int(np.argmin(sizes))][:k]
    rest = [i for i in range(len(sizes)) if i not in fixed]
    rng = np.random.default_rng([seed % SEED_MOD, 0xC4EC])
    pick = set(fixed) | set(rng.choice(rest, size=k - len(fixed),
                                       replace=False).tolist())
    return [c for i, c in enumerate(mix.names) if i in pick]
