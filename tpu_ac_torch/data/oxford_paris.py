"""Revisited Oxford5k / Paris6k retrieval dataset + protocol splits (port
of ``tpu_ac.data.oxford_paris``, a copy: that module imports no JAX, but
the port keeps its own).

Mirrors the reference's OxfordParisDataset and its Medium/Hard evaluation
construction (dino-main/eval_image_retrieval.py:33-78 and 182-198):

- ground truth comes from ``<dir_main>/<dataset>/gnd_<dataset>.pkl`` — a
  pickle with ``imlist`` (database image stems), ``qimlist`` (query stems)
  and ``gnd`` (per query: ``easy`` / ``hard`` / ``junk`` database index
  arrays);
- images live under ``<dir_main>/<dataset>/jpg/<stem>.jpg`` and are
  loaded RGB, thumbnailed to fit (imsize, imsize) preserving aspect ratio
  (PIL ``Image.thumbnail`` — NOT a square resize), then normalized with
  the ImageNet statistics;
- the Medium split scores easy+hard as positives with junk ignored; the
  Hard split scores hard only, with easy demoted to junk
  (eval_image_retrieval.py:182-198).

The reference evaluates full (uncropped) query images — the gnd pickles
carry a ``bbx`` query box but DINO's script never reads it; so does this
port (PARITY #16).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
from PIL import Image

from tpu_ac_torch.data.mvtec import IMAGENET_MEAN, IMAGENET_STD

DATASETS = ("roxford5k", "rparis6k")


class OxfordParisDataset:
    """Database ("train") or query split of roxford5k / rparis6k."""

    def __init__(self, dir_main: str, dataset: str, split: str,
                 imsize: int | None = None):
        if dataset not in DATASETS:
            raise ValueError(f"Unknown dataset: {dataset}!")
        if split not in ("train", "query"):
            raise ValueError(f"split must be train|query, got {split!r}")
        gnd_fname = os.path.join(dir_main, dataset, f"gnd_{dataset}.pkl")
        with open(gnd_fname, "rb") as f:
            cfg = pickle.load(f)
        cfg["gnd_fname"] = gnd_fname
        cfg["ext"] = ".jpg"
        cfg["qext"] = ".jpg"
        cfg["dir_data"] = os.path.join(dir_main, dataset)
        cfg["dir_images"] = os.path.join(cfg["dir_data"], "jpg")
        cfg["n"] = len(cfg["imlist"])
        cfg["nq"] = len(cfg["qimlist"])
        cfg["dataset"] = dataset
        self.cfg = cfg
        self.samples = cfg["qimlist"] if split == "query" else cfg["imlist"]
        self.split = split
        self.imsize = imsize

    def __len__(self) -> int:
        return len(self.samples)

    def image_path(self, index: int) -> str:
        return os.path.join(self.cfg["dir_images"],
                            self.samples[index] + ".jpg")

    def load_uint8(self, index: int) -> np.ndarray:
        """[3, H, W] uint8, thumbnailed (aspect-preserving) to imsize."""
        with open(self.image_path(index), "rb") as f:
            img = Image.open(f).convert("RGB")
        if self.imsize is not None:
            img.thumbnail((self.imsize, self.imsize), Image.LANCZOS)
        return np.array(img, np.uint8).transpose(2, 0, 1)

    def __getitem__(self, index: int) -> np.ndarray:
        """[3, H, W] float32 normalized image (aspect-preserving resize)."""
        x = self.load_uint8(index).transpose(1, 2, 0).astype(np.float32)
        x = (x / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        return x.transpose(2, 0, 1)


def revisited_splits(gnd: list[dict]) -> tuple[list[dict], list[dict]]:
    """(gnd_medium, gnd_hard) per eval_image_retrieval.py:182-198."""
    medium, hard = [], []
    for g in gnd:
        medium.append({
            "ok": np.concatenate([np.asarray(g["easy"], dtype=np.int64),
                                  np.asarray(g["hard"], dtype=np.int64)]),
            "junk": np.asarray(g["junk"], dtype=np.int64),
        })
        hard.append({
            "ok": np.asarray(g["hard"], dtype=np.int64),
            "junk": np.concatenate([np.asarray(g["junk"], dtype=np.int64),
                                    np.asarray(g["easy"], dtype=np.int64)]),
        })
    return medium, hard


def make_synthetic_roxford(root: str, dataset: str = "roxford5k",
                           n_db: int = 20, n_q: int = 4,
                           image_size: int = 48, seed: int = 0) -> str:
    """Tiny synthetic tree in the revisited layout (gnd pickle + jpgs) for
    tests and dry runs.  Queries are near-duplicates of their 'easy'
    positives so a sane embedding ranks them first.  The same draws in
    the same order as ``tpu_ac``'s, so the two trees are byte-equal."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, dataset)
    os.makedirs(os.path.join(d, "jpg"), exist_ok=True)
    imlist = [f"db_{i:03d}" for i in range(n_db)]
    qimlist = [f"q_{i:03d}" for i in range(n_q)]
    base = rng.integers(0, 255, (n_q, image_size, image_size, 3))
    gnd = []
    for i, stem in enumerate(qimlist):
        Image.fromarray(base[i].astype(np.uint8)).save(
            os.path.join(d, "jpg", stem + ".jpg"))
    per_q = n_db // n_q
    for i in range(n_q):
        idxs = np.arange(i * per_q, (i + 1) * per_q)
        easy, hard, junk = idxs[:2], idxs[2:3], idxs[3:4]
        for j in idxs:
            if j in easy or j in hard:
                img = np.clip(base[i] + rng.integers(-20, 20, base[i].shape),
                              0, 255)
            else:
                img = rng.integers(0, 255, base[i].shape)
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(d, "jpg", imlist[j] + ".jpg"))
        gnd.append({"easy": easy, "hard": hard, "junk": junk,
                    "bbx": np.asarray([0, 0, image_size, image_size])})
    # leftover db slots when n_db % n_q != 0: plain distractors (every
    # imlist entry must have a jpg on disk)
    for j in range(per_q * n_q, n_db):
        Image.fromarray(rng.integers(0, 255, base[0].shape)
                        .astype(np.uint8)).save(
            os.path.join(d, "jpg", imlist[j] + ".jpg"))
    with open(os.path.join(d, f"gnd_{dataset}.pkl"), "wb") as f:
        pickle.dump({"imlist": imlist, "qimlist": qimlist, "gnd": gnd}, f)
    return root
