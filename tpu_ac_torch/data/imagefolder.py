"""ImageFolder dataset: <root>/<class>/<image> directory layout (port of
``tpu_ac.data.imagefolder``, a copy: that module imports no JAX, but the
port keeps its own).

Equivalent of torchvision.datasets.ImageFolder as used by DINO training
(dino-main/main_dino.py:145) and the linear/kNN evals.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}


class ImageFolder:
    def __init__(self, root: str, transform=None):
        self.root = root
        self.transform = transform
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: list[tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if os.path.splitext(fname)[1].lower() in _EXTS:
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, target = self.samples[idx]
        img = Image.open(path).convert("RGB")
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def epoch_batches(self, batch_size: int, *, seed: int, drop_last=True,
                      num_shards: int = 1, shard_index: int = 0):
        """Shuffled index batches for one epoch.

        The DistributedSampler equivalent (dino-main/main_dino.py:146):
        every shard permutes with the same seed and takes a strided slice
        of the WRAP-PADDED permutation (DistributedSampler pads to
        ceil(n/shards)*shards by repeating leading samples), so every
        shard sees exactly the same number of samples and batch count —
        unequal shards would desync lockstep multi-host steps and hang
        the collectives.
        """
        order = np.random.default_rng(seed).permutation(len(self.samples))
        if num_shards > 1:
            total = -(-len(order) // num_shards) * num_shards
            if total > len(order):  # wrap-pad like DistributedSampler
                order = np.concatenate([order, order[:total - len(order)]])
            order = order[shard_index::num_shards]
        end = (len(order) // batch_size * batch_size if drop_last
               else len(order))
        for i in range(0, end, batch_size):
            yield order[i:i + batch_size]
