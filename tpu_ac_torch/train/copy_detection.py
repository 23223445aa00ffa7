"""Copydays copy-detection protocol (port of
``tpu_ac.train.copy_detection``; dino-main/eval_copy_detection.py).

- ``CopydaysDataset``: the 20-block layout (original, strong, 9 jpegqual
  levels, 9 crop levels; eval_copy_detection.py:33-61), queries = every
  block, database = originals only.
- ``gem_cls_features``: CLS token concatenated with GeM(p=4)-pooled patch
  tokens of the last block (eval_copy_detection.py:166-175).
- ``copydays_eval``: optional distractor merging into the database and
  whitening learned on held-out images (center + PCA whit=0.5 on the
  UNCENTERED second moment, PARITY #18; eval_copy_detection.py:262-281),
  cosine top-20 retrieval with TF32 off, per-block mAP with the strong
  block's prefix-matched positives (eval_copy_detection.py:63-92).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

import numpy as np
import torch

from tpu_ac_torch.device import precision_scope, resolve_device
from tpu_ac_torch.distributed.mesh import Mesh
from tpu_ac_torch.train.evals import PCA, compute_ap, extract_features

JPEG_LEVELS = (3, 5, 8, 10, 15, 20, 30, 50, 75)
CROP_LEVELS = (10, 15, 20, 30, 40, 50, 60, 70, 80)
IMAGE_EXTS = ("jpg", "jpeg", "png", "ppm", "bmp", "pgm", "tif", "tiff",
              "webp")


def is_image_file(name: str) -> bool:
    return name.rsplit(".", 1)[-1].lower() in IMAGE_EXTS


@dataclasses.dataclass
class CopydaysDataset:
    """Block layout of the Copydays benchmark
    (eval_copy_detection.py:33-61)."""

    basedir: str

    @property
    def block_names(self) -> list[str]:
        return (["original", "strong"]
                + [f"jpegqual/{i}" for i in JPEG_LEVELS]
                + [f"crops/{i}" for i in CROP_LEVELS])

    def get_block(self, i: int) -> list[str]:
        dirname = os.path.join(self.basedir, self.block_names[i])
        return [os.path.join(dirname, f)
                for f in sorted(os.listdir(dirname))
                if is_image_file(f)]

    def get_block_filenames(self, subdir: str) -> list[str]:
        dirname = os.path.join(self.basedir, subdir)
        return [f for f in sorted(os.listdir(dirname))
                if is_image_file(f)]

    def query_paths(self) -> tuple[list[str], list[int]]:
        """All blocks concatenated + per-block sizes (queries)."""
        paths, sizes = [], []
        for i in range(len(self.block_names)):
            block = self.get_block(i)
            paths.extend(block)
            sizes.append(len(block))
        return paths, sizes

    def database_paths(self) -> list[str]:
        return self.get_block(0)  # search only among originals

    def eval_result(self, ids: np.ndarray,
                    block_sizes: Sequence[int]) -> dict[str, float]:
        """Per-block mAP from ranked database ids
        (eval_copy_detection.py:63-92).  The 'strong' block matches by
        4-char filename prefix; every other block is a 1:1 index map."""
        results: dict[str, float] = {}
        j0 = 0
        for i, block_name in enumerate(self.block_names):
            j1 = j0 + block_sizes[i]
            rows = ids[j0:j1]
            if block_name != "strong":
                positives_per_query = [[q] for q in range(j1 - j0)]
            else:
                originals = self.get_block_filenames("original")
                strongs = self.get_block_filenames("strong")
                positives_per_query = [
                    [j for j, bname in enumerate(originals)
                     if bname[:4] == qname[:4]]
                    for qname in strongs]
            sum_ap = 0.0
            for qno, row in enumerate(rows):
                positives = positives_per_query[qno]
                ranks = [rank for rank, bno in enumerate(row)
                         if bno in positives]
                sum_ap += compute_ap(np.asarray(ranks), len(positives))
            results[block_name] = sum_ap / max(1, j1 - j0)
            j0 = j1
        return results


def gem_cls_features(tokens: torch.Tensor, p: float = 4.0) -> torch.Tensor:
    """[B, 1+N, D] last-block tokens -> [B, 2D] CLS ++ GeM(p) patch pool
    (eval_copy_detection.py:166-175), the patches clamped at 1e-6."""
    cls_tok = tokens[:, 0, :]
    patches = torch.clamp(tokens[:, 1:, :], min=1e-6)
    gem = torch.mean(patches ** p, dim=1) ** (1.0 / p)
    return torch.cat([cls_tok, gem], dim=1)


def extract_copydetect_features(tokens_fn: Callable, images: np.ndarray,
                                batch_size: int = 16, *,
                                mesh: Mesh | None = None,
                                device: str | torch.device = "cuda"
                                ) -> np.ndarray:
    """``tokens_fn``: a batch on a device -> its final-norm'd last-block
    tokens [B, 1+N, D] there; returns the CLS + GeM features [N, 2D] on
    the host.  With ``mesh`` each batch is split over its ranks and the
    features gathered back (``extract_features``), the reference's
    DistributedSampler + ``all_gather`` (eval_copy_detection.py:162,
    186-194)."""
    return extract_features(lambda x: gem_cls_features(tokens_fn(x)),
                            images, batch_size, normalize=False, mesh=mesh,
                            device=device)


def copydays_eval(query_features: np.ndarray,
                  database_features: np.ndarray,
                  dataset: CopydaysDataset,
                  block_sizes: Sequence[int],
                  distractor_features: np.ndarray | None = None,
                  whitening_features: np.ndarray | None = None,
                  topk: int = 20,
                  device: str | torch.device = "cuda") -> dict[str, float]:
    """Distractor merge + whitening + cosine top-k + per-block mAP
    (eval_copy_detection.py:246-301).  Distractors enlarge the database
    AFTER the originals so ground-truth indices stay valid.  The
    whitening runs on the host (numpy, as ``tpu_ac``), the top-k on
    ``device`` in f32 with TF32 off."""
    database = np.asarray(database_features, np.float32)
    queries = np.asarray(query_features, np.float32)
    if distractor_features is not None and len(distractor_features):
        database = np.concatenate(
            [database, np.asarray(distractor_features, np.float32)])
    if whitening_features is not None and len(whitening_features):
        w = np.asarray(whitening_features, np.float32)
        mean = w.mean(axis=0)
        database = database - mean
        queries = queries - mean
        pca = PCA(dim=database.shape[-1], whit=0.5)
        # The reference's quirk, kept on purpose (PARITY #18,
        # eval_copy_detection.py:277-284): the "covariance" is the
        # UNCENTERED second moment w.T @ w / n (only database and queries
        # are centered), i.e. cov + mean mean^T.  Copydays mAP parity
        # needs it.
        pca.train_pca(w.T @ w / len(w))
        database = pca.apply(database)
        queries = pca.apply(queries)

    dev = resolve_device(device)
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(dev)
    db = torch.from_numpy(np.asarray(database, np.float32)).to(dev)
    with precision_scope("highest"):
        qn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
        dn = db / torch.linalg.vector_norm(db, dim=1, keepdim=True)
        _, idx = torch.topk(qn @ dn.T, min(topk, db.shape[0]), dim=1)
    return dataset.eval_result(idx.cpu().numpy(), block_sizes)
