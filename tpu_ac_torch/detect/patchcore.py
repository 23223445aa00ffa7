"""PatchCore anomaly detector (port of ``tpu_ac.detect.patchcore``;
reference models/patchcore/patchcore.py:20-274).

fit = embed all normal images -> coreset-subsample the patch bank -> store
it as the k-NN memory; predict = embed the test images -> per-patch k-NN
squared distance -> image score (max over patches) + segmentation mask
(bilinear rescale + Gaussian blur of the patch-score grid).

The detector is built around a batched ``embed_fn``: a [B, 3, H, W] tensor
on ``device`` (uint8 as decoded, or float) -> [B, P, D] tensor.  Images
are uploaded once per call; the last batch is zero-padded to the batch
size.  With the exact scorer the embeddings, the bank and the search stay
on the device; the IVF scorers quantize on the host and take numpy.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from tpu_ac_torch.device import resolve_device
from tpu_ac_torch.detect.sampler import IdentitySampler
from tpu_ac_torch.detect.scorer import NearestNeighbourScorer
from tpu_ac_torch.detect.segmentor import RescaleSegmentor


class PatchCore:
    def __init__(self, embed_fn, featuresampler=None,
                 anomaly_score_num_nn: int = 1,
                 target_size=(224, 224), batch_size: int = 8,
                 config: dict | None = None,
                 nn_method: str = "exact", mesh=None, device="cuda"):
        """``nn_method``: "exact" = FaissNN-equivalent flat L2; "ivfpq" /
        "ivfflat" = ApproximateFaissNN-equivalent inverted-file search
        (common.py:100-126).  ``mesh``: shard the exact scorer's memory
        bank over a ``tpu_ac_torch.distributed.Mesh`` (exact results, see
        ``ops.distances.knn_sharded``).  ``device``: where the images,
        the embed and the search run."""
        self.embed_fn = embed_fn
        self.device = device
        self.featuresampler = featuresampler or IdentitySampler()
        if nn_method == "exact":
            self.anomaly_scorer = NearestNeighbourScorer(
                anomaly_score_num_nn, mesh=mesh, device=device)
        else:
            if mesh is not None:
                raise ValueError(
                    f"mesh sharding is only supported for the exact "
                    f"scorer; nn_method={nn_method!r} runs single-device "
                    f"(drop --dp or use --nn_method exact)")
            from tpu_ac_torch.detect.approx import (
                ApproximateNearestNeighbourScorer,
            )

            self.anomaly_scorer = ApproximateNearestNeighbourScorer(
                anomaly_score_num_nn, method=nn_method, device=device)
        self.anomaly_segmentor = RescaleSegmentor(target_size, device=device)
        self.batch_size = batch_size
        self.config = config or {}

    def _embed_all(self, images) -> torch.Tensor:
        """[N, 3, H, W] numpy or tensor -> [N, P, D] on ``device``: one
        upload (pinned on the card), then batches of ``batch_size``."""
        dev = resolve_device(self.device)
        x = images if isinstance(images, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(images))
        n = x.shape[0]
        pad = (-n) % self.batch_size
        if pad:
            x = torch.cat([x, x.new_zeros(pad, *x.shape[1:])])
        if dev.type == "cuda" and x.device.type == "cpu":
            x = x.pin_memory()
        x = x.to(dev, non_blocking=True)
        chunks = [self.embed_fn(x[i:i + self.batch_size])
                  for i in range(0, x.shape[0], self.batch_size)]
        return torch.cat(chunks)[:n]

    @property
    def _device_flow(self) -> bool:
        """The exact scorer takes device tensors end to end; the IVF
        scorers quantize on the host."""
        return isinstance(self.anomaly_scorer, NearestNeighbourScorer)

    def fit(self, training_images) -> None:
        """_fill_memory_bank (patchcore.py:156-177): embed -> coreset ->
        index."""
        with torch.inference_mode():
            z = self._embed_all(training_images)  # [N, P, D]
            bank = self.featuresampler.run(z.reshape(-1, z.shape[-1]))
            self.anomaly_scorer.fit(
                [bank if self._device_flow else bank.cpu().numpy()])

    def predict(self, images, grid: tuple[int, int] | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
        """(image_scores [B], segmentation_masks [B, H, W]) as numpy
        (patchcore.py:204-229).

        ``grid``: the (gh, gw) patch grid for non-square feature maps;
        defaults to a square grid inferred from P, with a clear error
        otherwise.
        """
        with torch.inference_mode():
            z = self._embed_all(images)  # [B, P, D]
            b, p, d = z.shape
            patch_scores, _, _ = self.anomaly_scorer.predict(
                [z.reshape(-1, d)])
        patch_scores = patch_scores.reshape(b, p)
        image_scores = patch_scores.max(axis=1)  # PatchMaker.score
        if grid is None:
            g = int(math.isqrt(p))
            if g * g != p:
                raise ValueError(
                    f"non-square patch count {p}; pass grid=(gh, gw) for "
                    "rectangular feature maps")
            grid = (g, g)
        masks = self.anomaly_segmentor.convert_to_segmentation(
            patch_scores.reshape(b, *grid))
        return image_scores, masks

    # -- persistence (patchcore.py:235-274) --
    def save_to_path(self, save_path: str, prepend: str = "") -> None:
        os.makedirs(save_path, exist_ok=True)
        self.anomaly_scorer.save(save_path, prepend=prepend)
        with open(os.path.join(save_path,
                               prepend + "patchcore_params.json"), "w") as f:
            json.dump(self.config, f)

    def load_from_path(self, load_path: str, prepend: str = "") -> None:
        self.anomaly_scorer.load(load_path, prepend=prepend)
        params_file = os.path.join(load_path,
                                   prepend + "patchcore_params.json")
        if os.path.exists(params_file):
            with open(params_file) as f:
                self.config = json.load(f)
