"""Nearest-neighbour anomaly scorer, the FAISS IndexFlatL2 replacement
(port of ``tpu_ac.detect.scorer``; reference models/patchcore/
common.py:296-393).

Scores are the mean of the k smallest *squared* L2 distances from each
query patch to the memory bank, searched exactly by ``ops.distances.knn``
(or ``knn_sharded`` over a ``Mesh``).  A bank given as a tensor stays on
its device from the embed to the search; a numpy bank (a loaded file) is
uploaded once, at the first predict, to ``device``.  Persistence is the
``tpu_ac`` file: ``<prepend>nnscorer_memory_bank.npz`` with ``bank`` and
``k``, so a bank saved by one package loads in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_ac_torch.device import resolve_device
from tpu_ac_torch.ops.distances import knn, knn_sharded


def _rows(f) -> torch.Tensor | np.ndarray:
    return f.reshape(len(f), -1)


class NearestNeighbourScorer:
    def __init__(self, n_nearest_neighbours: int = 1, mesh=None,
                 device="cuda"):
        """``mesh``: a ``tpu_ac_torch.distributed.Mesh``; the bank is
        row-sharded over it at each search.  ``device``: where a numpy
        bank is uploaded."""
        self.n_nearest_neighbours = n_nearest_neighbours
        self.mesh = mesh
        self.device = device
        self.detection_features = None  # np.ndarray or torch.Tensor
        self._device_bank = None        # upload-once cache for predict

    def fit(self, detection_features: list) -> None:
        """Store the memory bank: the groups' rows concatenated along the
        feature axis (common.py:316-330)."""
        feats = [_rows(f) for f in detection_features]
        if len(feats) == 1:
            self.detection_features = feats[0]
        elif any(isinstance(f, torch.Tensor) for f in feats):
            dev = next(f.device for f in feats
                       if isinstance(f, torch.Tensor))
            self.detection_features = torch.cat(
                [torch.as_tensor(f, device=dev) for f in feats], dim=1)
        else:
            self.detection_features = np.concatenate(feats, axis=1)
        self._device_bank = None

    def predict(self, query_features: list
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(anomaly_scores [M], sq_distances [M, k], nn_indices [M, k]) as
        numpy (common.py:332-355); only these leave the device."""
        if self.detection_features is None:
            raise ValueError("Scorer is not fitted.")
        if self._device_bank is None:
            bank = self.detection_features
            self._device_bank = bank if isinstance(bank, torch.Tensor) \
                else torch.from_numpy(bank).to(resolve_device(self.device))
        bank = self._device_bank
        qs = [torch.as_tensor(_rows(f), device=bank.device)
              for f in query_features]
        q = qs[0] if len(qs) == 1 else torch.cat(qs, dim=1)
        k = self.n_nearest_neighbours
        if self.mesh is not None:
            d2, idx = knn_sharded(q, bank, k, self.mesh)
        else:
            d2, idx = knn(q, bank, k)
        d2, idx = d2.cpu().numpy(), idx.cpu().numpy()
        return np.mean(d2, axis=-1), d2, idx

    # -- persistence (common.py:357-393): the bank array is the index --
    @staticmethod
    def _bank_file(folder: str, prepend: str = "") -> str:
        return os.path.join(folder, prepend + "nnscorer_memory_bank.npz")

    def save(self, save_folder: str, prepend: str = "") -> None:
        bank = self.detection_features
        if isinstance(bank, torch.Tensor):
            bank = bank.cpu().numpy()
        np.savez_compressed(self._bank_file(save_folder, prepend),
                            bank=bank, k=self.n_nearest_neighbours)

    def load(self, load_folder: str, prepend: str = "") -> None:
        data = np.load(self._bank_file(load_folder, prepend))
        self.detection_features = data["bank"]
        self.n_nearest_neighbours = int(data["k"])
        self._device_bank = None  # a fitted scorer's cache is now stale
