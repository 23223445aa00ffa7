"""Approximate nearest-neighbour search, the ApproximateFaissNN equivalent
(port of ``tpu_ac.detect.approx``; reference models/patchcore/
common.py:100-126).

IVF-Flat: k-means coarse centroids (Lloyd iterations on the device), cells
padded to one size so the index is a few static tensors, and search =
centroid top-nprobe -> gather the candidate cells -> exact masked
distances -> top-k; exact within the probed cells.  IVF-PQ adds product
quantization of the residuals to the coarse centroid (M sub-spaces, 2^nbits
codes each; M bytes a stored vector) and searches by the asymmetric
distance ``|q - c|^2 + (|r|^2 + 2 c.r) - 2 q.r``: the middle term is a
per-vector constant fixed at fit time, the last a per-query [M, 2^nbits]
dot-product table gathered by code.  numpy's ``default_rng(seed)`` picks
the k-means starts, as in ``tpu_ac``; the cell tables are built on the
host; every product runs with TF32 off.  Queries go in chunks of
``query_chunk``, which bounds the candidate gather.  The index file is
``tpu_ac``'s ``<prepend>nnscorer_ivf_index.npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from tpu_ac_torch.device import precision_scope, resolve_device
from tpu_ac_torch.ops.distances import _topk, pairwise_sq_dists


def _kmeans_batched(xs: torch.Tensor, n_clusters: int, n_iters: int,
                    seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means over a batch of independent problems, the same start
    rows for each: xs [M, N, d] -> (centroids [M, k, d], assignments
    [M, N])."""
    n = xs.shape[1]
    init = np.random.default_rng(seed).choice(n, n_clusters, replace=False)
    cents = xs[:, torch.from_numpy(init).to(xs.device)]
    for _ in range(n_iters):
        assign = torch.argmin(pairwise_sq_dists(xs, cents), dim=2)
        onehot = F.one_hot(assign, n_clusters).to(xs.dtype)  # [M, N, k]
        with precision_scope("highest"):
            sums = onehot.transpose(1, 2) @ xs
        counts = onehot.sum(dim=1)[..., None]
        cents = torch.where(counts > 0, sums / counts.clamp_min(1.0), cents)
    return cents, torch.argmin(pairwise_sq_dists(xs, cents), dim=2)


def kmeans(x: torch.Tensor, n_clusters: int, n_iters: int = 10,
           seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means on x's device: (centroids [k, D], assignments [N])."""
    cents, assign = _kmeans_batched(x[None], n_clusters, n_iters, seed)
    return cents[0], assign[0]


def _cells(assign: np.ndarray, n_lists: int, *values):
    """Scatter the rows of each of ``values`` into padded cells in bank
    order: ([n_lists, max_cell, ...] per value, ids, valid)."""
    n = assign.shape[0]
    counts = np.bincount(assign, minlength=n_lists)
    max_cell = max(1, int(counts.max()))
    order = np.argsort(assign, kind="stable")
    cell = assign[order]
    slot = np.arange(n) - (np.cumsum(counts) - counts)[cell]
    out = []
    for v, fill in values:
        t = np.full((n_lists, max_cell, *v.shape[1:]), fill, v.dtype)
        t[cell, slot] = v[order]
        out.append(t)
    ids = np.full((n_lists, max_cell), -1, np.int32)
    ids[cell, slot] = order
    valid = np.zeros((n_lists, max_cell), bool)
    valid[cell, slot] = True
    return out, ids, valid


def _search_chunks(query: np.ndarray, chunk: int, device, fn):
    outs = [fn(torch.from_numpy(query[i:i + chunk]).to(device))
            for i in range(0, len(query), chunk)]
    return (torch.cat([o[0] for o in outs]).cpu().numpy(),
            torch.cat([o[1] for o in outs]).cpu().numpy())


class IVFFlatIndex:
    """Inverted-file flat index with static cell tables."""

    def __init__(self, n_lists: int = 64, n_probe: int = 8,
                 kmeans_iters: int = 10, seed: int = 0,
                 query_chunk: int = 1024, device="cuda"):
        self.n_lists = n_lists
        self.n_probe = n_probe
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.query_chunk = query_chunk
        self.device = device
        self.centroids: torch.Tensor | None = None
        self.cells: torch.Tensor | None = None       # [nlist, max_cell, D]
        self.cell_ids: torch.Tensor | None = None    # [nlist, max_cell]
        self.cell_valid: torch.Tensor | None = None  # [nlist, max_cell]

    def fit(self, bank: np.ndarray) -> None:
        dev = resolve_device(self.device)
        bank = np.asarray(bank, np.float32)
        n_lists = min(self.n_lists, bank.shape[0])
        cents, assign = kmeans(torch.from_numpy(bank).to(dev), n_lists,
                               self.kmeans_iters, self.seed)
        (cells,), ids, valid = _cells(assign.cpu().numpy(), n_lists,
                                      (bank, 0.0))
        self.centroids = cents
        self.cells, self.cell_ids, self.cell_valid = (
            torch.from_numpy(a).to(dev) for a in (cells, ids, valid))

    def search(self, query: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """(sq_distances [M, k], bank indices [M, k]) over probed cells."""
        if self.centroids is None:
            raise ValueError("index is not fitted")
        n_probe = min(self.n_probe, self.centroids.shape[0])
        k = min(k, n_probe * self.cells.shape[1])
        return _search_chunks(np.asarray(query, np.float32),
                              self.query_chunk, self.centroids.device,
                              lambda q: self._search(q, n_probe, k))

    def _search(self, q: torch.Tensor, n_probe: int, k: int):
        _, probe = _topk(pairwise_sq_dists(q, self.centroids), n_probe,
                         largest=False)                  # [M, nprobe]
        m = q.shape[0]
        cand = self.cells[probe].reshape(m, -1, q.shape[1])
        d2 = (cand - q[:, None, :]).square().sum(-1)
        d2.masked_fill_(~self.cell_valid[probe].reshape(m, -1),
                        float("inf"))
        d2, pos = _topk(d2, k, largest=False)
        return d2, self.cell_ids[probe].reshape(m, -1).gather(1, pos)


class IVFPQIndex:
    """Inverted file + product quantization (the ApproximateFaissNN
    semantics, common.py:100-126): M-byte codes per stored vector, ADC
    search.  Defaults mirror the reference's IndexIVFPQ(512, 64, 8)."""

    def __init__(self, n_lists: int = 512, n_probe: int = 8,
                 code_size: int = 64, n_bits: int = 8,
                 kmeans_iters: int = 10, seed: int = 0,
                 query_chunk: int = 1024, device="cuda"):
        if n_bits > 8:
            raise ValueError("codes are stored as uint8; n_bits <= 8")
        self.n_lists = n_lists
        self.n_probe = n_probe
        self.code_size = code_size
        self.n_bits = n_bits
        self.kmeans_iters = kmeans_iters
        self.seed = seed
        self.query_chunk = query_chunk
        self.device = device
        self.centroids: torch.Tensor | None = None   # [L, D]
        self.codebooks: torch.Tensor | None = None   # [M, K, dsub]
        self.cell_codes: torch.Tensor | None = None  # [L, max_cell, M] u8
        self.cell_const: torch.Tensor | None = None  # [L, max_cell] f32
        self.cell_ids: torch.Tensor | None = None    # [L, max_cell] int32
        self.cell_valid: torch.Tensor | None = None  # [L, max_cell] bool
        self._pad = 0

    def _padded(self, x: np.ndarray) -> np.ndarray:
        if self._pad:
            x = np.pad(x, ((0, 0), (0, self._pad)))
        return x

    def fit(self, bank: np.ndarray) -> None:
        dev = resolve_device(self.device)
        bank = np.asarray(bank, np.float32)
        n, d = bank.shape
        m = min(self.code_size, d)
        self._pad = (-d) % m
        bank = self._padded(bank)
        dsub = (d + self._pad) // m

        n_lists = min(self.n_lists, n)
        cents, assign = kmeans(torch.from_numpy(bank).to(dev), n_lists,
                               self.kmeans_iters, self.seed)
        cents, assign = cents.cpu().numpy(), assign.cpu().numpy()

        residual = bank - cents[assign]
        k_codes = min(2 ** self.n_bits, n)
        xs = torch.from_numpy(np.ascontiguousarray(
            residual.reshape(n, m, dsub).transpose(1, 0, 2))).to(dev)
        codebooks, codes = _kmeans_batched(xs, k_codes, self.kmeans_iters,
                                           self.seed + 1)
        codebooks = codebooks.cpu().numpy()               # [M, K, dsub]
        codes = codes.cpu().numpy().T.astype(np.uint8)    # [N, M]

        # per-stored-vector ADC constant: |r_code|^2 + 2 c . r_code
        decoded = codebooks[np.arange(m)[None, :], codes].reshape(n, -1)
        const = (np.sum(decoded * decoded, axis=1)
                 + 2.0 * np.sum(cents[assign] * decoded, axis=1))

        (cell_codes, cell_const), ids, valid = _cells(
            assign, n_lists, (codes, 0), (const.astype(np.float32), 0.0))
        self.centroids = torch.from_numpy(cents).to(dev)
        self.codebooks = torch.from_numpy(codebooks).to(dev)
        self.cell_codes, self.cell_const, self.cell_ids, self.cell_valid = (
            torch.from_numpy(a).to(dev)
            for a in (cell_codes, cell_const, ids, valid))

    @property
    def code_bytes(self) -> int:
        """Bytes spent on stored-vector codes (the PQ compression claim)."""
        return 0 if self.cell_codes is None else self.cell_codes.numel()

    def search(self, query: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """(approx sq_distances [Q, k], bank indices [Q, k]) via ADC."""
        if self.centroids is None:
            raise ValueError("index is not fitted")
        n_probe = min(self.n_probe, self.centroids.shape[0])
        k = min(k, n_probe * self.cell_codes.shape[1])
        return _search_chunks(self._padded(np.asarray(query, np.float32)),
                              self.query_chunk, self.centroids.device,
                              lambda q: self._search(q, n_probe, k))

    def _search(self, q: torch.Tensor, n_probe: int, k: int):
        b = q.shape[0]
        m, k_codes, dsub = self.codebooks.shape
        cd2, probe = _topk(pairwise_sq_dists(q, self.centroids), n_probe,
                           largest=False)                # [B, P]
        # per-query table q_sub . codebook -> [B, M * K]
        with precision_scope("highest"):
            qdot = torch.einsum("bmd,mkd->bmk", q.reshape(b, m, dsub),
                                self.codebooks).reshape(b, m * k_codes)
        codes = self.cell_codes[probe].long()            # [B, P, C, M]
        flat = codes + torch.arange(m, device=q.device) * k_codes
        qr = qdot.gather(1, flat.reshape(b, -1)).reshape(flat.shape).sum(-1)
        d2 = (cd2[:, :, None] + self.cell_const[probe]) - 2.0 * qr
        d2.masked_fill_(~self.cell_valid[probe], float("inf"))
        d2, pos = _topk(d2.reshape(b, -1), k, largest=False)
        return d2, self.cell_ids[probe].reshape(b, -1).gather(1, pos)


class ApproximateNearestNeighbourScorer:
    """Drop-in NearestNeighbourScorer variant over the IVF indexes
    (common.py ApproximateFaissNN + NearestNeighbourScorer composition).

    ``method="ivfpq"`` matches the reference's IndexIVFPQ memory semantics;
    ``method="ivfflat"`` keeps exact distances within probed cells."""

    def __init__(self, n_nearest_neighbours: int = 1,
                 n_lists: int | None = None,
                 n_probe: int = 8, method: str = "ivfflat",
                 code_size: int = 64, n_bits: int = 8, device="cuda"):
        self.n_nearest_neighbours = n_nearest_neighbours
        self.device = device
        if method == "ivfpq":
            # defaults mirror the reference's IndexIVFPQ(dim, 512, 64, 8)
            # (common.py:109-117): 512 coarse centroids, 64 sub-quantizers
            self.index: IVFFlatIndex | IVFPQIndex = IVFPQIndex(
                n_lists=512 if n_lists is None else n_lists,
                n_probe=n_probe, code_size=code_size, n_bits=n_bits,
                device=device)
        elif method == "ivfflat":
            self.index = IVFFlatIndex(
                n_lists=64 if n_lists is None else n_lists, n_probe=n_probe,
                device=device)
        else:
            raise ValueError(f"unknown approximate-NN method {method!r}")

    @staticmethod
    def _concat(features: list) -> np.ndarray:
        return np.concatenate(
            [(f.cpu().numpy() if isinstance(f, torch.Tensor)
              else np.asarray(f)).reshape(len(f), -1) for f in features],
            axis=1)

    def fit(self, detection_features: list) -> None:
        self.index.fit(self._concat(detection_features))

    def predict(self, query_features: list):
        d2, idx = self.index.search(self._concat(query_features),
                                    self.n_nearest_neighbours)
        return np.mean(d2, axis=-1), d2, idx

    # -- persistence (the faiss.write_index equivalent, common.py:71-82):
    #    the fitted index is a handful of arrays --
    _FLAT_KEYS = ("centroids", "cells", "cell_ids", "cell_valid")
    _PQ_KEYS = ("centroids", "codebooks", "cell_codes", "cell_const",
                "cell_ids", "cell_valid")

    @staticmethod
    def _index_file(folder: str, prepend: str = "") -> str:
        return os.path.join(folder, prepend + "nnscorer_ivf_index.npz")

    def save(self, save_folder: str, prepend: str = "") -> None:
        is_pq = isinstance(self.index, IVFPQIndex)
        keys = self._PQ_KEYS if is_pq else self._FLAT_KEYS
        arrays = {k: getattr(self.index, k).cpu().numpy() for k in keys}
        if is_pq:
            arrays["pad"] = np.int64(self.index._pad)
        np.savez_compressed(
            self._index_file(save_folder, prepend),
            method="ivfpq" if is_pq else "ivfflat",
            k=self.n_nearest_neighbours, n_probe=self.index.n_probe,
            **arrays)

    def load(self, load_folder: str, prepend: str = "") -> None:
        data = np.load(self._index_file(load_folder, prepend))
        self.n_nearest_neighbours = int(data["k"])
        dev = resolve_device(self.device)
        if str(data["method"]) == "ivfpq":
            self.index = IVFPQIndex(n_probe=int(data["n_probe"]),
                                    device=self.device)
            self.index._pad = int(data["pad"])
            keys = self._PQ_KEYS
        else:
            self.index = IVFFlatIndex(n_probe=int(data["n_probe"]),
                                      device=self.device)
            keys = self._FLAT_KEYS
        for key in keys:
            setattr(self.index, key, torch.from_numpy(data[key]).to(dev))
