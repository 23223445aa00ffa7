"""Coreset subsampling (port of ``tpu_ac.detect.sampler``; reference:
models/patchcore/sampler.py:9-191).

numpy's ``default_rng(seed)`` draws the JL projection, the random picks
and the starting points, as in ``tpu_ac``, so the loop starts from the
same inputs.  The greedy loop is sequential (each pick depends on the
running min-distance vector) and stays on the device: the pick is a 0-d
tensor, never read on the host, so 17,248 picks at the flagship size queue
without a host round trip.

The k = 1 loop computes |f - f[sel]| directly, as ``tpu_ac`` does, and so
does the approximate sampler's start (the mean distance to the starting
points).  Their sums over the feature axis run in a fixed pairwise order
of elementwise adds (``_tree_sum``), so the card and the CPU compute the
same bits and pick the same rows.  The batched loop (``select_batch`` >
1) folds its k picks in by the norm identity, one matmul, with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_ac_torch.device import precision_scope
from tpu_ac_torch.ops.distances import _topk, cdist


class IdentitySampler:
    """Pass-through (sampler.py:9-13)."""

    def run(self, features):
        return features


class RandomSampler:
    """Uniform subsample without replacement (sampler.py:174-191)."""

    def __init__(self, percentage: float, seed: int = 0):
        if not 0 < percentage < 1:
            raise ValueError("Percentage value not in (0, 1).")
        self.percentage = percentage
        self.seed = seed

    def run(self, features):
        n = len(features)
        keep = np.random.default_rng(self.seed).choice(
            n, int(n * self.percentage), replace=False)
        if isinstance(features, torch.Tensor):
            keep = torch.from_numpy(keep).to(features.device)
        return features[keep]


def _project(features: torch.Tensor, dim: int, seed: int) -> torch.Tensor:
    """Johnson-Lindenstrauss random linear projection to ``dim``
    (sampler.py:52-60 uses an untrained nn.Linear: any fixed random map)."""
    if features.shape[1] == dim:
        return features
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((features.shape[1], dim)).astype(np.float32)
    w /= np.sqrt(features.shape[1])
    with precision_scope("highest"):
        return features @ torch.from_numpy(w).to(features.device)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by halving it with elementwise adds: the same
    order, so the same bits, on any device."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        s = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([s, x[..., 2 * h:]], dim=-1) if x.shape[-1] % 2 else s
    return x[..., 0]


def _dists_to(features: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """|features - row| per row of features [N, d]; row is [1, d]."""
    diff = features - row
    return _tree_sum(diff.mul_(diff)).sqrt_()


def _greedy_select(features: torch.Tensor, init_anchor: torch.Tensor,
                   n_select: int) -> torch.Tensor:
    """Greedy loop: pick the argmax of the running min distance to the
    picks so far (sampler.py:100-115, 155-170)."""
    anchor = init_anchor.clone()
    idxs = torch.empty(n_select, dtype=torch.int64, device=features.device)
    for i in range(n_select):
        sel = torch.argmax(anchor)  # first of equal maxima, as jnp.argmax
        idxs[i] = sel
        row = features.index_select(0, sel.reshape(1))
        torch.minimum(anchor, _dists_to(features, row), out=anchor)
    return idxs


def _greedy_select_batched(features: torch.Tensor,
                           init_anchor: torch.Tensor, n_select: int,
                           k: int) -> torch.Tensor:
    """Batched farthest-point selection: the top k of the running min
    distance each iteration, folded in by ONE [N, d] x [d, k] matmul, so the
    bank streams from memory n_select / k times.  The k picks of one
    iteration are not conditioned on each other; k = 1 is the exact
    greedy's picks."""
    sq_norms = features.square().sum(-1)
    n_iters = -(-n_select // k)
    anchor = init_anchor.clone()
    idxs = torch.empty(n_iters * k, dtype=torch.int64,
                       device=features.device)
    for i in range(n_iters):
        _, sel = _topk(anchor, k, largest=True)
        idxs[i * k:(i + 1) * k] = sel
        sel_f = features[sel]
        with precision_scope("highest"):
            prod = features @ sel_f.T
        d2 = (sq_norms[:, None] + sel_f.square().sum(-1)[None]) - 2.0 * prod
        d = d2.amin(dim=1).clamp_min_(0.0).sqrt_()
        torch.minimum(anchor, d, out=anchor)
    return idxs[:n_select]


class GreedyCoresetSampler:
    """Exact greedy coreset (sampler.py:39-115): anchor initialised from the
    row norms of the full N x N distance matrix.  O(N^2) memory: use the
    approximate variant for large banks."""

    def __init__(self, percentage: float,
                 dimension_to_project_features_to: int = 128, seed: int = 0,
                 select_batch: int = 1):
        if not 0 < percentage < 1:
            raise ValueError("Percentage value not in (0, 1).")
        self.percentage = percentage
        self.proj_dim = dimension_to_project_features_to
        self.seed = seed
        if select_batch < 1:
            raise ValueError("select_batch must be >= 1")
        self.select_batch = select_batch

    def _select(self, reduced: torch.Tensor, anchor: torch.Tensor,
                n_select: int) -> torch.Tensor:
        if self.select_batch == 1:
            return _greedy_select(reduced, anchor, n_select)
        return _greedy_select_batched(reduced, anchor, n_select,
                                      self.select_batch)

    def _indices(self, reduced: torch.Tensor, n_select: int) -> torch.Tensor:
        anchor = torch.linalg.vector_norm(cdist(reduced, reduced), dim=1)
        return self._select(reduced, anchor, n_select)

    def run(self, features):
        """The selected rows of ``features`` [N, D] (numpy in, numpy out; a
        tensor stays on its device)."""
        was_numpy = isinstance(features, np.ndarray)
        f = torch.from_numpy(features) if was_numpy else features
        reduced = _project(f, self.proj_dim, self.seed)
        idxs = self._indices(reduced, int(len(f) * self.percentage))
        out = f[idxs]
        return out.numpy() if was_numpy else out


class ApproximateGreedyCoresetSampler(GreedyCoresetSampler):
    """Approximate greedy coreset (sampler.py:118-171): anchor initialised
    from the mean distance to ``number_of_starting_points`` random points;
    no N x N matrix is ever made."""

    def __init__(self, percentage: float,
                 number_of_starting_points: int = 10,
                 dimension_to_project_features_to: int = 128, seed: int = 0,
                 select_batch: int = 1):
        super().__init__(percentage, dimension_to_project_features_to, seed,
                         select_batch=select_batch)
        self.number_of_starting_points = number_of_starting_points

    def _indices(self, reduced: torch.Tensor, n_select: int) -> torch.Tensor:
        n = reduced.shape[0]
        n_start = min(self.number_of_starting_points, n)
        start = np.random.default_rng(self.seed).choice(
            n, n_start, replace=False)
        total = None
        for s in start.tolist():
            d = _dists_to(reduced, reduced[s:s + 1])
            total = d if total is None else total.add_(d)
        return self._select(reduced, total.div_(n_start), n_select)
