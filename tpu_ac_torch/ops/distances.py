"""Pairwise squared distances and exact k-NN, single-device and with the
bank row-sharded over a ``Mesh`` (port of ``tpu_ac.ops.distances``; the
FAISS IndexFlatL2 / IndexFlatIP replacement of PatchCore's scorer and
SCAN's neighbour mining).

A distance is ``|a|^2 - 2ab + |b|^2`` from one matmul, clamped at 0.
``tpu_ac`` runs that matmul at ``Precision.HIGHEST``: a TF32 product would
ruin the small distances the cancellation leaves, so every product here
runs with TF32 off (``device.precision_scope("highest")``), whatever the
process default.  Queries go in tiles of ``tile`` rows, bounding the live
[tile, N] distance matrix.  ``lax.top_k`` breaks ties by the lowest index
and ``torch.topk`` promises no order on the card, so ``_topk`` orders the
k it returns by (score, index); which of two rows tied at the k-th place
is kept stays unspecified.

The sharded searches (``knn_sharded``, ``knn_ip_sharded``) split the bank
into ``mesh.size`` row shards, one per mesh position (a mesh may repeat a
device, see ``distributed/mesh.py``): each rank scores the replicated
queries against its shard, masks its padded rows BEFORE its local top-k (a
zero row can otherwise beat real neighbours and evict them), and the
ranks' [M, k] candidates are gathered to the query's device and reduced by
one final top-k.  Exact: each global neighbour is in some rank's top-k.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_ac_torch.device import precision_scope


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances between rows: [..., M, D] x [..., N, D] ->
    [..., M, N], the product in full f32."""
    a2 = a.square().sum(-1, keepdim=True)
    b2 = b.square().sum(-1, keepdim=True)
    with precision_scope("highest"):
        d2 = torch.matmul(a, b.transpose(-1, -2))
    # (a2 - 2ab) + b2, in place: -2ab + a2 is a2 - 2ab exactly
    d2.mul_(-2.0).add_(a2).add_(b2.transpose(-1, -2))
    return d2.clamp_min_(0.0)


def cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.cdist(p=2) via the matmul path (sqrt of clamped sq-dists)."""
    return pairwise_sq_dists(a, b).sqrt_()


def inner_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, D] x [N, D] -> [M, N] dot products in full f32."""
    with precision_scope("highest"):
        return torch.matmul(a, b.transpose(-1, -2))


def _topk(scores: torch.Tensor, k: int, largest: bool
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ordered by score and then by index."""
    vals, idx = torch.topk(scores, k, dim=-1, largest=largest, sorted=False)
    idx, order = torch.sort(idx, dim=-1)
    vals = vals.gather(-1, order)
    vals, order = torch.sort(vals, dim=-1, descending=largest, stable=True)
    return vals, idx.gather(-1, order)


def _tiled_topk(query: torch.Tensor, bank: torch.Tensor, k: int, tile: int,
                score, largest: bool, valid: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of score(query tile, bank) over tiles of ``tile`` queries;
    bank rows where ``valid`` is False are masked out first."""
    fill = float("-inf") if largest else float("inf")
    vals, idxs = [], []
    for s in range(0, query.shape[0], tile):
        scores = score(query[s:s + tile], bank)
        if valid is not None:
            scores.masked_fill_(~valid[None, :], fill)
        v, i = _topk(scores, k, largest)
        vals.append(v)
        idxs.append(i)
    return torch.cat(vals), torch.cat(idxs)


def knn(query: torch.Tensor, index: torch.Tensor, k: int,
        *, tile: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest neighbours by L2 (FAISS IndexFlatL2.search):
    (squared distances [M, k] ascending, indices [M, k])."""
    return _tiled_topk(query, index, k, tile, pairwise_sq_dists, False)


def knn_ip(query: torch.Tensor, index: torch.Tensor, k: int,
           *, tile: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by inner product (FAISS IndexFlatIP.search):
    (similarities [M, k] descending, indices [M, k])."""
    return _tiled_topk(query, index, k, tile, inner_products, True)


def _sharded_topk(query: torch.Tensor, index: torch.Tensor, k: int, mesh,
                  tile: int, score, largest: bool
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    n = index.shape[0]
    shard_rows = -(-n // mesh.size)
    bank = F.pad(index, (0, 0, 0, shard_rows * mesh.size - n))
    queries = {d: query.to(d) for d in dict.fromkeys(mesh.devices)}
    home = query.device
    vals, idxs = [], []
    for rank, (shard, d) in enumerate(zip(bank.split(shard_rows),
                                          mesh.devices)):
        offset = rank * shard_rows
        valid = torch.arange(offset, offset + shard_rows, device=d) < n
        v, i = _tiled_topk(queries[d], shard.to(d), k, tile, score, largest,
                           valid)
        vals.append(v.to(home))
        idxs.append((i + offset).to(home))
    best, pos = _topk(torch.cat(vals, dim=1), k, largest)
    return best, torch.cat(idxs, dim=1).gather(1, pos)


def knn_sharded(query: torch.Tensor, index: torch.Tensor, k: int, mesh,
                *, tile: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """``knn`` with the bank row-sharded over ``mesh``; the results are on
    the query's device, indices into the unsharded ``index``.  Falls back
    to ``knn`` when fewer than k rows would fall on a rank."""
    if mesh.size == 1 or -(-index.shape[0] // mesh.size) < k:
        return knn(query, index, k, tile=tile)
    return _sharded_topk(query, index, k, mesh, tile, pairwise_sq_dists,
                         False)


def knn_ip_sharded(query: torch.Tensor, index: torch.Tensor, k: int, mesh,
                   *, tile: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """``knn_ip`` with the bank row-sharded over ``mesh`` (SCAN's sharded
    IndexFlatIP); falls back to ``knn_ip`` like ``knn_sharded``."""
    if mesh.size == 1 or -(-index.shape[0] // mesh.size) < k:
        return knn_ip(query, index, k, tile=tile)
    return _sharded_topk(query, index, k, mesh, tile, inner_products, True)
