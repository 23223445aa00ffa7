"""Alpha patch-weighting math (port of ``tpu_ac.cluster.alpha``).

Per test image i with patch embeddings Z[i] in R^{P x D}:

- unsupervised: W[i,p] = mean_{j != i} min_q ||Z[i,p] - Z[j,q]||
- supervised:   W[i,p] = min_{j,q}    ||Z[i,p] - Z_train[j,q]||
- alpha[i]      = exp(W[i]/tau) row-normalized; tau=0 -> one-hot of the
                  argmax (ties split uniformly)
- X[i]          = alpha[i] @ Z[i]

The min-distance sweep is ``kernels.distances.min_dists_all_pairs``: the
CUDA kernel for CUDA tensors, its plain version for CPU tensors.  ``tpu_ac``'s
per-image XLA formulation (``impl="xla"``) has no counterpart here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_ac_torch.kernels.distances import (
    count_tensor,
    min_dists_all_pairs,
)


def _valid_rows(n: int, nv: torch.Tensor, device) -> torch.Tensor:
    """[n] bool: the rows below the count ``nv`` (a 0-d CPU tensor)."""
    return torch.arange(n, device=device) < nv


def weight_distance_unsupervised(Z: torch.Tensor, n_valid=None,
                                 precision: str = "f32") -> torch.Tensor:
    """W [N, P]: W[i,p] = mean over j != i of min_q ||Z[i,p]-Z[j,q]||.

    Rows of Z at or past ``n_valid`` (an int or a 0-d int64 CPU tensor, as
    an exported program passes it) are padding: no pair with a padded
    image is computed and their W rows are 0.  The j == i term (~0: the
    self-distance floor of the precision mode) is kept in the sum, which is
    divided by n_valid - 1, exactly like ``tpu_ac`` and the reference's
    cdist path.
    """
    n = Z.shape[0]
    nv = count_tensor(n_valid, n)
    mins = min_dists_all_pairs(Z, Z, precision=precision, symmetric=True,
                               n_valid=nv)  # [N, N, P], +inf past nv
    valid = _valid_rows(n, nv, Z.device)
    w = torch.where(valid[None, :, None], mins, 0.0).sum(dim=1) \
        / (nv - 1).clamp_min(1)
    return torch.where(valid[:, None], w, 0.0)


def weight_distance_supervised(Z: torch.Tensor, Z_train: torch.Tensor,
                               n_train_valid=None, precision: str = "f32",
                               n_valid=None) -> torch.Tensor:
    """W [N, P]: W[i,p] = min over the valid train patches of the distance
    (train rows at or past ``n_train_valid`` are padding, left out; rows of
    Z at or past ``n_valid`` are not computed and their W rows are 0)."""
    n = Z.shape[0]
    nv = count_tensor(n_valid, n)
    mins = min_dists_all_pairs(
        Z, Z_train, precision=precision, n_valid=nv,
        n_bank_valid=count_tensor(n_train_valid, Z_train.shape[0]))
    return torch.where(_valid_rows(n, nv, Z.device)[:, None],
                       mins.amin(dim=1), 0.0)


def alpha_from_weights(W: torch.Tensor, tau: float, k: float = 1.0
                       ) -> torch.Tensor:
    """Row-normalized exp(W/tau).  tau = 0: one-hot of the row argmax,
    uniform over ties.  tau > 0: the row max is subtracted first (exact for
    a softmax; the constant k cancels)."""
    if math.isclose(tau, 0.0):
        hot = (W == W.amax(dim=1, keepdim=True)).to(W.dtype)
        return hot / hot.sum(dim=1, keepdim=True)
    scaled = W / tau
    e = torch.exp(scaled - scaled.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def matrix_alpha_average(Z: torch.Tensor) -> torch.Tensor:
    """Uniform weights — the 'average' mode."""
    n, p, _ = Z.shape
    return torch.full((n, p), 1.0 / p, dtype=Z.dtype, device=Z.device)


def weighted_embedding(alpha: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """X = bmm(alpha, Z): [N, P] x [N, P, D] -> [N, D] (full f32)."""
    return torch.bmm(alpha.to(Z.dtype)[:, None, :], Z)[:, 0]


def max_hausdorff_distance(a, b) -> float:
    """The reference's Max_Hausdorff_Distance: the DIRECTED Hausdorff
    distance sup_p inf_q ||a_p - b_q|| (its max() compares the same
    directed call twice)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d2 = (np.sum(a * a, 1)[:, None] - 2.0 * a @ b.T
          + np.sum(b * b, 1)[None, :])
    return float(np.sqrt(np.maximum(d2.min(axis=1), 0.0).max()))
