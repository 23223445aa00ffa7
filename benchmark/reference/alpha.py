"""Alpha and X of anomaly clustering (Sohn et al., WACV 2023), plain f32
torch ops on the embeddings Z [N, P, D] of one category.

- unsupervised: W[i, p] = mean over j != i of min_q ||Z[i, p] - Z[j, q]||
  (the program also sums the j = i term, which is 0 in exact arithmetic)
- supervised:   W[i, p] = min over j, q of ||Z[i, p] - Z_train[j, q]||
- alpha[i] = softmax(W[i] / tau); X[i] = alpha[i] @ Z[i].

Squared distances are |a|^2 - 2 a.b + |b|^2 from an f32 product (TF32
off), the norms from the same values, the min taken before the root.
``q`` is applied to the product's operands (and so to the norms).
"""

from __future__ import annotations

import torch


def _d2(zi, a2i, zj, b2j):
    """[b, P, Q] squared distances of one image's patches zi [P, D]
    against a block of images zj [b, Q, D]."""
    dot = torch.matmul(zi, zj.transpose(1, 2))
    return a2i[None, :, None] - 2.0 * dot + b2j[:, None, :]


def weights_unsupervised(z: torch.Tensor, q, block: int = 16
                         ) -> torch.Tensor:
    n, p, _ = z.shape
    zq = q(z)
    sq = (zq * zq).sum(-1)
    w = torch.zeros(n, p, dtype=torch.float32, device=z.device)
    for i in range(n):
        for j0 in range(i + 1, n, block):
            j1 = min(j0 + block, n)
            d2 = _d2(zq[i], sq[i], zq[j0:j1], sq[j0:j1])
            w[i] += d2.amin(dim=2).clamp_min(0.0).sqrt().sum(dim=0)
            w[j0:j1] += d2.amin(dim=1).clamp_min(0.0).sqrt()
    return w / max(n - 1, 1)


def weights_supervised(z: torch.Tensor, z_train: torch.Tensor, q,
                       block: int = 16) -> torch.Tensor:
    n, p, _ = z.shape
    zq, tq = q(z), q(z_train)
    sq, tsq = (zq * zq).sum(-1), (tq * tq).sum(-1)
    d2min = torch.full((n, p), float("inf"), dtype=torch.float32,
                       device=z.device)
    for i in range(n):
        for j0 in range(0, tq.shape[0], block):
            j1 = min(j0 + block, tq.shape[0])
            d2 = _d2(zq[i], sq[i], tq[j0:j1], tsq[j0:j1])
            d2min[i] = torch.minimum(d2min[i], d2.amin(dim=(0, 2)))
    return d2min.clamp_min(0.0).sqrt()


def alpha_x(z: torch.Tensor, w: torch.Tensor, tau: float
            ) -> tuple[torch.Tensor, torch.Tensor]:
    alpha = torch.softmax(w / tau, dim=1)
    x = torch.einsum("np,npd->nd", alpha, z)
    return alpha, x
