"""LARS (port of ``tpu_ac.train.optim``; dino-main/utils.py:553-591).

The optimizer DINO uses for ResNet-family training: SGD with a
per-parameter trust ratio eta * ||p|| / ||g + wd*p||, skipping 1-D params
(biases, norms) for both weight decay and the adaptive scaling, the
reference's ``exclude_bias_and_norm`` filters.  It is ``tpu_ac``'s
gradient transformation on dicts of tensors: ``init(params)`` and
``update(grads, state, params) -> (updates, state)``; add the updates to
the parameters.  No CLI of either package calls it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LARSState(NamedTuple):
    momentum: dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def lars(learning_rate: float | None = None, momentum: float = 0.9,
         weight_decay: float = 0.0, eta: float = 0.001,
         weight_decay_filter=None, lars_adaptation_filter=None
         ) -> GradientTransformation:
    """LARS on dicts of tensors.  By default 1-D parameters skip weight
    decay and adaptation (utils.py:569-573).  The updates are -lr * mu
    when ``learning_rate`` is given, else the momentum buffer itself."""

    def default_filter(p):
        return getattr(p, "ndim", 2) != 1

    wd_filter = weight_decay_filter or default_filter
    ad_filter = lars_adaptation_filter or default_filter

    def init(params):
        return LARSState(momentum={k: torch.zeros_like(v)
                                   for k, v in params.items()})

    def update(grads, state, params):
        if params is None:
            raise ValueError("lars requires params")

        def one(g, p, mu):
            dp = g
            if wd_filter(p):
                dp = dp + weight_decay * p
            if ad_filter(p):
                p_norm = torch.linalg.vector_norm(p)
                g_norm = torch.linalg.vector_norm(dp)
                q = torch.where(
                    (p_norm > 0.0) & (g_norm > 0.0),
                    eta * p_norm / torch.clamp(g_norm, min=1e-12),
                    torch.ones_like(p_norm))
                dp = dp * q
            return momentum * mu + dp

        new_mu = {k: one(grads[k], params[k], state.momentum[k])
                  for k in grads}
        scale = -learning_rate if learning_rate is not None else 1.0
        updates = {k: scale * m for k, m in new_mu.items()}
        return updates, LARSState(momentum=new_mu)

    return GradientTransformation(init, update)
