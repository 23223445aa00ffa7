"""Optimizers as gradient transformations on dicts of tensors (port of
``tpu_ac.train.optim``, and of the optax transformations ``tpu_ac``'s
SCAN and DINO steps use).

Each is ``tpu_ac``'s (optax's) transformation: ``init(params) -> state``
and ``update(grads, state, params) -> (updates, state)``; add the updates
to the parameters with ``apply_updates``.  The arithmetic is optax's, op
for op, on ``torch._foreach_*`` lists (a few multi-tensor launches a step
on the card, not one a parameter), and each state has the leaves of
optax's in the same order, so a checkpoint of either package restores in
the other:

- ``chain(*ts)``: a tuple of the states;
- ``add_decayed_weights(wd)``: no state; g + wd * p;
- ``sgd(lr, momentum, nesterov)``: ``TraceState`` (the momentum buffer)
  or no state; the buffer is g + momentum * buffer, the update
  -lr * buffer;
- ``adam(lr)``: ``AdamState`` (optax's ``ScaleByAdamState``: one shared
  count, the two moments); bias correction, eps outside the square root;
- ``lars`` (dino-main/utils.py:553-591): SGD with a per-parameter trust
  ratio eta * ||p|| / ||g + wd*p||, skipping 1-D params (biases, norms)
  for both weight decay and the adaptive scaling, the reference's
  ``exclude_bias_and_norm`` filters.  No CLI of either package calls it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


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


class TraceState(NamedTuple):
    """optax ``TraceState``: the momentum buffer of ``sgd``."""
    trace: dict[str, torch.Tensor]


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState``: the same fields in the same order, so
    a checkpoint's leaves line up with ``tpu_ac``'s."""
    count: torch.Tensor  # int32 scalar, shared by every parameter
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def _lists(tree: dict, names: list[str]) -> list[torch.Tensor]:
    return [tree[k] for k in names]


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """optax.chain: each transformation's updates feed the next."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """optax.add_decayed_weights: g + wd * p, for every parameter."""

    def init(params):
        return ()

    def update(grads, state, params):
        names = list(grads)
        new = torch._foreach_add(_lists(grads, names), _lists(params, names),
                                 alpha=weight_decay)
        return dict(zip(names, new)), state

    return GradientTransformation(init, update)


def sgd(learning_rate: float, momentum: float | None = None,
        nesterov: bool = False) -> GradientTransformation:
    """optax.sgd: an optional momentum trace, then -lr."""

    def init(params):
        if not momentum:
            return ()
        return TraceState({k: torch.zeros_like(v) for k, v in params.items()})

    def update(grads, state, params=None):
        names = list(grads)
        g = _lists(grads, names)
        if momentum:
            trace = torch._foreach_add(g, _lists(state.trace, names),
                                       alpha=momentum)
            state = TraceState(dict(zip(names, trace)))
            g = (torch._foreach_add(g, trace, alpha=momentum) if nesterov
                 else trace)
        return dict(zip(names, torch._foreach_mul(g, -learning_rate))), state

    return GradientTransformation(init, update)


def scale_by_adam(g: list[torch.Tensor], mu: list[torch.Tensor],
                  nu: list[torch.Tensor], count: torch.Tensor):
    """optax scale_by_adam on lists: (updates, mu, nu, count), the moments
    and the shared count advanced, the bias correction applied, eps
    outside the square root."""
    mu = torch._foreach_mul(mu, ADAM_B1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - ADAM_B1))
    nu = torch._foreach_mul(nu, ADAM_B2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                               1 - ADAM_B2))
    count = count + 1
    # the corrections in the moments' dtype (optax's power of the decay)
    dt, dev = mu[0].dtype, count.device
    bc1 = 1 - torch.pow(torch.full((), ADAM_B1, dtype=dt, device=dev), count)
    bc2 = 1 - torch.pow(torch.full((), ADAM_B2, dtype=dt, device=dev), count)
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, ADAM_EPS)
    u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    return u, mu, nu, count


def adam(learning_rate: float) -> GradientTransformation:
    """optax.adam at its defaults (b1 0.9, b2 0.999, eps 1e-8)."""

    def init(params):
        some = next(iter(params.values()))
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=some.device),
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()})

    def update(grads, state, params=None):
        names = list(grads)
        u, mu, nu, count = scale_by_adam(
            _lists(grads, names), _lists(state.mu, names),
            _lists(state.nu, names), state.count)
        return (dict(zip(names, torch._foreach_mul(u, -learning_rate))),
                AdamState(count, dict(zip(names, mu)), dict(zip(names, nu))))

    return GradientTransformation(init, update)


def apply_updates(params: dict, updates: dict) -> dict:
    """optax.apply_updates: p + u for every key of ``updates``."""
    names = list(updates)
    new = torch._foreach_add(_lists(params, names), _lists(updates, names))
    return {**params, **dict(zip(names, new))}
