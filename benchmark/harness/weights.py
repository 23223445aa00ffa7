"""Weights made on the device from the seed.

A reference module's ``param_spec(arch)`` lists every tensor of the
backbone's state dict as (name, shape, std, mean): a draw of
``mean + std * N(0, 1)`` (std 0: the constant ``mean``).  All the draws
come from one ``torch.randn`` on the device, from a ``torch.Generator``
seeded with the run's seed, and each tensor is cast to the type it is
served in.  The program's module and the reference get the same tensors.
"""

from __future__ import annotations

import math

import torch

from benchmark.harness.traffic import SEED_MOD


def make_weights(spec, seed: int, device, dtype: torch.dtype
                 ) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % SEED_MOD)
    drawn = [(n, s) for n, s, std, _ in spec if std]
    total = sum(math.prod(s) for _, s in drawn)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std, mean in spec:
        if std:
            k = math.prod(shape)
            t = flat[off:off + k].view(shape) * std + mean
            off += k
            out[name] = t.to(dtype)
        else:
            out[name] = torch.full(shape, float(mean), dtype=dtype,
                                   device=device)
    return out
