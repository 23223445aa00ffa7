"""Determinism helpers (port of ``tpu_ac.utils.seeding``).

Seeds the host-side randomness (python, numpy) and torch's global
generator, and returns a ``torch.Generator`` where ``tpu_ac`` returns a
JAX key.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def fix_seeds(seed: int = 2023, with_generator: bool = True
              ) -> torch.Generator | None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if with_generator:
        return torch.Generator().manual_seed(seed)
    return None
