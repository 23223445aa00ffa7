"""Checkpoint/resume, metric logging, profiling and seeding (port of
``tpu_ac.utils``)."""

from tpu_ac_torch.utils.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from tpu_ac_torch.utils.logging import (
    LaggedFetch,
    MetricLogger,
    SmoothedValue,
    StepTimer,
)
from tpu_ac_torch.utils.seeding import fix_seeds

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_checkpoint",
    "LaggedFetch",
    "MetricLogger",
    "SmoothedValue",
    "StepTimer",
    "fix_seeds",
]
