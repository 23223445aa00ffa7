"""Training workloads (port of ``tpu_ac.train``): DINO self-supervised
pre-training.  The SCAN half of ``tpu_ac.train`` is not ported yet
(ROADMAP Queue 1 item 12)."""

from tpu_ac_torch.train.dino import (
    DINOConfig,
    DINOTrainState,
    cosine_scheduler,
    dino_loss,
    init_dino_state,
    make_dino_multi_step,
    make_dino_train_step,
    make_schedules,
    make_step_schedule_tables,
)

__all__ = [
    "DINOConfig",
    "DINOTrainState",
    "init_dino_state",
    "make_dino_multi_step",
    "make_dino_train_step",
    "make_schedules",
    "make_step_schedule_tables",
    "cosine_scheduler",
    "dino_loss",
]
