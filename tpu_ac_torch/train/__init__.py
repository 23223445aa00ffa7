"""Training workloads (port of ``tpu_ac.train``): DINO self-supervised
pre-training and the SCAN stages (SimCLR pretext, SCAN clustering,
self-labeling)."""

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

from tpu_ac_torch.train.scan import (  # noqa: E402
    MemoryBank,
    SCANModelConfig,
    SCANTrainState,
    clustering_forward,
    confidence_based_ce,
    contrastive_forward,
    entropy,
    init_clustering_model,
    init_contrastive_model,
    init_train_state,
    make_scan_step,
    make_selflabel_step,
    make_simclr_step,
    scan_evaluate_heads,
    scan_loss,
    simclr_loss,
)

__all__ += [
    "SCANModelConfig",
    "SCANTrainState",
    "MemoryBank",
    "simclr_loss",
    "scan_loss",
    "confidence_based_ce",
    "entropy",
    "init_contrastive_model",
    "init_clustering_model",
    "contrastive_forward",
    "clustering_forward",
    "init_train_state",
    "make_simclr_step",
    "make_scan_step",
    "make_selflabel_step",
    "scan_evaluate_heads",
]
