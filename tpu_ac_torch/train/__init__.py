"""Training and evaluation workloads (port of ``tpu_ac.train``): DINO
self-supervised pre-training, the SCAN stages (SimCLR pretext, SCAN
clustering, self-labeling) and DINO's evaluation suite (k-NN, linear
probe, retrieval, Copydays, DAVIS label propagation)."""

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

from tpu_ac_torch.train.copy_detection import (  # noqa: E402
    CopydaysDataset,
    copydays_eval,
    extract_copydetect_features,
    gem_cls_features,
)
from tpu_ac_torch.train.evals import (  # noqa: E402
    PCA,
    LinearProbeState,
    compute_ap,
    compute_map,
    extract_features,
    image_retrieval_eval,
    knn_classifier,
    knn_predictions,
    make_linear_probe,
    multi_scale,
    probe_state_from_numpy,
    probe_state_to_numpy,
    retrieval_ranks,
    revisited_retrieval_eval,
)
from tpu_ac_torch.train.video_seg import (  # noqa: E402
    norm_mask,
    propagate_labels,
    propagate_video,
    restrict_neighborhood,
    to_one_hot,
)

__all__ += [
    "extract_features",
    "knn_classifier",
    "knn_predictions",
    "LinearProbeState",
    "make_linear_probe",
    "probe_state_from_numpy",
    "probe_state_to_numpy",
    "PCA",
    "compute_ap",
    "compute_map",
    "multi_scale",
    "retrieval_ranks",
    "revisited_retrieval_eval",
    "image_retrieval_eval",
    "CopydaysDataset",
    "gem_cls_features",
    "extract_copydetect_features",
    "copydays_eval",
    "restrict_neighborhood",
    "propagate_labels",
    "norm_mask",
    "to_one_hot",
    "propagate_video",
]
