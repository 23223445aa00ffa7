"""PatchCore anomaly detection (port of ``tpu_ac.detect``): coreset
subsampling, the exact and IVF k-NN memory-bank scorers, score
rescale/segmentation, and AUROC/PRO metrics without sklearn."""

from tpu_ac_torch.detect.approx import (
    ApproximateNearestNeighbourScorer,
    IVFFlatIndex,
    IVFPQIndex,
    kmeans,
)
from tpu_ac_torch.detect.metrics import (
    compute_imagewise_retrieval_metrics,
    compute_pixelwise_retrieval_metrics,
    compute_pro,
)
from tpu_ac_torch.detect.patchcore import PatchCore
from tpu_ac_torch.detect.sampler import (
    ApproximateGreedyCoresetSampler,
    GreedyCoresetSampler,
    IdentitySampler,
    RandomSampler,
)
from tpu_ac_torch.detect.scorer import NearestNeighbourScorer
from tpu_ac_torch.detect.segmentor import RescaleSegmentor

__all__ = [
    "IdentitySampler",
    "RandomSampler",
    "GreedyCoresetSampler",
    "ApproximateGreedyCoresetSampler",
    "NearestNeighbourScorer",
    "RescaleSegmentor",
    "compute_imagewise_retrieval_metrics",
    "compute_pixelwise_retrieval_metrics",
    "compute_pro",
    "PatchCore",
    "IVFFlatIndex",
    "IVFPQIndex",
    "ApproximateNearestNeighbourScorer",
    "kmeans",
]
