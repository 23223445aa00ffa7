"""Data layer (port of ``tpu_ac.data``): MVTec AD and the eval datasets,
host-side numpy/PIL loaders."""

from tpu_ac_torch.data.mvtec import (
    CLASSNAMES,
    IMAGENET_MEAN,
    IMAGENET_STD,
    DatasetSplit,
    MVTecDataset,
    load_image_uint8,
    make_synthetic_mvtec,
)
from tpu_ac_torch.data.oxford_paris import (
    OxfordParisDataset,
    make_synthetic_roxford,
    revisited_splits,
)

__all__ = [
    "CLASSNAMES",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "DatasetSplit",
    "MVTecDataset",
    "load_image_uint8",
    "make_synthetic_mvtec",
    "OxfordParisDataset",
    "make_synthetic_roxford",
    "revisited_splits",
]
