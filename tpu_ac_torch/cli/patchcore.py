"""PatchCore detection CLI (port of ``tpu_ac.cli.patchcore``; reference
patchcore-inspection-main/bin/run_patchcore.py and
load_and_evaluate_patchcore.py): the same flags, defaults and
``results.csv``, plus ``--device`` (default ``cuda``; ``cpu`` must be asked
for).

    python -m tpu_ac_torch.cli.patchcore RESULTS --data_path MVTEC

Per category: fit PatchCore on the train split (or load a saved memory
bank with ``--load_path``), predict the test split, min-max normalize and
average the scores over the backbones, and score image AUROC, pixel AUROC,
the pixel AUROC of the anomalous images alone and, with
``--compute_pro``, the PRO.  Memory banks, IVF indexes and
``patchcore_params.json`` are ``tpu_ac``'s files: either package loads the
other's.  Images upload as uint8 and normalize on the device.  The trunk
runs as ``tpu_ac`` runs it: a ViT at full f32; any other family at its
``tpu_ac`` forward's own default (TF32 allowed on the card for a ResNet,
VGG, DenseNet, EfficientNet or ResNetV2, full f32 for the trunks whose
``trunk_precision`` is "highest"), with its tail at full f32.
``--save_segmentation_images`` writes each test image's image / ground
truth / heat-map figure under ``RESULTS/segmentation_images/<category>/``
(``viz.plot_segmentation_images``), as ``tpu_ac``'s does.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from tpu_ac_torch.data.mvtec import (
    CLASSNAMES,
    DatasetSplit,
    MVTecDataset,
    load_mask,
    normalize_on_device,
)
from tpu_ac_torch.detect import (
    ApproximateGreedyCoresetSampler,
    GreedyCoresetSampler,
    IdentitySampler,
    PatchCore,
    compute_imagewise_retrieval_metrics,
    compute_pixelwise_retrieval_metrics,
    compute_pro,
)
from tpu_ac_torch.device import precision_scope, resolve_device
from tpu_ac_torch.features.embedding import EmbedConfig, embed_features
from tpu_ac_torch.models.registry import load_backbone


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("PatchCore anomaly detection (PyTorch)")
    p.add_argument("results_path")
    p.add_argument("--gpu", nargs="*", default=None,
                   help="accepted for flag parity; the device is --device")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_group", default="group")
    p.add_argument("--log_project", default="project")
    p.add_argument("--save_segmentation_images", action="store_true",
                   help="save image / ground truth / heat-map figures per "
                        "test image (models/patchcore/utils.py:18-77)")
    p.add_argument("--compute_pro", action="store_true",
                   help="Also report the PRO score (per-region overlap AUC "
                        "at FPR<=0.3, Bergmann et al.) as a full_pro "
                        "column; off by default to keep the results.csv "
                        "schema the reference's.")
    p.add_argument("--save_patchcore_model", action="store_true")
    p.add_argument("--dp", type=int, default=None,
                   help="shard the exact scorer's memory bank over a mesh "
                        "of this many cards (get_mesh); results identical "
                        "to one device's")
    # model options (run_patchcore.py:240-315)
    p.add_argument("--backbone", "-b", action="append", dest="backbone_names",
                   default=None)
    p.add_argument("--layers_to_extract_from", "-le", action="append",
                   default=None)
    p.add_argument("--pretrain_embed_dimension", type=int, default=1024)
    p.add_argument("--target_embed_dimension", type=int, default=1024)
    p.add_argument("--patchsize", type=int, default=3)
    p.add_argument("--anomaly_scorer_num_nn", type=int, default=5)
    p.add_argument("--nn_method", default="exact",
                   choices=["exact", "ivfflat", "ivfpq"],
                   help="exact = FaissNN flat L2; ivfpq = the "
                        "ApproximateFaissNN IndexIVFPQ equivalent "
                        "(common.py:100-126).")
    # sampler options (run_patchcore.py:318-330)
    p.add_argument("--sampler_name", default="approx_greedy_coreset",
                   choices=["identity", "greedy_coreset",
                            "approx_greedy_coreset"])
    p.add_argument("--percentage", "-p", type=float, default=0.1)
    p.add_argument("--coreset_select_batch", type=int, default=1,
                   help="Picks per greedy-coreset iteration. 1 (default) = "
                        "the reference's exact sequential greedy; k>1 = "
                        "batched farthest-point selection (one matmul "
                        "folds k picks at once). Approximation: the k "
                        "picks of one iteration are not conditioned on "
                        "each other.")
    # dataset options (run_patchcore.py:333-429)
    p.add_argument("--data_path", required=True)
    p.add_argument("--subdatasets", "-d", action="append", default=None)
    p.add_argument("--resize", type=int, default=256)
    p.add_argument("--imagesize", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=8)
    # re-evaluation of saved models (load_and_evaluate_patchcore.py)
    p.add_argument("--load_path", default=None,
                   help="Load saved memory banks instead of fitting.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises.")
    return p


def _make_sampler(name: str, percentage: float, seed: int,
                  select_batch: int = 1):
    if name == "identity":
        return IdentitySampler()
    if name == "greedy_coreset":
        return GreedyCoresetSampler(percentage, seed=seed,
                                    select_batch=select_batch)
    return ApproximateGreedyCoresetSampler(percentage, seed=seed,
                                           select_batch=select_batch)


def make_embed_fn(model, family: str, ecfg: EmbedConfig):
    """[B, 3, H, W] uint8 (or normalized float) batch on the model's device
    -> [B, P, D] f32 patch features."""
    # tpu_ac runs a ViT at HIGHEST and every other trunk at its forward's
    # own default; those set ``trunk_precision`` where it is HIGHEST and
    # turn TF32 off for their tail themselves
    scope = "highest" if family == "vit" else "default"

    def embed(images: torch.Tensor) -> torch.Tensor:
        if images.dtype == torch.uint8:
            images = normalize_on_device(images)
        with precision_scope(scope), torch.inference_mode():
            return embed_features(family, model, images, ecfg).float()

    return embed


def _build_patchcore(backbone_name: str, layers, args) -> PatchCore:
    device = resolve_device(args.device)
    model, _cfg, family = load_backbone(backbone_name)
    ecfg = EmbedConfig(
        layers=tuple(layers),
        pretrain_embed_dimension=args.pretrain_embed_dimension,
        target_embed_dimension=args.target_embed_dimension,
        patchsize=args.patchsize,
        apply_layernorm=False)  # upstream PatchCore patchifies raw features
    mesh = None
    if args.dp:
        from tpu_ac_torch.distributed import get_mesh

        mesh = get_mesh(args.dp)
    return PatchCore(
        make_embed_fn(model.to(device), family, ecfg),
        featuresampler=_make_sampler(args.sampler_name, args.percentage,
                                     args.seed, args.coreset_select_batch),
        anomaly_score_num_nn=args.anomaly_scorer_num_nn,
        nn_method=args.nn_method, mesh=mesh,
        target_size=(args.imagesize, args.imagesize),
        batch_size=args.batch_size, device=device,
        config={"backbone": backbone_name, "layers": list(layers),
                "pretrain_embed_dimension": args.pretrain_embed_dimension,
                "target_embed_dimension": args.target_embed_dimension,
                "patchsize": args.patchsize})


def _minmax(x: np.ndarray) -> np.ndarray:
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def run(args) -> list[dict]:
    backbones = args.backbone_names or ["wideresnet50"]
    layers = args.layers_to_extract_from or ["layer2", "layer3"]
    subdatasets = args.subdatasets or CLASSNAMES
    os.makedirs(args.results_path, exist_ok=True)

    result_rows = []
    for category in subdatasets:
        test_ds = MVTecDataset(args.data_path, classname=category,
                               resize=args.resize, imagesize=args.imagesize,
                               split=DatasetSplit.TEST)
        test_images = test_ds.load_all_images()
        labels = np.asarray([it.is_anomaly for it in test_ds.items])
        masks = np.stack([
            load_mask(it.mask_path, args.resize, args.imagesize)[0] > 0.5
            for it in test_ds.items])

        all_scores, all_segs = [], []
        for backbone_name in backbones:
            pc = _build_patchcore(backbone_name, layers, args)
            if args.load_path:
                pc.load_from_path(os.path.join(args.load_path, category),
                                  prepend=backbone_name + "_")
            else:
                train_ds = MVTecDataset(args.data_path, classname=category,
                                        resize=args.resize,
                                        imagesize=args.imagesize,
                                        split=DatasetSplit.TRAIN)
                pc.fit(train_ds.load_all_images())
            scores, segs = pc.predict(test_images)
            # ensemble min-max normalization (run_patchcore.py:114-132)
            all_scores.append(_minmax(scores))
            all_segs.append(_minmax(segs))
            if args.save_patchcore_model and not args.load_path:
                d = os.path.join(args.results_path, "models", category)
                os.makedirs(d, exist_ok=True)
                pc.save_to_path(d, prepend=backbone_name + "_")

        scores = np.mean(all_scores, axis=0)
        segs = np.mean(all_segs, axis=0)
        image_metrics = compute_imagewise_retrieval_metrics(scores, labels)
        full_pro = float("nan")
        if masks.any():
            pixel_auroc = compute_pixelwise_retrieval_metrics(
                segs, masks)["auroc"]
            # pixel AUROC of the anomalous images alone
            # (run_patchcore.py:187-196 selects masks with np.sum > 0)
            sel = masks.reshape(len(masks), -1).any(axis=1)
            anomaly_pixel_auroc = compute_pixelwise_retrieval_metrics(
                segs[sel], masks[sel])["auroc"]
            if args.compute_pro:
                full_pro = compute_pro(segs, masks)
        else:
            pixel_auroc = float("nan")
            anomaly_pixel_auroc = float("nan")
        if args.save_segmentation_images:
            from tpu_ac_torch.viz import plot_segmentation_images

            plot_segmentation_images(
                os.path.join(args.results_path, "segmentation_images",
                             category),
                [it.image_path for it in test_ds.items], segs,
                anomaly_scores=scores,
                mask_paths=[it.mask_path for it in test_ds.items])
        row = {"dataset_name": f"mvtec_{category}",
               "instance_auroc": image_metrics["auroc"],
               "full_pixel_auroc": pixel_auroc,
               "anomaly_pixel_auroc": anomaly_pixel_auroc}
        if args.compute_pro:
            row["full_pro"] = full_pro
        print(f"{category}: image AUROC {row['instance_auroc']:.4f} "
              f"pixel AUROC {row['full_pixel_auroc']:.4f} "
              f"anomaly-pixel AUROC {row['anomaly_pixel_auroc']:.4f}"
              + (f" PRO {row['full_pro']:.4f}" if args.compute_pro else ""))
        result_rows.append(row)

    _store_results(args.results_path, result_rows)
    return result_rows


def _store_results(results_path: str, rows: list[dict]) -> None:
    """compute_and_store_final_results (models/patchcore/utils.py:130-178):
    per-dataset rows + a mean row, written as results.csv."""
    if not rows:
        return
    keys = [k for k in rows[0] if k != "dataset_name"]
    mean_row = {"dataset_name": "Mean",
                **{k: float(np.nanmean([r[k] for r in rows])) for k in keys}}
    with open(os.path.join(results_path, "results.csv"), "w",
              newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["dataset_name"] + keys)
        writer.writeheader()
        for row in rows + [mean_row]:
            writer.writerow(row)


def main(argv=None) -> list[dict]:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
