"""CLI stage 2: clustering + metrics + tau-sweep CSV (port of
``tpu_ac.cli.evaluate``).

Loads the (alpha, X) pickles of stage 1, runs agglomerative clustering and
Hungarian relabeling per category, and writes the tau-sweep CSV with the
category-size-weighted MVTec(object)/MVTec(texture) rows.  Host-only work:
no device is used.  ``--visualize`` saves per-anomaly-type alpha heat maps
during the sweep (``viz.plots.visualize_sweep_alpha``) under
``<output_dir>/<dataset>/visualize/<run-name>/``, as ``tpu_ac``'s does.
"""

from __future__ import annotations

import argparse
import csv
import os

from tpu_ac_torch.data.mvtec import DatasetSplit, MVTecDataset
from tpu_ac_torch.pipeline import (
    PipelineConfig,
    artifact_dir,
    category_metrics,
    load_alpha_X,
)

_OBJECT = ["bottle", "cable", "capsule", "hazelnut", "metal_nut",
           "pill", "screw", "toothbrush", "transistor", "zipper"]
_TEXTURE = ["carpet", "grid", "leather", "tile", "wood"]

DEFAULT_TAU_LIST = [0, 0.2, 0.4, 0.6, 0.8, 1, 1.5, 2, 2.5, 3, 4, 8, 10, 12,
                    14, 18, 20]


def category_labels(source: str, category: str) -> list[str]:
    ds = MVTecDataset(source, classname=category, split=DatasetSplit.TEST)
    return [it.anomaly for it in ds.items]


def export_alpha_heatmaps(pickle_path: str, source: str, category: str,
                          args, supervised: str, tau) -> list[str]:
    """--visualize: per-anomaly-type alpha heatmaps during the sweep
    (examples/test.py:158-174); saved under
    <output_dir>/<dataset>/visualize/<run-name>/."""
    from tpu_ac_torch.viz.plots import visualize_sweep_alpha

    alpha, _x = load_alpha_X(pickle_path)
    alpha = alpha[:, 0] if alpha.ndim == 3 else alpha
    ds = MVTecDataset(source, classname=category, split=DatasetSplit.TEST)
    run_name = (f"{args.backbone_names[0]}_{args.pretrain_embed_dimension}_"
                f"{args.target_embed_dimension}_"
                + "_".join(args.layers_to_extract_from)
                + f"_{float(tau)}_{supervised}")
    out_dir = os.path.join(args.output_dir, args.dataset, "visualize",
                           run_name)
    return visualize_sweep_alpha(alpha, ds.items, out_dir)


def evaluate_category(pickle_path: str, anomaly_labels: list[str]
                      ) -> tuple[dict, int]:
    """One calculate_metrics call: returns (scores, n_kept)."""
    _alpha, X = load_alpha_X(pickle_path)
    n_kept = sum(1 for a in anomaly_labels if a != "combined")
    return category_metrics(X, anomaly_labels), n_kept


def run_sweep(args) -> None:
    for supervised in args.supervised_modes:
        out_path = os.path.join(args.output_dir, args.dataset,
                                args.backbone_names[0], supervised)
        os.makedirs(out_path, exist_ok=True)
        fname = ("_".join(args.layers_to_extract_from) +
                 f"_{args.pretrain_embed_dimension}"
                 f"_{args.target_embed_dimension}_tau_result.csv")
        encoding = "gbk" if args.gbk else "utf-8"
        label_cache: dict[str, list[str]] = {}
        with open(os.path.join(out_path, fname), "w", newline="",
                  encoding=encoding) as f:
            writer = csv.writer(f)
            writer.writerow([supervised])
            writer.writerow(["Category", "NMI", "ARI", "F1"])
            for tau in args.tau_list:
                writer.writerow(["---"] * 4)
                writer.writerow([f"TAU={tau}"])
                agg = {"object": [0.0, 0.0, 0.0, 0],
                       "texture": [0.0, 0.0, 0.0, 0]}
                for split_name, cats in (("object", _OBJECT),
                                         ("texture", _TEXTURE)):
                    for category in cats:
                        if args.categories and \
                                category not in args.categories:
                            continue
                        cfg = PipelineConfig(
                            backbone_name=args.backbone_names[0],
                            layers=tuple(args.layers_to_extract_from),
                            pretrain_embed_dimension=(
                                args.pretrain_embed_dimension),
                            target_embed_dimension=args.target_embed_dimension,
                            tau=tau, train_ratio=args.train_ratio,
                            supervised=supervised)
                        d = artifact_dir(args.output_dir, args.dataset,
                                         args.backbone_names[0], supervised,
                                         cfg)
                        p = os.path.join(
                            d, f"matrix_alpha_X_{category}_{supervised}"
                               ".pickle")
                        if not os.path.exists(p):
                            continue
                        if category not in label_cache:
                            label_cache[category] = category_labels(
                                args.path, category)
                        if args.visualize:
                            for fp in export_alpha_heatmaps(
                                    p, args.path, category, args,
                                    supervised, tau):
                                print(f"{fp} saved.")
                        scores, n = evaluate_category(p, label_cache[category])
                        print(f"{category} tau={tau} {supervised}: {scores}")
                        writer.writerow([category, scores["NMI"],
                                         scores["ARI"], scores["F1"]])
                        a = agg[split_name]
                        a[0] += scores["NMI"] * n
                        a[1] += scores["ARI"] * n
                        a[2] += scores["F1"] * n
                        a[3] += n
                for split_name in ("object", "texture"):
                    nmi, ari, f1, total = agg[split_name]
                    if total:
                        writer.writerow([f"MVTec({split_name})", nmi / total,
                                         ari / total, f1 / total])
                        print(f"MVTec({split_name}) tau={tau}: "
                              f"NMI={nmi / total:.5f} ARI={ari / total:.5f} "
                              f"F1={f1 / total:.5f}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("MVTec AD clustering metrics (PyTorch)")
    p.add_argument("--path", default="data/mvtec_ad")
    p.add_argument("--output_dir", default="outputs")
    p.add_argument("--dataset", default="mvtec_ad")
    p.add_argument("--backbone_names", nargs="+", default=["dino_vitbase8"])
    p.add_argument("--layers_to_extract_from", nargs="+",
                   default=["blocks.10", "blocks.11"])
    p.add_argument("--pretrain_embed_dimension", default=2048, type=int)
    p.add_argument("--target_embed_dimension", default=4096, type=int)
    p.add_argument("--train_ratio", default=1.0, type=float)
    p.add_argument("--tau_list", nargs="+", type=float,
                   default=DEFAULT_TAU_LIST)
    p.add_argument("--supervised_modes", nargs="+",
                   default=["unsupervised", "supervised"])
    p.add_argument("--categories", nargs="+", default=None)
    p.add_argument("--gbk", action="store_true",
                   help="Write the CSV GBK-encoded like the reference.")
    p.add_argument("--visualize", action="store_true",
                   help="Export per-anomaly-type alpha heatmap figures "
                        "during the sweep (examples/test.py:158-174).")
    return p


def main(argv=None) -> None:
    run_sweep(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
