"""CLI stage 1: per-category alpha matrix + weighted embedding (port of
``tpu_ac.cli.main``): the same flags, defaults and output tree, plus
``--device`` (default ``cuda``; ``cpu`` must be asked for) and the image
sizes ``--resize`` and ``--imagesize`` (default 256 and 224, the sizes
``tpu_ac`` fixes; a backbone's patch must divide ``--imagesize``).

    python -m tpu_ac_torch.cli.main --path data/mvtec_ad --device cuda
"""

from __future__ import annotations

import argparse
import logging
import time

from tpu_ac_torch.data.mvtec import CLASSNAMES
from tpu_ac_torch.pipeline import (
    PipelineConfig,
    build_embedder_for_config,
    run_category_sweep,
)
from tpu_ac_torch.utils.profiling import maybe_profile

LOGGER = logging.getLogger("tpu_ac_torch.cli.main")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Calculating Matrix on MVTec AD (PyTorch)")
    p.add_argument("--path", default="data/mvtec_ad", type=str,
                   help="Path to the dataset.")
    p.add_argument("--backbone_names", nargs="+", default=["dino_vitbase8"],
                   help="Architecture.")
    p.add_argument("--layers_to_extract_from", nargs="+",
                   default=["blocks.10", "blocks.11"])
    p.add_argument("--pretrain_embed_dimension", default=2048, type=int)
    p.add_argument("--target_embed_dimension", default=4096, type=int)
    p.add_argument("--output_dir", default="outputs")
    p.add_argument("--patchsize", type=int, default=3)
    p.add_argument("--tau", type=float, default=1)
    p.add_argument("--train_ratio", type=float, default=1)
    p.add_argument("--supervised", default="unsupervised", type=str,
                   help="unsupervised | supervised | average | all")
    p.add_argument("--dataset", default="mvtec_ad", type=str)
    p.add_argument("--categories", nargs="+", default=None,
                   help="Subset of categories (default: all 15).")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--resize", type=int, default=256,
                   help="Shorter edge the images are resized to.")
    p.add_argument("--imagesize", type=int, default=224,
                   help="Side of the centre crop the backbone embeds "
                        "(448 for dinov2_vitg14_reg at DINOv2's anomaly "
                        "setting, with --resize 512).")
    p.add_argument("--checkpoint_dir", default=None,
                   help="Directory holding the released DINO .pth files.")
    p.add_argument("--profile", default=None, metavar="TRACE_DIR",
                   help="Write a torch.profiler chrome trace of the sweep "
                        "into TRACE_DIR; it carries the ac.* ranges of each "
                        "category (ac.prefetch_wait, ac.dispatch, ac.embed, "
                        "ac.alpha, ac.resolve, and the prefetch thread's "
                        "ac.load, ac.decode, ac.stage).")
    p.add_argument("--precision", default="bfloat16",
                   choices=["default", "highest", "bfloat16"],
                   help="Embed precision: 'bfloat16' (default) runs the "
                        "backbone in bf16; 'default' is f32 with TF32 "
                        "allowed; 'highest' is f32 with TF32 off.")
    p.add_argument("--alpha_precision", default="auto",
                   choices=["auto", "f32", "bf16c", "bf16"],
                   help="Distance-kernel precision (auto follows "
                        "--precision; bf16c = compensated hi/lo bf16).")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises.")
    return p


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    print("\n".join("%s: %s" % (k, str(v))
                    for k, v in sorted(vars(args).items())))

    modes = (["unsupervised", "supervised"] if args.supervised == "all"
             else [args.supervised])
    categories = args.categories or CLASSNAMES

    # multi-backbone layer syntax "<idx>.<layer>": like the reference, only
    # backbone_names[0]'s layers are used
    layers = args.layers_to_extract_from
    if len(args.backbone_names) > 1:
        coll = [[] for _ in args.backbone_names]
        for layer in layers:
            idx, rest = layer.split(".", 1)
            coll[int(idx)].append(rest)
        layers = coll[0]
        LOGGER.warning(
            "multiple backbones given; following the reference, only %s "
            "with layers %s is used", args.backbone_names[0], layers)

    for supervised in modes:
        cfg = PipelineConfig(
            backbone_name=args.backbone_names[0],
            layers=tuple(layers),
            pretrain_embed_dimension=args.pretrain_embed_dimension,
            target_embed_dimension=args.target_embed_dimension,
            patchsize=args.patchsize,
            tau=args.tau,
            train_ratio=args.train_ratio,
            supervised=supervised,
            resize=args.resize,
            imagesize=args.imagesize,
            batch_size=args.batch_size,
            precision=args.precision,
            alpha_precision=args.alpha_precision,
        )
        embedder = build_embedder_for_config(
            cfg, device=args.device, checkpoint_dir=args.checkpoint_dir)
        with maybe_profile(args.profile):
            t0 = time.time()
            for category, result in run_category_sweep(
                    args.path, list(categories), cfg, embedder,
                    output_dir=args.output_dir, dataset_name=args.dataset):
                LOGGER.info("%s [%s]: %d images -> %s (%.1fs)",
                            category, supervised,
                            len(result["anomaly_labels"]),
                            result.get("artifact_path"), time.time() - t0)
                t0 = time.time()


if __name__ == "__main__":
    main()
