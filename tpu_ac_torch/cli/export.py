"""AOT serving-export CLI (port of ``tpu_ac.cli.export``): serialize the
embed + alpha+X programs with ``torch.export`` into an artifact that
``scripts/serving_host_torch.py`` serves without tpu_ac_torch.

    python -m tpu_ac_torch.cli.export --n_images 96 --dump_params params.npy

``tpu_ac``'s flags, plus ``--device`` (default ``cuda``; ``cpu`` must be
asked for).  Run it on the card to carry the min_dists kernel library in
the artifact.  The params dump is the numpy dict of the embedder's model
with its torch key names, as ``tpu_ac``'s CLI writes it, in float32 (a
bfloat16 embedder's values upcast exactly; the serving host casts them
back to ``meta["param_dtype"]``).  ``--dp N`` exports the per-rank programs
of an N-rank mesh; they name no card, so the export traces them on
``--device`` and the serving host places the ranks (``--devices``).
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from tpu_ac_torch.distributed import Mesh
from tpu_ac_torch.pipeline import PipelineConfig, build_embedder_for_config
from tpu_ac_torch.utils.export import (
    export_category_programs,
    export_sharded_category_programs,
    save_exported,
)

LOGGER = logging.getLogger("tpu_ac_torch.cli.export")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("AOT serving export (torch.export)")
    p.add_argument("--backbone_name", default="dino_vitbase8")
    p.add_argument("--layers_to_extract_from", nargs="+",
                   default=["blocks.10", "blocks.11"])
    p.add_argument("--pretrain_embed_dimension", default=2048, type=int)
    p.add_argument("--target_embed_dimension", default=4096, type=int)
    p.add_argument("--patchsize", type=int, default=3)
    p.add_argument("--tau", type=float, default=1)
    p.add_argument("--supervised", default="unsupervised",
                   choices=["unsupervised", "supervised"])
    p.add_argument("--imagesize", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--precision", default="default",
                   choices=["default", "highest", "bfloat16"])
    p.add_argument("--n_images", type=int, default=32,
                   help="alpha capacity: category sizes up to this serve "
                        "from one artifact (padded to the 32-bucket)")
    p.add_argument("--n_train_images", type=int, default=None,
                   help="supervised-mode train-bank capacity (own bucket, "
                        "independent of --n_images). Default: --n_images")
    p.add_argument("--dump_params", default=None,
                   help="also save the embedder's params as a .npy dict "
                        "here (the serving host's --params input)")
    p.add_argument("--platforms", nargs="+", default=None,
                   choices=["cpu", "cuda"],
                   help="platforms to trace the programs for, one program "
                        "each (default: --device's)")
    p.add_argument("--dp", type=int, default=None,
                   help="export the programs of a dp-rank mesh (the "
                        "serving host places the ranks); default = "
                        "single-device programs")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--output", default="category_serving.tpuac")
    p.add_argument("--device", default="cuda",
                   help="device the embedder is built and traced on "
                        "(cuda, or cpu)")
    return p


def main(argv=None) -> str:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    cfg = PipelineConfig(
        backbone_name=args.backbone_name,
        layers=tuple(args.layers_to_extract_from),
        pretrain_embed_dimension=args.pretrain_embed_dimension,
        target_embed_dimension=args.target_embed_dimension,
        patchsize=args.patchsize, tau=args.tau,
        supervised=args.supervised, imagesize=args.imagesize,
        batch_size=args.batch_size, precision=args.precision)
    platforms = tuple(args.platforms) if args.platforms else None
    mesh = Mesh([args.device] * args.dp) if args.dp else None
    embedder = build_embedder_for_config(
        cfg, device=args.device, checkpoint_dir=args.checkpoint_dir,
        mesh=mesh)
    export = export_sharded_category_programs if args.dp \
        else export_category_programs
    blob = export(embedder, cfg, n_images=args.n_images,
                  n_train_images=args.n_train_images, platforms=platforms)
    path = save_exported(args.output, blob)
    if args.dump_params:
        np.save(args.dump_params,
                {k: v.to(torch.float32).cpu().numpy()
                 for k, v in embedder._model.state_dict().items()},
                allow_pickle=True)
        LOGGER.info("wrote params to %s", args.dump_params)
    LOGGER.info("wrote %s (platforms=%s, capacity=%d)", path,
                blob["meta"]["platforms"], blob["meta"]["n_images_capacity"])
    print(path)
    return path


if __name__ == "__main__":
    main()
