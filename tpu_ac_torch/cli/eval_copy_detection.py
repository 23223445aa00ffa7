"""Copy-detection CLI (port of ``tpu_ac.cli.eval_copy_detection``;
dino-main/eval_copy_detection.py rebuilt).

Runs the Copydays protocol: query blocks (original/strong/jpegqual/crops)
against the original database, optional distractor merging and whitening
learned on a held-out image directory, CLS+GeM(4) features, cosine top-20,
per-block mAP.  The backbone runs under ``precision_scope("default")``.

    python -m tpu_ac_torch.cli.eval_copy_detection --data_path DIR \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from tpu_ac_torch.data.prefetch import parallel_decode
from tpu_ac_torch.device import resolve_device
from tpu_ac_torch.models.registry import load_backbone
from tpu_ac_torch.train.copy_detection import (
    CopydaysDataset,
    copydays_eval,
    extract_copydetect_features,
    is_image_file,
)
from tpu_ac_torch.train.evals import eval_mesh, make_embedder


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Copy detection on Copydays (PyTorch port)")
    p.add_argument("--data_path", required=True,
                   help="Copydays root (original/strong/jpegqual/crops)")
    p.add_argument("--whitening_path", default="",
                   help="Directory of images for the whitening operator "
                        "(eval_copy_detection.py:210-213).")
    p.add_argument("--distractors_path", default="",
                   help="Directory of distractor images merged into the "
                        "database (eval_copy_detection.py:214-215).")
    p.add_argument("--imsize", default=320, type=int)
    p.add_argument("--batch_size_per_gpu", default=16, type=int)
    p.add_argument("--arch", default="dino_vitbase8",
                   help="backbone registry name")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--dp", action="store_true",
                   help="split every extraction batch over every visible "
                        "card (on the CPU, the host repeated) and gather "
                        "the features (the reference's DistributedSampler "
                        "+ cross-rank all_gather, eval_copy_detection.py:"
                        "162,186-194). batch_size_per_gpu is rounded up "
                        "to a multiple of the mesh size.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def load_dir_images(path: str, imsize: int) -> np.ndarray:
    names = [os.path.join(path, s) for s in sorted(os.listdir(path))
             if is_image_file(s)]
    return load_paths(names, imsize)


def load_paths(paths: list[str], imsize: int) -> np.ndarray:
    """uint8 [N, 3, imsize, imsize]: the reference's Resize((imsize,
    imsize)), a SQUARE resize with no crop (eval_copy_detection.py:
    154-158), decoded on threads; normalized on the device."""
    def one(p):
        img = Image.open(p).convert("RGB").resize((imsize, imsize),
                                                  Image.BILINEAR)
        return np.asarray(img, np.uint8).transpose(2, 0, 1)

    return parallel_decode(paths, one)


def main(argv=None) -> dict[str, float]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    model, _cfg, family = load_backbone(args.arch,
                                        checkpoint_dir=args.checkpoint_dir)
    if family != "vit":
        raise SystemExit(f"Architecture {args.arch} non supported")
    model = model.to(dev)

    mesh = None
    batch = args.batch_size_per_gpu
    if args.dp:
        mesh = eval_mesh(dev)
        batch = -(-batch // mesh.size) * mesh.size
    tokens = make_embedder(model,
                           lambda m, x: m.intermediate_layers(x, 1)[0], mesh)

    def extract(imgs):
        return extract_copydetect_features(tokens, imgs, batch, mesh=mesh,
                                           device=dev)

    dataset = CopydaysDataset(args.data_path)
    qpaths, block_sizes = dataset.query_paths()
    queries = extract(load_paths(qpaths, args.imsize))
    print(f"Extraction of queries features done. Shape: {queries.shape}")
    database = extract(load_paths(dataset.database_paths(), args.imsize))

    distractors = None
    if args.distractors_path and os.path.isdir(args.distractors_path):
        print("Using distractors...")
        distractors = extract(
            load_dir_images(args.distractors_path, args.imsize))
    whitening = None
    if args.whitening_path and os.path.isdir(args.whitening_path):
        print(f"Extracting features on images from {args.whitening_path} "
              "for learning the whitening operator.")
        whitening = extract(
            load_dir_images(args.whitening_path, args.imsize))

    results = copydays_eval(queries, database, dataset, block_sizes,
                            distractor_features=distractors,
                            whitening_features=whitening, device=dev)
    for block, m_ap in results.items():
        print(f"eval on {block} mAP={m_ap:.3f}")
    return results


if __name__ == "__main__":
    main()
