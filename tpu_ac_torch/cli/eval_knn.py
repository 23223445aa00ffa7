"""k-NN evaluation CLI (port of ``tpu_ac.cli.eval_knn``; dino-main/
eval_knn.py rebuilt).

Extracts the features of the train/ and val/ ImageFolder splits with a
(DINO) backbone, the ViT's CLS token or the mean of the ResNet's layer4,
and reports the weighted k-NN top-1/top-5 for each k.  The backbone runs
under ``precision_scope("default")`` (TF32 on the card, ``tpu_ac``'s
``Precision.DEFAULT``); the vote with TF32 off.

    python -m tpu_ac_torch.cli.eval_knn --data_path DIR [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpu_ac_torch.data.imagefolder import ImageFolder
from tpu_ac_torch.data.mvtec import load_image_uint8
from tpu_ac_torch.data.prefetch import parallel_decode
from tpu_ac_torch.device import resolve_device
from tpu_ac_torch.models.registry import load_backbone
from tpu_ac_torch.train.evals import (
    eval_mesh,
    extract_features,
    knn_classifier,
    make_embedder,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("k-NN evaluation (PyTorch port)")
    p.add_argument("--arch", default="dino_deitsmall16",
                   help="backbone registry name")
    p.add_argument("--data_path", required=True,
                   help="ImageFolder root with train/ and val/")
    p.add_argument("--nb_knn", nargs="+", type=int, default=[10, 20, 100, 200])
    p.add_argument("--temperature", type=float, default=0.07)
    p.add_argument("--batch_size_per_gpu", type=int, default=128)
    p.add_argument("--imagesize", type=int, default=224)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--dump_features", default=None)
    p.add_argument("--dp", type=int, default=0,
                   help="Split every extraction batch over a mesh of this "
                        "many devices and gather the features (the "
                        "reference's cross-rank extract + all_gather, "
                        "eval_knn.py:118-139); on the CPU the host "
                        "repeated. 0 = one device.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def load_split(root: str, imagesize: int):
    """(uint8 images [N, 3, S, S], labels, class count) of an ImageFolder:
    shorter edge to S * 256/224, centre crop S (decoded on threads)."""
    ds = ImageFolder(root)
    imgs = parallel_decode(
        [path for path, _ in ds.samples],
        lambda p: load_image_uint8(p, resize=int(imagesize * 256 / 224),
                                   imagesize=imagesize))
    labels = np.asarray([t for _, t in ds.samples])
    return imgs, labels, len(ds.class_to_idx)


def main(argv=None) -> dict[int, tuple[float, float]]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    model, _cfg, family = load_backbone(args.arch,
                                        checkpoint_dir=args.checkpoint_dir)
    model = model.to(dev)
    if family == "vit":
        def forward(m, x):
            return m.forward_cls(x)
    else:
        def forward(m, x):
            return m(x, taps=("layer4",))["layer4"].mean(dim=(2, 3))

    mesh = None
    if args.dp:
        if args.batch_size_per_gpu % args.dp:
            raise ValueError(f"batch size {args.batch_size_per_gpu} not "
                             f"divisible by --dp {args.dp}")
        mesh = eval_mesh(dev, args.dp)
    embed = make_embedder(model, forward, mesh)
    train_x, train_y, n_cls = load_split(
        os.path.join(args.data_path, "train"), args.imagesize)
    val_x, val_y, _ = load_split(
        os.path.join(args.data_path, "val"), args.imagesize)
    train_f = extract_features(embed, train_x, args.batch_size_per_gpu,
                               mesh=mesh, device=dev)
    val_f = extract_features(embed, val_x, args.batch_size_per_gpu,
                             mesh=mesh, device=dev)
    if args.dump_features:
        np.savez(args.dump_features, train=train_f, val=val_f,
                 train_labels=train_y, val_labels=val_y)
    # the bank and the queries go to the device once, for every k
    bank, bank_y, queries = (torch.from_numpy(a).to(dev)
                             for a in (train_f, train_y, val_f))
    results = {}
    for k in args.nb_knn:
        top1, top5 = knn_classifier(bank, bank_y, queries, val_y,
                                    k=min(k, len(train_y)),
                                    T=args.temperature, num_classes=n_cls)
        print(f"{k}-NN classifier result: Top1: {top1:.2f}, Top5: {top5:.2f}")
        results[k] = (top1, top5)
    return results


if __name__ == "__main__":
    main()
