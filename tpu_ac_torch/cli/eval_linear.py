"""Linear-probe evaluation CLI (port of ``tpu_ac.cli.eval_linear``;
dino-main/eval_linear.py rebuilt).

Trains an SGD linear classifier on frozen backbone features (final-norm'd
CLS of the last n blocks, optionally with avg-pooled patch tokens — the
reference's ``avgpool_patchtokens`` for ViT-Base, eval_linear.py:56-63)
and reports top-1 on the val split.  The features stay on the device; the
backbone runs under ``precision_scope("default")``.

    python -m tpu_ac_torch.cli.eval_linear --data_path DIR [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpu_ac_torch.cli.eval_knn import load_split
from tpu_ac_torch.data.classification import (
    num_shuffled_batches,
    shuffled_batches,
)
from tpu_ac_torch.device import resolve_device
from tpu_ac_torch.models.registry import load_backbone
from tpu_ac_torch.train.dino import cosine_scheduler
from tpu_ac_torch.train.evals import (
    eval_mesh,
    extract_features,
    make_embedder,
    make_linear_probe,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Linear probe (PyTorch port)")
    p.add_argument("--arch", default="dino_deitsmall16")
    p.add_argument("--n_last_blocks", type=int, default=4)
    p.add_argument("--avgpool_patchtokens", action="store_true")
    p.add_argument("--data_path", required=True)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--batch_size_per_gpu", type=int, default=256)
    p.add_argument("--imagesize", type=int, default=224)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--dp", type=int, default=0,
                   help="Split feature extraction AND probe training over "
                        "a mesh of this many devices (the reference "
                        "DDP-wraps the linear classifier, eval_linear.py:"
                        "62); on the CPU the host repeated. 0 = one device.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> float:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    model, _cfg, family = load_backbone(args.arch,
                                        checkpoint_dir=args.checkpoint_dir)
    if family != "vit":
        raise SystemExit("the linear probe CLI drives ViT backbones")
    model = model.to(dev)
    n = args.n_last_blocks

    def forward(m, x):
        outs = m.intermediate_layers(x, n)
        feats = torch.cat([o[:, 0] for o in outs], dim=-1)
        if args.avgpool_patchtokens:
            feats = torch.cat([feats, outs[-1][:, 1:].mean(dim=1)], dim=-1)
        return feats

    mesh = None
    if args.dp:
        if args.batch_size_per_gpu % args.dp:
            raise ValueError(f"batch size {args.batch_size_per_gpu} not "
                             f"divisible by --dp {args.dp}")
        mesh = eval_mesh(dev, args.dp)
    embed = make_embedder(model, forward, mesh)

    def split(name):
        imgs, labels, n_cls = load_split(os.path.join(args.data_path, name),
                                         args.imagesize)
        feats = extract_features(embed, imgs, args.batch_size_per_gpu,
                                 normalize=False, mesh=mesh, device=dev)
        return torch.from_numpy(feats).to(dev), labels, n_cls

    train_f, train_y, n_cls = split("train")
    val_f, val_y, _ = split("val")
    train_y_dev = torch.from_numpy(train_y).to(dev)

    state, step, predict = make_linear_probe(train_f.shape[1], n_cls,
                                             lr=args.lr, mesh=mesh,
                                             device=dev)
    # one copy of the dp batch rules: shuffled_batches trims every batch
    # (incl. the smaller-than-batch fallback) to the dp multiple
    multiple = args.dp or 1
    steps_per_epoch = num_shuffled_batches(len(train_y),
                                           args.batch_size_per_gpu,
                                           multiple_of=multiple)
    lr_table = cosine_scheduler(args.lr, 0.0, args.epochs * steps_per_epoch)
    it = 0
    acc = float("nan")
    for epoch in range(args.epochs):
        # the epoch's batches go to the device in one copy (a pageable
        # copy a step would wait for the device's queue)
        idx = torch.from_numpy(np.stack(list(shuffled_batches(
            len(train_y), args.batch_size_per_gpu, seed=epoch,
            multiple_of=multiple)))).to(dev)
        for row in idx:
            state, loss = step(state, train_f.index_select(0, row),
                               train_y_dev.index_select(0, row),
                               float(lr_table[min(it, len(lr_table) - 1)]))
            it += 1
        if epoch % 10 == 0 or epoch == args.epochs - 1:
            preds = predict(state, val_f).argmax(dim=1).cpu().numpy()
            acc = 100.0 * np.mean(preds == val_y)
            print(f"epoch {epoch}: val top-1 {acc:.2f}% "
                  f"(loss {float(loss):.4f})")
    return acc


if __name__ == "__main__":
    main()
