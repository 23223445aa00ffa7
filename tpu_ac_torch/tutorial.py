"""Runnable SCAN tutorial (port of the repository's root ``tutorial.py``;
Unsupervised-Classification-master/tutorial_nn.py:29-99 + TUTORIAL.md).

Loads a pretext (SimCLR) model, fills a MemoryBank with train and val
features, mines the top-20 / top-5 nearest neighbors, reports neighbor
accuracy, and saves the index files the SCAN stage consumes.

Zero-argument mode runs end-to-end on a synthetic clusterable dataset with
a randomly initialized backbone (resuming the pretext checkpoint when one
exists), so the walkthrough is executable anywhere with a card; pass
``--device cpu`` to run it on the host:

    python -m tpu_ac_torch.tutorial [--device cpu]
    python -m tpu_ac_torch.tutorial --config_env configs/env.yml \
        --config_exp configs/pretext/simclr_cifar-10.yml
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Eval_nn (PyTorch)")
    parser.add_argument("--config_env", default=None,
                        help="Config file for the environment")
    parser.add_argument("--config_exp", default=None,
                        help="Config file for the experiment")
    parser.add_argument("--out_dir", default=None,
                        help="Where to write the neighbor .npy files "
                             "(defaults to the config's pretext dir, or "
                             "./tutorial_out in synthetic mode)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    from tpu_ac_torch.cli.scan import (STAGE_PRECISION, _load_dataset,
                                       _model_config)
    from tpu_ac_torch.data.augment import ValTransform
    from tpu_ac_torch.device import precision_scope, resolve_device
    from tpu_ac_torch.train.scan import (
        MemoryBank,
        contrastive_forward,
        init_contrastive_model,
    )
    from tpu_ac_torch.utils.checkpoint import (latest_checkpoint,
                                               restore_checkpoint)

    dev = resolve_device(args.device)
    # ---- Retrieve config (utils/config.py create_config equivalent)
    if args.config_env and args.config_exp:
        from tpu_ac_torch.config import create_config

        cfg = create_config(args.config_env, args.config_exp)
        out_dir = args.out_dir or cfg.pretext_dir
    else:
        from tpu_ac_torch.config import Config

        cfg = Config({"train_db_name": "synthetic", "num_classes": 4,
                      "image_size": 32, "batch_size": 32,
                      "synthetic_per_class": 24})
        out_dir = args.out_dir or "./tutorial_out"
    os.makedirs(out_dir, exist_ok=True)
    print(f"config: {dict(cfg)}")

    # ---- Model (ContrastiveModel equivalent)
    mcfg = _model_config(cfg)
    params, bn = init_contrastive_model(cfg.get("seed", 0), mcfg, dev)
    n_params = sum(v.numel() for v in params.values())
    print(f"Model is ContrastiveModel "
          f"({type(mcfg.backbone).__name__}); "
          f"parameters: {n_params / 1e6:.2f}M")
    # ---- Checkpoint: resume the pretext model when one exists
    # ("model" checkpoints are optimizer-free {params, bn} — loadable no
    # matter which pretext stage, simclr or moco, produced them)
    ckpt_dir = cfg.get("pretext_dir") or out_dir
    ckpt = latest_checkpoint(ckpt_dir, "model") if ckpt_dir else None
    if ckpt is not None:
        print(f"Restart from checkpoint {ckpt}")
        pb, _ = restore_checkpoint(ckpt, {"params": params, "bn": bn})
        params, bn = pb["params"], pb["bn"]
    else:
        print("No pretext checkpoint found — using the randomly "
              "initialized model (synthetic demo mode).")

    # ---- Datasets (deterministic val transforms — center crop)
    size = cfg.get("image_size", 32)
    val_t = ValTransform(size=size)
    results = {}
    for split, topk, path_key in (("train", 20, "topk_neighbors_train_path"),
                                  ("val", 5, "topk_neighbors_val_path")):
        ds = _load_dataset(cfg, split)
        print(f"Dataset contains {len(ds)} {split} samples")

        # ---- Fill memory bank (utils/utils.py fill_memory_bank)
        bank = MemoryBank(len(ds), mcfg.feature_dim,
                          num_classes=cfg.get("num_classes", 4), device=dev)
        bs = cfg.get("batch_size", 32)
        with torch.no_grad(), precision_scope(STAGE_PRECISION):
            for i in range(0, len(ds), bs):
                idxs = np.arange(i, min(i + bs, len(ds)))
                imgs = np.stack([val_t(ds.get_pil(int(j))) for j in idxs])
                emb, _, _ = contrastive_forward(
                    params, bn, torch.from_numpy(imgs).to(dev), mcfg)
                bank.update(emb, ds.labels[idxs])

        # ---- Mine the topk nearest neighbors (memory.py:46-65)
        print(f"Mine the nearest neighbors (Top-{topk})")
        topk_eff = min(topk, len(ds) - 1)
        indices, acc = bank.mine_nearest_neighbors(topk_eff)
        print(f"Accuracy of top-{topk_eff} nearest neighbors on {split} "
              f"set is {100 * acc:.2f}")
        out_path = cfg.get(path_key) or os.path.join(
            out_dir, f"topk-{split}-neighbors.npy")
        np.save(out_path, indices)
        print(f"saved -> {out_path}")
        results[split] = {"indices": indices, "accuracy": acc,
                          "path": out_path}
    return results


if __name__ == "__main__":
    main()
