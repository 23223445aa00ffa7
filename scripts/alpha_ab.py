#!/usr/bin/env python3
"""A/B timing of the port's alpha step and sweep on one card: this
checkout against another (an earlier commit unpacked by git archive into a
directory that .gitignore lists), run alternately.

    python3 scripts/alpha_ab.py --parent DIR [--rounds 2]

"parent" and "change" (this checkout) run in turn, in that order and then
reversed, ``--rounds`` times over; each run is a child process that imports
its tree's tpu_ac_torch and, on chip_smoke.py's synthetic MVTec tree
(bottle 84 and screw 168 test images, 256 px), with the main path's
configuration (DINO ViT-B/8, batch 8, bfloat16, seeded weights):

  - times ``compute_alpha_X`` a category, unsupervised in bf16 (each
    category) and supervised in f32 (bottle against its 84 train
    images), the median of 5 after a warm-up, synchronized;
  - times ``run_category_sweep`` over both categories, five sweeps (the
    first is warm-up), and reports the img/s of the last four.

Each run prints one JSON line; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = {"bottle": 84, "screw": 168}


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def child(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from tpu_ac_torch.data.mvtec import (
        DatasetSplit,
        MVTecDataset,
        make_synthetic_mvtec,
    )
    from tpu_ac_torch.pipeline import (
        PipelineConfig,
        build_embedder_for_config,
        compute_alpha_X,
        run_category_sweep,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    with tempfile.TemporaryDirectory() as work:
        anomalies = ("good", "broken_large", "contamination", "crack")
        for cat, n in SIZES.items():
            make_synthetic_mvtec(work, classname=cat, anomalies=anomalies,
                                 n_per_anomaly=n // len(anomalies),
                                 n_train=n, image_size=256, seed=len(cat))
        cfg = PipelineConfig(batch_size=8, precision="bfloat16")
        emb = build_embedder_for_config(cfg, device="cuda", mesh=None)

        def timed(fn, reps=5):
            fn()  # warm-up (and the kernel's build on the first call)
            ts = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            return _median(ts)

        alpha_ms = {}
        for cat in SIZES:
            z = emb(MVTecDataset(work, classname=cat,
                                 split=DatasetSplit.TEST).load_all_images())
            alpha_ms[cat] = timed(lambda: compute_alpha_X(
                z, "unsupervised", 1.0, precision="bf16"))
            if cat == "bottle":
                zt = emb(MVTecDataset(work, classname=cat,
                                      split=DatasetSplit.TRAIN)
                         .load_all_images())
                out["supervised_alpha_ms_bottle"] = timed(
                    lambda: compute_alpha_X(z, "supervised", 1.0, zt,
                                            precision="f32"))
                del zt
            del z
        out["alpha_ms"] = alpha_ms
        sweeps = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _c, _r in run_category_sweep(work, list(SIZES), cfg, emb):
                pass
            sweeps.append(time.perf_counter() - t0)
        out["sweep_s"] = sweeps
        out["sweep_img_s"] = [sum(SIZES.values()) / s for s in sweeps[1:]]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout to time against")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(a.child)), flush=True)
        return
    if not a.parent:
        ap.error("--parent is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    trees = {"parent": os.path.abspath(a.parent), "change": ROOT}
    order = ["parent", "change", "change", "parent"] * a.rounds
    for tag in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             trees[tag]], capture_output=True, text=True, timeout=900,
            cwd=trees[tag])
        if proc.returncode != 0:
            sys.exit(f"{tag} failed:\n{proc.stdout[-2000:]}\n"
                     f"{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tag, "card": card, **res}), flush=True)


if __name__ == "__main__":
    main()
