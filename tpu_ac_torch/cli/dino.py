"""DINO self-supervised pre-training CLI (port of ``tpu_ac.cli.dino``;
main_dino.py rebuilt): the same flags and defaults, plus ``--device``
(default ``cuda``, which raises without a card; ``cpu`` must be asked
for).

    python -m tpu_ac_torch.cli.dino --data_path DIR [--device cpu]

ImageFolder walk -> multi-crop augmentation (PIL on the host, or
``--device_aug`` on the card) -> train step -> checkpoint and JSON-lines
``log.txt`` each epoch, with resume from the newest checkpoint and a NaN
abort one dispatch late.  Checkpoints are ``tpu_ac``'s format: a run of
either package resumes in the other.

Across processes, one card a rank:

    torchrun --nproc_per_node N -m tpu_ac_torch.cli.dino --data_path DIR

joins torchrun's group (``distributed.multihost_init``: nccl, or gloo
with ``--device cpu``); a caller that has initialized a group calls
``main(argv)`` in each rank and the CLI joins it.  Each rank trains on its
shard of every epoch (the schedules at the global batch, batch_size_per_gpu
x N, and an aug seed of its own), the step is over the global batch
(``train/dino.py``), every rank starts from the same state (checked by
checksum after the init or the resume) and only rank 0 writes checkpoints
and ``log.txt``.

After each epoch a ``dino_epoch {...}`` JSON line gives the epoch's
steps, the device time a step (CUDA events from the first dispatch to
the last step's end; the host's clock on the CPU), the host's wait on the
loader a step and the peak memory.

What ``tpu_ac``'s dispatch flags become in eager torch:
- ``--steps_per_dispatch k``: k steps queued back to back, one metrics
  fetch per group, a ragged tail through the single step; the same
  kernels, so the same numbers.
- ``--remat``: activation checkpointing of each block
  (``torch.utils.checkpoint``); ``dots`` keeps the linears' outputs.
- ``--device_aug``: the crops are made on the card from square uint8
  bases (``data/device_aug.py``), with a generator seeded per step from
  (seed, rank, step), the step clamped like the schedule index.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from tpu_ac_torch.data.augment import DINOAugmentation
from tpu_ac_torch.data.imagefolder import ImageFolder
from tpu_ac_torch.data.prefetch import to_device
from tpu_ac_torch.device import resolve_device
from tpu_ac_torch.distributed import (
    multihost_init,
    process_count,
    process_index,
)
from tpu_ac_torch.distributed.collectives import check_same_on_ranks
from tpu_ac_torch.models.vit import VIT_BASE, VIT_SMALL, VIT_TINY, ViTConfig
from tpu_ac_torch.train.dino import (
    DINOConfig,
    init_dino_state,
    make_dino_multi_step,
    make_dino_train_step,
    make_schedules,
    make_step_schedule_tables,
)
from tpu_ac_torch.utils import (
    LaggedFetch,
    MetricLogger,
    fix_seeds,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from tpu_ac_torch.utils.profiling import maybe_profile, step_annotation

_ARCHS = {"vit_tiny": VIT_TINY, "vit_small": VIT_SMALL, "vit_base": VIT_BASE}


def _bool_flag(s: str) -> bool:
    """dino utils.bool_flag (utils.py:60-68): 'false'/'off'/'0' -> False."""
    if s.lower() in ("off", "false", "0"):
        return False
    if s.lower() in ("on", "true", "1"):
        return True
    raise argparse.ArgumentTypeError(f"invalid bool flag {s!r}")


def _remat_flag(s: str):
    """bool_flag plus the 'dots' policy (keep the matmul outputs)."""
    if s.lower() == "dots":
        return "dots"
    return _bool_flag(s)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("DINO (PyTorch)")
    p.add_argument("--arch", default="vit_small", choices=sorted(_ARCHS))
    p.add_argument("--patch_size", default=16, type=int)
    p.add_argument("--out_dim", default=65536, type=int)
    p.add_argument("--norm_last_layer", default=True, type=_bool_flag)
    p.add_argument("--momentum_teacher", default=0.996, type=float)
    p.add_argument("--warmup_teacher_temp", default=0.04, type=float)
    p.add_argument("--teacher_temp", default=0.04, type=float)
    p.add_argument("--warmup_teacher_temp_epochs", default=0, type=int)
    p.add_argument("--weight_decay", default=0.04, type=float)
    p.add_argument("--weight_decay_end", default=0.4, type=float)
    p.add_argument("--clip_grad", default=3.0, type=float)
    p.add_argument("--batch_size_per_gpu", default=64, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--freeze_last_layer", default=1, type=int)
    p.add_argument("--lr", default=0.0005, type=float)
    p.add_argument("--warmup_epochs", default=10, type=int)
    p.add_argument("--min_lr", default=1e-6, type=float)
    p.add_argument("--global_crops_scale", type=float, nargs="+",
                   default=(0.4, 1.0))
    p.add_argument("--local_crops_number", type=int, default=8)
    p.add_argument("--local_crops_scale", type=float, nargs="+",
                   default=(0.05, 0.4))
    p.add_argument("--data_path", required=True, type=str)
    p.add_argument("--output_dir", default=".", type=str)
    p.add_argument("--saveckp_freq", default=20, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--global_size", default=224, type=int)
    p.add_argument("--local_size", default=96, type=int)
    p.add_argument("--num_workers", default=10, type=int,
                   help="augmentation worker threads feeding the train "
                        "step (the reference's DataLoader num_workers; 0 = "
                        "serial). Per-image rng keys make the crops "
                        "identical at any worker count.")
    p.add_argument("--host_schedules", action="store_true",
                   help="feed lr/wd/momentum/temp/freeze to the step as "
                        "per-step host scalars (the reference's table "
                        "indexing) instead of the default tables on the "
                        "device indexed by the step counter. The same "
                        "numbers; the default saves 5 host-to-device "
                        "copies a step.")
    p.add_argument("--host_normalize", action="store_true",
                   help="normalize crops to f32 on the host instead of "
                        "uploading uint8 and normalizing in the step (same "
                        "math, 4x the host-to-device bytes).")
    p.add_argument("--max_steps_per_epoch", default=None, type=int,
                   help="cap steps per epoch (smoke tests)")
    p.add_argument("--profile", default=None, metavar="TRACE_DIR",
                   help="Write a torch.profiler chrome trace of the run "
                        "into TRACE_DIR.")
    p.add_argument("--device_aug", action="store_true",
                   help="make the multi-crop augmentation on the card "
                        "(data/device_aug.py): the host only decodes and "
                        "square-resizes each image to --base_size uint8. "
                        "Distribution-equivalent to the PIL path, not "
                        "bit-comparable; crops sample from the square base. "
                        "Requires the default device-resident schedules.")
    p.add_argument("--data_cache", default=None, type=str,
                   help="Directory for a decode-once memory-mapped uint8 "
                        "base-image cache (--device_aug only), keyed by "
                        "the ordered file list + --base_size; reused "
                        "across runs.")
    p.add_argument("--base_size", default=256, type=int,
                   help="square uint8 base-image size the device aug "
                        "crops from (--device_aug only).")
    p.add_argument("--steps_per_dispatch", default=1, type=int,
                   help="queue k train steps back to back with one metrics "
                        "fetch per group (the same numbers as k single "
                        "steps); the NaN abort lags up to k steps and the "
                        "loader stages k batches ahead. Requires the "
                        "default device-resident schedules.")
    p.add_argument("--remat", default=False, type=_remat_flag,
                   help="checkpoint each transformer block (recompute its "
                        "activations in the backward: FLOPs for memory). "
                        "'dots' keeps the linears' outputs and recomputes "
                        "only the rest.")
    p.add_argument("--use_fp16", default=True, type=_bool_flag,
                   help="Mixed-precision training (main_dino.py:78): "
                        "forward/backward in bfloat16 with f32 master "
                        "params/optimizer/loss/center. bf16 keeps f32's "
                        "exponent range, so there is no GradScaler.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises.")
    return p


def aug_seed(seed: int, rank: int, it: int) -> int:
    """The device aug's generator seed for step ``it`` of process
    ``rank``: each rank draws its own crops, and the rank is folded in
    per step, never into a value that all ranks share."""
    return int(np.random.SeedSequence([seed, rank, it]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def train_dino(args) -> dict:
    # torchrun's group, or the caller's (joined as it is); a no-op alone
    if process_count() == 1:
        multihost_init(backend="gloo" if args.device == "cpu" else None)
    n_procs, rank = process_count(), process_index()
    dev = resolve_device(args.device)
    fix_seeds(args.seed)
    dataset = ImageFolder(args.data_path)
    print(f"Data loaded: there are {len(dataset)} images.")

    vit_cfg = ViTConfig(
        **{**_ARCHS[args.arch].__dict__, "patch_size": args.patch_size,
           "img_size": args.global_size})
    # the batch count epoch_batches yields per shard (wrap-padded shards)
    per_shard = -(-len(dataset) // n_procs)
    steps_per_epoch = max(1, per_shard // args.batch_size_per_gpu)
    if args.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.max_steps_per_epoch)
    cfg = DINOConfig(
        out_dim=args.out_dim,
        local_crops_number=args.local_crops_number,
        global_size=args.global_size, local_size=args.local_size,
        warmup_teacher_temp=args.warmup_teacher_temp,
        teacher_temp=args.teacher_temp,
        warmup_teacher_temp_epochs=args.warmup_teacher_temp_epochs,
        momentum_teacher=args.momentum_teacher,
        norm_last_layer=args.norm_last_layer,
        epochs=args.epochs, steps_per_epoch=steps_per_epoch,
        lr=args.lr, warmup_epochs=args.warmup_epochs, min_lr=args.min_lr,
        weight_decay=args.weight_decay,
        weight_decay_end=args.weight_decay_end,
        clip_grad=args.clip_grad, freeze_last_layer=args.freeze_last_layer,
        remat=args.remat)

    k = args.steps_per_dispatch
    if k > 1 and args.host_schedules:
        raise SystemExit("--steps_per_dispatch > 1 needs the device-"
                         "resident schedules (drop --host_schedules)")
    if args.data_cache and not args.device_aug:
        raise SystemExit("--data_cache is the --device_aug base-image "
                         "cache; the PIL aug path crops from the "
                         "original-resolution images and cannot use it")
    if args.device_aug and args.host_schedules:
        raise SystemExit("--device_aug needs the device-resident "
                         "schedules (drop --host_schedules)")
    state = init_dino_state(args.seed, vit_cfg, cfg, device=dev)
    schedules = make_schedules(cfg, args.batch_size_per_gpu * n_procs)
    compute_dtype = torch.bfloat16 if args.use_fp16 else None
    tables = (None if args.host_schedules
              else make_step_schedule_tables(cfg, schedules, dev))
    transfer = to_device(dev)
    if args.device_aug:
        from tpu_ac_torch.data.device_aug import (
            DeviceAugConfig,
            device_multicrop,
        )
        from tpu_ac_torch.data.prefetch import BaseImagePrefetcher

        aug_cfg = DeviceAugConfig(
            global_crops_scale=tuple(args.global_crops_scale),
            local_crops_scale=tuple(args.local_crops_scale),
            local_crops_number=args.local_crops_number,
            global_size=args.global_size, local_size=args.local_size,
            base_size=args.base_size)
        inner = make_dino_train_step(vit_cfg, cfg,
                                     compute_dtype=compute_dtype,
                                     resident_schedules=True)
        gen = torch.Generator(device=dev)

        def aug_step(s, raw, it):
            gen.manual_seed(aug_seed(args.seed, rank, it))
            g, l = device_multicrop(raw, gen, aug_cfg)
            return inner(s, g, l, tables)

        if args.data_cache:
            from tpu_ac_torch.data.device_aug import build_base_cache

            base_cache = build_base_cache(dataset, args.base_size,
                                          args.data_cache)
            fetch_base = lambda i: base_cache[int(i)]  # noqa: E731
        else:
            fetch_base = lambda i: dataset[int(i)][0]  # noqa: E731
        loader = BaseImagePrefetcher(fetch_base, args.base_size,
                                     num_workers=args.num_workers,
                                     transfer=transfer)
    else:
        from tpu_ac_torch.data.prefetch import CropBatchPrefetcher

        step_fn = make_dino_train_step(
            vit_cfg, cfg, compute_dtype=compute_dtype,
            resident_schedules=not args.host_schedules)
        multi_fn = (make_dino_multi_step(vit_cfg, cfg, k,
                                         compute_dtype=compute_dtype)
                    if k > 1 else None)
        aug = DINOAugmentation(
            global_crops_scale=tuple(args.global_crops_scale),
            local_crops_scale=tuple(args.local_crops_scale),
            local_crops_number=args.local_crops_number,
            global_size=args.global_size, local_size=args.local_size,
            seed=args.seed, normalize=args.host_normalize)
        loader = CropBatchPrefetcher(
            lambda i: dataset[int(i)][0], aug, cfg.local_crops_number,
            num_workers=args.num_workers, seed=args.seed,
            transfer=transfer)

    start_epoch = 0
    ckpt = latest_checkpoint(args.output_dir, "checkpoint")
    if ckpt:
        state, meta = restore_checkpoint(ckpt, state)
        start_epoch = meta["extra"].get("epoch", 0) + 1
        print(f"Resumed from {ckpt} at epoch {start_epoch}")
    check_same_on_ranks(_leaves(state), "the initial DINO state")

    os.makedirs(args.output_dir, exist_ok=True)
    stats = {}

    def consume(pending):
        """Log the (already host-copied) metrics of an earlier dispatch,
        scalars or [k]-stacked under --steps_per_dispatch."""
        losses = np.atleast_1d(np.asarray(pending["loss"]))
        lrs = np.atleast_1d(np.asarray(pending["lr"]))
        wds = np.atleast_1d(np.asarray(pending["wd"]))
        for loss, lr, wd in zip(losses, lrs, wds):
            loss = float(loss)
            if not math.isfinite(loss):
                # one dispatch later than the reference's per-step check
                # (main_dino.py:330-333); nothing was checkpointed since
                print(f"Loss is {loss}, stopping training", flush=True)
                sys.exit(1)
            logger.update(loss=loss, lr=float(lr), wd=float(wd))

    cuda = dev.type == "cuda"
    try:
        with maybe_profile(args.profile):
            for epoch in range(start_epoch, args.epochs):
                logger = MetricLogger()
                t_temp = schedules["teacher_temp"][min(
                    epoch, len(schedules["teacher_temp"]) - 1)]
                # pin the step counter (the tables' index) to the
                # reference's it = epoch * steps_per_epoch
                state = state._replace(step=torch.tensor(
                    epoch * steps_per_epoch, dtype=torch.int32, device=dev))
                batches = dataset.epoch_batches(
                    args.batch_size_per_gpu, seed=args.seed + epoch,
                    num_shards=n_procs, shard_index=rank)
                fetch = LaggedFetch(consume)
                it_src = logger.log_every(loader.batches(epoch, batches), 10,
                                          f"Epoch: [{epoch}]")

                # one loop body for the four mode combinations (device or
                # host aug x grouped or single steps); ``item`` is a uint8
                # base batch under --device_aug, else a (global, local)
                # pair of crop batches
                def run_single(item, it):
                    nonlocal state
                    with step_annotation("dino_step", step=it):
                        if args.device_aug:
                            state, metrics = aug_step(state, item, it)
                        elif args.host_schedules:
                            g, l = item
                            state, metrics = step_fn(
                                state, g, l,
                                lr=float(schedules["lr"][it]),
                                wd=float(schedules["wd"][it]),
                                teacher_momentum=float(
                                    schedules["momentum"][it]),
                                teacher_temp=float(t_temp),
                                freeze_last=epoch < cfg.freeze_last_layer)
                        else:
                            g, l = item
                            state, metrics = step_fn(state, g, l, tables)
                    fetch.push(metrics)

                def run_group(items, it):
                    nonlocal state
                    with step_annotation("dino_step", step=it):
                        if args.device_aug:
                            ms = []
                            for j, raw in enumerate(items):
                                state, m = aug_step(
                                    state, raw,
                                    min(it + j, cfg.total_steps - 1))
                                ms.append(m)
                            metrics = {key: torch.stack([m[key] for m in ms])
                                       for key in ms[0]}
                        else:
                            gs = torch.stack([g for g, _ in items])
                            ls = (torch.stack([l for _, l in items])
                                  if items[0][1] is not None else None)
                            state, metrics = multi_fn(state, gs, ls, tables)
                    fetch.push(metrics)

                if cuda:
                    torch.cuda.reset_peak_memory_stats(dev)
                    t_start = torch.cuda.Event(enable_timing=True)
                    t_stop = torch.cuda.Event(enable_timing=True)
                wall0 = None
                buf: list = []
                done = 0
                for i, item in enumerate(it_src):
                    if (args.max_steps_per_epoch
                            and i >= args.max_steps_per_epoch):
                        break
                    if wall0 is None:
                        if n_procs > 1:
                            # every rank's clock from one start: rank 0
                            # may still be writing the last checkpoint
                            torch.distributed.barrier()
                        wall0 = time.perf_counter()
                        if cuda:
                            t_start.record()
                    if k > 1:
                        buf.append(item)
                        if len(buf) < k:
                            continue
                        run_group(buf, min(epoch * steps_per_epoch + done,
                                           cfg.total_steps - 1))
                        done += k
                        buf = []
                    else:
                        run_single(item, min(epoch * steps_per_epoch + i,
                                             cfg.total_steps - 1))
                        done += 1
                for item in buf:
                    run_single(item, min(epoch * steps_per_epoch + done,
                                         cfg.total_steps - 1))
                    done += 1
                if cuda and wall0 is not None:
                    t_stop.record()
                fetch.flush()
                if cuda:
                    torch.cuda.synchronize(dev)
                wall_ms = ((time.perf_counter() - wall0) * 1e3
                           if wall0 is not None else 0.0)
                logger.synchronize_between_processes()
                stats = {key: m.global_avg
                         for key, m in logger.meters.items()}
                steps = max(done, 1)
                print("dino_epoch " + json.dumps({
                    "epoch": epoch, "steps": done,
                    "step_ms": ((t_start.elapsed_time(t_stop) if cuda
                                 and wall0 is not None else wall_ms)
                                / steps),
                    "wall_step_ms": wall_ms / steps,
                    "data_wait_ms": logger.data_time.total * 1e3 / steps,
                    "peak_gib": (torch.cuda.max_memory_allocated(dev)
                                 / 2**30 if cuda else None),
                    "device": (torch.cuda.get_device_name(dev) if cuda
                               else "cpu")}), flush=True)
                if rank == 0:
                    save_checkpoint(args.output_dir, "checkpoint", state,
                                    step=epoch, extra={"epoch": epoch},
                                    keep=2)
                    if args.saveckp_freq and epoch % args.saveckp_freq == 0:
                        save_checkpoint(args.output_dir,
                                        f"checkpoint{epoch:04d}", state,
                                        step=epoch, extra={"epoch": epoch})
                    with open(os.path.join(args.output_dir, "log.txt"),
                              "a") as f:
                        f.write(json.dumps({"epoch": epoch, **{
                            f"train_{key}": v
                            for key, v in stats.items()}}) + "\n")
    finally:
        loader.close()
    return stats


def _leaves(state) -> dict[str, torch.Tensor]:
    """The state's tensors by path (student, teacher, Adam, center)."""
    opt = state.opt_state
    return {**{f"student/{k}": v for k, v in state.student.items()},
            **{f"teacher/{k}": v for k, v in state.teacher.items()},
            **{f"mu/{k}": v for k, v in opt.mu.items()},
            **{f"nu/{k}": v for k, v in opt.nu.items()},
            "count": opt.count, "center": state.center}


def main(argv=None) -> dict:
    """Train; returns the last epoch's averaged metrics."""
    return train_dino(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
