#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_ac_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --scaling N   # on a host of N cards, see
                                        # phase_scaling
    python3 chip_smoke.py --flash_ab DIR  # the flash kernels against
                                          # another checkout's, see flash_ab

Phases, each fatal on failure:
  1. card: name and power limit (nvidia-smi), torch/CUDA versions;
  2. build: nvcc compiles every tpu_ac_torch/csrc/*.cu for sm_90a, one
     process per source, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card.
     min_dists: symmetric and rectangular x f32/bf16c/bf16, at the main
     path's widths (P=784, D=4096) and at ragged shapes; its window mode
     at the four rank placements of tests/test_kernels.py x f32/bf16;
     then the wgmma/TMA stress shapes: N = 1 (window: 2 images), P, Q in
     {20, 112, 130, 784}, D in {96, 4096}, every mode and precision.
     flash_attention: bf16 and f32 (3xTF32) on the strided q/k/v views of a
     packed qkv, at the main path's [8, 12, 785, 64], at S = 1, 17, 26,
     127, 128, 129, 130 (the cp.async tiles' edges), at S=256 with a
     segment mask over the last 56 keys, at head dims 16, 32, 48
     (zero-padded to 64) and, through the wide kernels, 80, 128, 200, 256
     (one launch a call) and 320 (one per 256-column slice of V), each at
     S = 785 and with the mask, the launches a call asserted;
  4. main path: a synthetic MVTec tree of two categories (84 and 168 test
     images, 256 px sources) through tpu_ac_torch.cli.main with the CLI
     defaults (ViT-B/8 full width on its seeded random init, blocks.10+11,
     2048 -> 4096, bf16, unsupervised, attention_impl "auto": the flash
     kernel, 12 launches a batch asserted), then cli.evaluate on its
     pickles; one category again with --precision default --supervised
     supervised (f32: the dense attention, no flash launch asserted); the
     launch counts of each run; the
     min_dists kernel on one category's embeddings against its plain
     version; embed ms/image, alpha ms/category and sweep img/s; one more
     sweep under torch.profiler for the device time by kernel and the busy
     share;
  5. flash path: a full-width dino_vitbase8 .pth (seeded init, module.
     prefix, an extra head) through tpu_ac_torch.cli.convert --verify
     --install, the embedder built from that cache dir with
     attention_impl="flash" (its weights checked exactly), two sweeps of
     the same tree with their flash launches counted (12 blocks x 32
     batches, none f32), their pickles checked, bottle's embeddings
     against the dense (attention_impl="dense") and f32 embedders of the
     same weights; then bottle
     through an f32 flash embedder (precision="highest", the f32 kernel:
     its 132 launches asserted, all f32) against the dense f32 embedding
     within F32_FLASH_GAP_BOUND; embed ms/image flash vs dense in bf16 and
     in f32 as device busy time (the union of one embed's kernel, copy
     and memset intervals under the profiler, their summed durations and
     the wall time, which the host paces, beside it), sweep img/s, and one
     profiled sweep; then a ViT-H/14 at full
     width (1280 wide, 32 blocks of 16 heads, Dh 80, MLP 5120; seeded on
     the card) embeds bottle at 224 px through CategoryEmbedder(...,
     attention_impl="flash") in bf16 (blocks.30+31): the wide kernel held
     to its plain version at the embed's shapes ([8, 16, 257, 80] and the
     last batch's [4, 16, 257, 80]), 352 launches of the
     wide kernel asserted, Z within VITH_GAP_FACTOR x the bf16 rounding
     noise of the dense embed, compute_alpha_X with its one min_dists
     launch, alpha/X finite and alpha's rows summing to 1; device
     ms/image flash and dense and the flash kernel's share of the embed;
  6. mesh path: the same tree through run_category_sweep with the CLI
     defaults on a virtual dp mesh of 2 x cuda:0 (one process runs the
     ranks one after another, each at its shape on a real 2-card mesh):
     dp embed (the flash kernel under "auto": 12 launches a shard of each
     batch) plus the triangle-sharded alpha on the window kernel (2
     window launches a category and no other min_dists, asserted), its
     pickles checked; per category the dp embeddings against one device's
     and the triangle W against the symmetric kernel's W without its
     self-term, within a bound derived from the 1e-4 rule on d2; one
     category through the rect scheme and one through the sharded
     supervised path (the rectangular kernel on the mesh); sweep img/s,
     alpha ms a category, one profiled sweep;
  7. export and serving: on bottle (84 images) of the same tree,
     tpu_ac_torch.cli.export (in this process, main(argv)) at its
     defaults (dino_vitbase8, unsupervised, precision default) with
     --n_images 96 --dump_params, then a supervised artifact at bfloat16
     with --n_train_images 32 and a --dp 2 one; each served by
     scripts/serving_host_torch.py in a process of its own (no tpu_ac*
     module loaded there, asserted by the host): the first alone with
     --bench, beside the live embed + alpha of the same category timed
     here, the other two side by side; each process's min_dists launches
     a category (1, 1 and 2 window) and plain calls (0) asserted; the
     served Z (the artifact's embed program here) against the live
     embedder's (attention_impl="dense": the attention the artifact
     exports), bit for bit or within ZOO_GAP_BOUND; the served alpha/X
     bit-equal to the live path's on the served Z, and their gap to it
     on the live Z; the native host library built and loaded; export s,
     artifact bytes, serving s a category and images/s beside the card
     line;
  8. PatchCore path: the flagship recipe through tpu_ac_torch.cli.
     patchcore with --compute_pro on a synthetic category of 220 train / 83
     test images (256 px sources): wideresnet50 on its seeded init, layer2
     + layer3, 1024 -> 1024, patchsize 3, 10% approximate greedy coreset,
     exact kNN with k = 5, batch 8; results.csv complete, every AUROC and
     the PRO in [0, 1]; fit and predict s and img/s on the CLI's own
     builder, bank rows before and after the coreset, the coreset at k = 1
     and at select_batch 16, the predict's kNN beside its bound and its
     product alone; kNN against a float64 host search on 2,048 queries,
     knn_sharded on 2 x cuda:0 against knn, the coreset's picks against
     the CPU's on 16,384 projected rows, the segmentor against scipy's
     gaussian_filter on 4 images; one profiled fit + predict.  No
     hand-written kernel lies on this path (asserted: no launches);
  9. zoo: one registry name per family beside those above (ZOO: vgg19_bn,
     alexnet, densenet201, inception_v4, bninception, resnest50,
     resnetv2_50_bit, efficientnet_b7, efficientnetv2_l, mnasnet_a1,
     vit_r50, vit_swin_base, dino_xcit_medium_24_p8, vit_deit_distilled),
     each at its full registered width on its seeded init, tapped at two
     layers (~28 x 28 and ~14 x 14 grids at 224 px where the family has
     them, printed): the card's f32 embedding of 1 image (TF32 off)
     against the CPU's within ZOO_GAP_BOUND; for the vit family
     (vit_deit_distilled) its bf16 "auto" embed of 16 images (the flash
     kernel, its launches asserted) against a "dense" embedder of the
     same weights within 3 x the bf16 rounding noise (dense bf16 against
     f32); then the sweep of bottle (84 images) at the CLI defaults with
     its pickles checked and its symmetric min_dists launches counted
     (the counts set to 0 before it; a ViT's flash launches too: 12 a
     batch under "auto", none in the other families), embed ms/image,
     sweep img/s and the peak memory; each model
     freed before the next; then python -m tpu_ac_torch.cli.main and
     cli.evaluate on dino_xcit_small_12_p8, each a process of its own;
 10. DINO training: a synthetic ImageFolder (2 classes, 448 PNGs at 256
     px from a numpy seed: 7 steps of 64) through python -m
     tpu_ac_torch.cli.dino at main_dino's recipe (ViT-S/16, out_dim
     65536, 2 x 224 + 8 x 96 crops, batch 64, bf16, AdamW, clip 3, last
     layer frozen in epoch 0), each run a process of its own: the timed
     run (--device_aug --data_cache, 2 epochs x 6 steps; from epoch 1
     the step ms by CUDA events, images/s, crops/s, the share of the
     dense bf16 peak, peak GiB); the PIL path (--num_workers = the CPU
     count, 1 epoch x 3 steps: step ms and the host's wait on the
     loader); --steps_per_dispatch 2 and --remat true at the timed run's
     2 epochs x 6 steps, their epoch losses equal to its, remat's peak
     beside its; every run's checkpoints and log.txt written,
     its losses finite.  In this process: 3 steps under torch.profiler
     (busy share, the ten largest device ops), and one full-width step at
     batch 2 in f32 (TF32 off) on the card against the CPU from one state
     and one set of crops: the loss and every gradient before the clip
     within DINO_LOSS_GAP_BOUND and DINO_GRAD_GAP_BOUND, the card's update
     equal to the CPU's update of the card's gradients, and the states
     after the step apart by at most Adam's first step, 2 lr.  No
     hand-written kernel lies on this path (asserted: no launches);
 11. SCAN: a synthetic CIFAR-10 in the cifar-10-batches-py pickle format
     (SCAN_TRAIN + SCAN_TEST images at 32 px in 10 classes, from a numpy
     seed) through python -m tpu_ac_torch.cli.scan simclr, scan,
     selflabel and eval at tpu_ac's cifar-10 configs with epochs 1
     (ResNet-18, SimCLR at 512 pairs, SCAN at 128 with 10 heads and 20
     neighbours, self-label at 1,000 with threshold 0.99 and class
     balancing), each stage a process of its own: every epoch's step ms,
     images/s, the wait on the loader and peak GiB, the stage times, the
     neighbour accuracy and eval's ACC/NMI/ARI, the artifacts checked;
     then the moco stage (cli.scan's run_moco, in this process) on
     RESNET50_IMAGENET from a MoCo-v2-format .pth of a seeded init on a
     synthetic 224 px ImageFolder (the pretext model must equal the
     .pth).  In this process: the SimCLR transform's host
     rate serially, on 8 threads and on the port's 8-process pool; mining
     at 50,000 x 128,
     top-21, by CUDA events, 1,000 rows held to a float64 host search; 4
     profiled steps of each stage (busy share, the ten largest device
     ops); one f32 step of each kind (SimCLR, SCAN full and head-only,
     self-label) at full width on the card and on the CPU, held to a
     float64 CPU run (the SCAN_*_BOUND rules), the states after the step
     too; the SimCLR step's share of the TF32 and f32 peaks.  No
     hand-written kernel lies on this path (asserted: no launches);
 12. DINO's evals: the five eval CLIs in this process (main(argv), on
     cuda) at the recipes' full widths on their seeded inits, on
     synthetic trees from numpy seeds: cli.eval_knn at its defaults
     (ViT-S/16, 224 px, batch 128, k 10/20/100/200) on a 4-class
     ImageFolder of 256 + 128 images, --dump_features, 8 val images'
     card features (TF32) within ZOO_GAP_BOUND of the CPU's f32; then
     knn_classifier at ImageNet's size on seeded unit features on the card
     (1,281,167 x 384 f32, 1,000 classes, 50,000 queries, k = 20: host
     wall time, the votes' device time, the f32 product's bound) and on
     20,000 x 1,000 of them the top-5 classes against a float64 host vote
     away from ties; cli.eval_linear (n_last_blocks 4, 2 epochs) and 500
     probe steps at 1,536 -> 1,000, batch 256 (steps/s, the ImageNet
     epoch's seconds); cli.eval_copy_detection at dino_vitbase8, 320 px,
     batch 16, on a Copydays tree of 8 originals with distractor and
     whitening dirs (per-block mAP); cli.eval_image_retrieval at
     dino_vitbase16, 224 px, on make_synthetic_roxford's tree, plain and
     --multiscale 1 (mAP M/H); cli.eval_video_segmentation at its
     defaults on one 10-frame 854 x 480 video with a 2-object first mask
     (one palette PNG a frame at the source size, labels in {0, 1, 2}; ms
     a frame of the embed and of the propagation); images/s of the
     ViT-S/16 extract (batch 128) and the ViT-B/8 one at 320 px (batch
     16) beside their shares of the dense TF32 peak.  No hand-written
     kernel lies on this path (asserted: no launches);
 13. visualization: visualize_attention's array function (attention_
     arrays: every block's CLS attention, the nearest-upsampled maps, the
     threshold masks at 0.6, the display image, the ground truth) on a
     bottle test image of the main path's tree, at the CLI's default arch
     and size (dino_deitsmall8, 224 px) and at dino_vitbase8 at 224 and
     480 px (the crop past the 256-px resize: the zero-pad branch, N =
     3,601, 7.5 GB of attention in f32); each against the same function
     on the CPU (224) or a float64 evaluation on the card (480) within
     VIZ_GAP_BOUND, the masks equal outside the threshold band; the ms of
     ViT.all_selfattentions and the peak memory; then the attention video
     of 16 seeded 854 x 480 frames (a JPEG directory) through
     viz.video.generate_attention_video_from_path with dino_deitsmall8
     (N = 6,361 a frame) into a GIF (frame count and size checked),
     frames/s, frame 0's heat map against the CPU's.  No hand-written
     kernel lies on this path (asserted: no launches);
 14. training across processes on the one card (the dist phase, see the
     comment above phase_dist): two gloo ranks on cuda:0 run two f32 DINO
     steps at main_dino's ViT-S/16 recipe (32 images a rank) and one step
     of each SCAN kind at the CIFAR-10 recipe (train_dp 2, in float64 and
     in f32), their states bit-equal to each other, against one process on
     the whole batch; the gloo all-reduce of the gradient bucket timed;
     then one nccl rank (world 1): an init, an all-reduce and a bf16 DINO
     step bit-equal to the step without a group;
 15. timings at the main path's shapes: each kernel beside its bound, its
     plain version and a library yardstick (cdist; scaled_dot_product_
     attention, bf16 and f32), which the port never calls; for min_dists
     also cuBLAS (torch.matmul) on the same bf16 products without the min
     (gemm_ms); the flash kernel also at head dims 80 and 128 ([8, 16,
     785, 80], [8, 6, 785, 128]); the window kernel at one rank's shape of
     N = 168 over dp = 2.
The build's ptxas report (registers, shared memory, spills) is printed for
every kernel instance.
Before the card's line come the run's end-to-end numbers as one summary
JSON, and the script fails if a process it started is still running; the line before the last is the kernels JSON; the last line is the
result JSON.  Exits non-zero, printing no result, without CUDA or outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM dense peaks at 700 W (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
SOURCE = "tpu_ac_torch/csrc/min_dists.cu"
REPLACES = "tpu_ac/kernels/distances.py:219"
WINDOW_REPLACES = "tpu_ac/kernels/distances.py:348"
FLASH_SOURCE = "tpu_ac_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "tpu_ac/kernels/attention.py:26"
# B, H, S, Dh of the flash path: ViT-B/8 at 224 px (784 patches + CLS),
# batch 8
FLASH_SHAPE = (8, 12, 785, 64)
# The f32 flash embed against the dense f32 embed of the same weights,
# relative L2: each of the 12 attention calls up to blocks.11 may move its
# output by 1e-5 of the attention of |V| (the f32 rule of
# attention.flash_tolerance); allowing each call a relative effect on the
# embeddings of up to 8x that (the attention of |V| against that of V, and
# the gain of the blocks after it) gives 12 x 8 x 1e-5, under ZOO_GAP_BOUND
# (1e-3).  A single-pass TF32 kernel sits 20-25x over the 1e-5 rule
# (tests/test_torch_flash_f32.py), a wrong one at O(1).
F32_FLASH_GAP_BOUND = 12 * 8 * 1e-5
# ViT-H/14 ("An Image is Worth 16x16 Words", Table 1; timm
# vit_huge_patch14_224): the flash path's head dim over 64 (1280 / 16 = 80)
VITH14 = dict(patch_size=14, embed_dim=1280, depth=32, num_heads=16)
# Its flash embed against the dense one in bf16, relative L2, as for
# ViT-B/8: two bf16 paths that each round about as much as the dense one
# does against f32 differ by about sqrt(2) times that; 3x leaves room for
# the flash kernel's bf16 rounding of P (2^-8 of the attention of |V|, the
# dense path's rounding of its softmax output is the same size).  The blocks
# add attention to a residual stream, which damps a kernel's error in Z, so
# this bound checks the path end to end and not the kernel: the kernel is
# held element by element to its plain version at the path's own shapes
# first (phase_vith_flash)
VITH_GAP_FACTOR = 3.0
# the SFU's exponentials: 16 per clock per SM, 132 SMs at the 1.98 GHz boost
EXP_PER_S = 16 * 132 * 1.98e9
# weights of the checkpoint route: a seed other than the registry's seed-0
# fallback, so a checkpoint that is not found cannot pass for one that is
CKPT_SEED = 1


def _fatal(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _children(pid: str = "self") -> list[str]:
    kids = []
    try:
        for task in os.listdir(f"/proc/{pid}/task"):
            with open(f"/proc/{pid}/task/{task}/children") as f:
                kids += f.read().split()
    except OSError:  # ended since the listing
        pass
    return kids


_POOLS = []


def _aug_pool(*args, **kwargs):
    """A ParallelAugPool that _stop_children closes if its phase fails."""
    from tpu_ac_torch.data.prefetch import ParallelAugPool

    _POOLS.append(ParallelAugPool(*args, **kwargs))
    return _POOLS[-1]


def _stop_children() -> None:
    """Stop every process below this one (a phase that failed may leave
    a worker pool, a rank or a server behind): the script never ends with
    a process of its own still running.  This process's pools are closed
    first (a live pool would start new workers in place of killed ones),
    then what is left is killed."""
    import signal

    for pool in _POOLS:
        pool.close()  # a no-op on a closed pool
    tree, todo = [], _children()
    while todo:
        pid = todo.pop()
        tree.append(int(pid))
        todo += _children(pid)
    for pid in tree:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    for pid in tree:
        with contextlib.suppress(OSError):
            os.waitpid(pid, 0)


def _check_no_children() -> None:
    """Fail if a process that this script started is still running: every
    phase must stop what it starts (the SCAN stages' worker pools stop
    their forkserver and resource tracker at close)."""
    left = []
    for pid in _children():
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                left.append(f"{pid}: " + f.read().replace(b"\0", b" ")
                            .decode(errors="replace")[:200])
        except OSError:  # ended since the listing
            pass
    if left:
        _fatal("processes still running at the end: " + "; ".join(left))


def _card_line() -> str:
    from tpu_ac_torch.device import card_report

    return card_report()["line"]


def _time_ms(fn, reps: int, warmup: int = 1) -> tuple[float, float]:
    """(device ms, host ms) a call of ``fn`` over ``reps`` calls.

    The launches queue behind a device sleep, so the events time the
    device's work and not the host's launch rate (a flash call's wrapper
    takes about as long on the host as its kernel).  The sleep lasts twice
    the host's time for ``reps`` calls as the warm-up measures it, and at
    least 10 ms.  That holds the device's time only if the host has queued
    every call before the sleep ends, which is checked: where it has not, a
    warning says that the time may include the device's waits for the host
    (as it does for a function that waits for the device on the host, such
    as the plain versions and cdist, timed without a warm-up)."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    sleep_ms = max(10.0, 2e3 * reps * (time.perf_counter() - t0)
                   / max(warmup, 1))
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # cycles: at least sleep_ms at the card's clock of at most 1.98 GHz
    torch.cuda._sleep(int(sleep_ms * 2e6))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    queued = not start.query()  # the device still sleeps
    stop.record()
    stop.synchronize()
    if not queued:
        print(f"warning: the host took {host_ms:.1f} ms to queue {reps} "
              "calls, past the device's sleep: the time may include the "
              "device's waits for the host", flush=True)
    return start.elapsed_time(stop) / reps, host_ms / reps


# Tolerance on the squared distances, relative to the norms (see below)
D2_RTOL = 1e-4


def _check_d2(torch, got, want, tol, label: str,
              quiet: bool = False) -> float:
    """Distances ``got`` against ``want`` on their squares, each entry to
    its ``tol``; fatal past it, else returns the max abs error."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        _fatal(f"{label}: shape {tuple(got.shape)} or non-finite values")
    worst = float(((got.square() - want.square()).abs() / tol).max())
    err = float((got - want).abs().max())
    if not quiet or not worst <= 1.0:
        print(f"{label}: max_abs_err={err:.3e} (largest distance "
              f"{float(want.max()):.2f}), max |d2 gap| / tol = {worst:.3f} "
              f"(tol {D2_RTOL:g} x (|a|^2 + max|b|^2))", flush=True)
    if not worst <= 1.0:
        _fatal(f"{label}: the kernel disagrees with its plain version")
    return err


def _check_agree(torch, got, want, Z, bank, label: str,
                 quiet: bool = False) -> float:
    """Kernel output against the plain version's; fatal past the
    tolerance, else returns the max abs error of the distances.

    Both sides form the same bf16 products exactly and sum them in f32 in
    different orders: the kernel one 16-deep tensor-core step at a time (at
    most 3 x 4096/16 = 768 roundings), cuBLAS in its own blocked order.
    Every partial sum is at most |a||b| <= (|a|^2 + |b|^2)/2, so the squared
    distances |a|^2 - 2a.b + |b|^2 agree to 1e-4 (~840 f32 ulps) of
    |a|^2 + max|b|^2, and so do their mins and the squares of the outputs.
    The check is made on the squares: a distance near 0 (an image against
    itself, two patches of one flat defect) is the square root of that
    cancellation noise and carries no relative accuracy."""
    a2 = Z.square().sum(-1)  # [I, P]
    b2 = bank.square().sum(-1).amax(-1)  # [J]
    tol = D2_RTOL * (a2[:, None, :] + b2[None, :, None])
    return _check_d2(torch, got, want, tol, label, quiet)


def _window_active(torch, n_i: int, n_w: int, window: int,
                   row_valid=None, col_valid=None):
    r = torch.arange(n_i, device="cuda")[:, None]
    w = torch.arange(n_w, device="cuda")[None, :]
    act = (r <= w) & (w < r + window)
    if row_valid is not None:
        act &= row_valid.cuda()[:, None]
    if col_valid is not None:
        act &= col_valid.cuda()[None, :]
    return act


def _check_window(torch, got, want, Z, bank, window: int,
                  label: str, quiet: bool = False, row_valid=None,
                  col_valid=None) -> float:
    """The window kernel's (row [I, W, P], col [W, I, Q]) against the plain
    version's on the active tiles (those of valid rows and columns, where
    masks are given), by _check_agree's rule (the col-min of a tile is the
    row-min of its transpose, so its tolerance swaps the roles of the two
    norms); the inactive tiles must be +inf on both sides.  Returns the
    max abs error."""
    act = _window_active(torch, Z.shape[0], bank.shape[0], window,
                         row_valid, col_valid)
    a2, b2 = Z.square().sum(-1), bank.square().sum(-1)  # [I, P], [W, Q]
    tols = (D2_RTOL * (a2[:, None, :] + b2.amax(-1)[None, :, None]),
            D2_RTOL * (b2[:, None, :] + a2.amax(-1)[None, :, None]))
    err = 0.0
    for g, w, tol, m, part in zip(got, want, tols, (act, act.t()),
                                  ("row", "col")):
        if g.shape != w.shape or not (bool(torch.isinf(g[~m]).all()) and
                                      bool(torch.isinf(w[~m]).all())):
            _fatal(f"{label} {part}: shape {tuple(g.shape)} or an inactive "
                   "tile that is not +inf")
        err = max(err, _check_d2(torch, g[m], w[m], tol[m],
                                 f"{label} {part}-mins", quiet))
    return err


def _check_padded(torch, got, want, Z, bank, n: int, nb: int,
                  label: str) -> float:
    """A count-restricted op's [cap, cap_bank, P] against the plain
    version's: entries of a row at or past ``n`` or a bank image at or
    past ``nb`` +inf on both sides, the valid block by _check_agree's
    rule.  Returns the max abs error."""
    valid = torch.zeros(got.shape[:2], dtype=torch.bool, device="cuda")
    valid[:n, :nb] = True
    if got.shape != want.shape or got.shape[:2] != (len(Z), len(bank)) or \
            not (bool(torch.isinf(got[~valid]).all())
                 and bool(torch.isinf(want[~valid]).all())):
        _fatal(f"{label}: shape {tuple(got.shape)} or an entry past the "
               "valid counts that is not +inf")
    return _check_agree(torch, got[:n, :nb], want[:n, :nb], Z[:n], bank[:nb],
                        label)


def _window_inputs(torch, gen, n: int, off: int, n_local: int, p: int,
                   d: int, scale: float = 1.0):
    """One dp rank's inputs of the triangle-sharded alpha, as
    tpu_ac_torch.distributed builds them: its rows off .. off + n_local - 1
    of n images and the circulant window of the bank after them."""
    Z = torch.randn(n, p, d, device="cuda", generator=gen) * scale
    h = n // 2
    idx = (off + 1 + torch.arange(n_local - 1 + h, device="cuda")) % n
    return Z[off:off + n_local].contiguous(), Z[idx].contiguous(), h


def phase_kernels(torch, dist):
    """Kernel vs plain on the card; returns {mode: max abs error}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [  # (n, nb, p, q, d): main-path widths, then ragged ones
        (8, 6, 784, 784, 4096),
        (5, 3, 20, 16, 96),
        (7, 4, 19, 20, 96),
    ]
    errs = {"symmetric": 0.0, "rectangular": 0.0}
    for n, nb, p, q, d in cases:
        Z = torch.randn(n, p, d, device="cuda", generator=gen)
        B = torch.randn(nb, q, d, device="cuda", generator=gen)
        for prec in dist.PRECISIONS:
            for sym in (True, False):
                bank = Z if sym else B
                mode = "symmetric" if sym else "rectangular"
                got = dist.min_dists_all_pairs(Z, bank, precision=prec,
                                               symmetric=sym)
                want = dist.min_dists_all_pairs_plain(Z, bank,
                                                      precision=prec,
                                                      symmetric=sym)
                err = _check_agree(
                    torch, got, want, Z, bank,
                    f"kernel {mode:11s} {prec:5s} n={n} nb={nb} p={p} "
                    f"q={q} d={d}")
                errs[mode] = max(errs[mode], err)
    return errs


STRESS_PQ = (20, 112, 130, 784)
STRESS_D = (96, 4096)


def phase_stress(torch, dist) -> dict:
    """min_dists at the shapes that walk the wgmma/TMA tile edges (a
    64-row warpgroup with no rows, a 112-column half with no columns, D one
    64-deep chunk and a half): N = 1, P, Q in STRESS_PQ, D in STRESS_D,
    each mode and precision, one line per mode and precision; returns
    {mode: max abs error}."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    errs = {"symmetric": 0.0, "rectangular": 0.0, "window": 0.0}
    for prec in dist.PRECISIONS:
        for mode in errs:
            n_cases = 0
            for d in STRESS_D:
                for p in STRESS_PQ:
                    for q in STRESS_PQ:
                        if mode != "rectangular" and q != p:
                            continue
                        label = f"stress {mode} {prec} p={p} q={q} d={d}"
                        if mode == "window":  # rank 0 of 2 images
                            z, bank, h = _window_inputs(torch, gen, 2, 0, 1,
                                                        p, d)
                            got = dist.min_dists_window(z, bank, window=h,
                                                        precision=prec)
                            want = dist.min_dists_window_plain(
                                z, bank, window=h, precision=prec)
                            err = _check_window(torch, got, want, z, bank,
                                                h, label, quiet=True)
                        else:
                            sym = mode == "symmetric"
                            z = torch.randn(1, p, d, device="cuda",
                                            generator=gen)
                            bank = z if sym else torch.randn(
                                1, q, d, device="cuda", generator=gen)
                            got = dist.min_dists_all_pairs(
                                z, bank, precision=prec, symmetric=sym)
                            want = dist.min_dists_all_pairs_plain(
                                z, bank, precision=prec, symmetric=sym)
                            err = _check_agree(torch, got, want, z, bank,
                                               label, quiet=True)
                        errs[mode] = max(errs[mode], err)
                        n_cases += 1
            print(f"stress {mode:11s} {prec:5s}: {n_cases} shapes agree "
                  f"(N=1, P, Q in {STRESS_PQ}, D in {STRESS_D}), max_abs_err"
                  f"={errs[mode]:.3e}", flush=True)
    return errs


def phase_window_kernel(torch, dist) -> float:
    """The window mode against its plain version at the placements of
    tests/test_kernels.py TestWindowMode (interior, wrap around the bank
    end, odd N, one row), f32 and bf16, P = 20 or 784; returns the max abs
    error.  The full-width rank is checked in phase_window_timing."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    err = 0.0
    for n, off, n_local, p, d in ((8, 2, 2, 20, 96), (8, 6, 2, 784, 256),
                                  (7, 0, 3, 20, 96), (8, 3, 1, 130, 96)):
        z_loc, bank_w, h = _window_inputs(torch, gen, n, off, n_local, p, d)
        for prec in ("f32", "bf16"):
            got = dist.min_dists_window(z_loc, bank_w, window=h,
                                        precision=prec)
            want = dist.min_dists_window_plain(z_loc, bank_w, window=h,
                                               precision=prec)
            err = max(err, _check_window(
                torch, got, want, z_loc, bank_w, h,
                f"kernel window {prec:5s} n={n} off={off} "
                f"n_local={n_local} p={p} d={d}"))
    return err


def _bound_ms(n_pairs: int, p: int, q: int, d: int, passes: int,
              in_bytes: int, out_bytes: int) -> tuple[float, str]:
    flops = 2.0 * p * q * d * n_pairs * passes
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (in_bytes + out_bytes) / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_timing(torch, dist, n_sym: int, n_rect: tuple[int, int]):
    """Agreement and times at the main path's shapes: symmetric bf16 at
    the larger category, rectangular f32 at the supervised run's shape."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    p, d = 784, 4096
    out = {}
    for mode, prec, (ni, nj) in (("symmetric", "bf16", (n_sym, n_sym)),
                                 ("rectangular", "f32", n_rect)):
        sym = mode == "symmetric"
        Z = torch.randn(ni, p, d, device="cuda", generator=gen) * 0.5
        bank = Z if sym else torch.randn(nj, p, d, device="cuda",
                                         generator=gen) * 0.5
        passes = 1 if prec == "bf16" else 3
        n_pairs = ni * (ni + 1) // 2 if sym else ni * nj
        # the function reads its f32 inputs once and writes [I, J, P] f32
        in_bytes = (ni if sym else ni + nj) * p * d * 4
        bound, bound_by = _bound_ms(n_pairs, p, p, d, passes, in_bytes,
                                    ni * nj * p * 4)
        got = dist.min_dists_all_pairs(Z, bank, precision=prec,
                                       symmetric=sym)
        want = dist.min_dists_all_pairs_plain(Z, bank, precision=prec,
                                              symmetric=sym)
        err = _check_agree(torch, got, want, Z, bank,
                           f"kernel {mode:11s} {prec:5s} n={ni} nb={nj} "
                           f"p=q={p} d={d} (main path's shape)")
        del got, want
        ms, host_ms = _time_ms(lambda: dist.min_dists_all_pairs(
            Z, bank, precision=prec, symmetric=sym), reps=3)
        plain_ms, _ = _time_ms(lambda: dist.min_dists_all_pairs_plain(
            Z, bank, precision=prec, symmetric=sym), reps=1, warmup=0)
        # yardstick: cdist + min over the same pairs, one call per query
        # image (the [I, J, P, Q] distance tensor does not fit at once)
        zf = (Z.to(torch.bfloat16).float() if prec == "bf16" else Z)
        bf = (bank.to(torch.bfloat16).float() if prec == "bf16" else bank)

        def library():
            for i in range(ni):
                torch.cdist(zf[i:i + 1].expand(nj, -1, -1), bf).amin(-1)

        library_ms, _ = _time_ms(library, reps=1, warmup=0)
        # cuBLAS on the kernel's bf16 products without the min, one call
        # per query image and term (symmetric: over its bank images j >=
        # i): how far the mainloop is from cuBLAS's on this shape
        z_parts, _ = dist._prep(Z, prec)
        b_parts = z_parts if sym else dist._prep(bank, prec)[0]
        terms = [(0, 0)] if prec == "bf16" else [(0, 0), (0, 1), (1, 0)]

        def gemm():
            for i in range(ni):
                for za, bb in terms:
                    torch.matmul(z_parts[za][i],
                                 b_parts[bb][i if sym else 0:].transpose(
                                     1, 2))

        gemm_ms, _ = _time_ms(gemm, reps=1)
        print(f"timing {mode} {prec} I={ni} J={nj} P=Q={p} D={d}: "
              f"kernel {ms:.2f} ms (host {host_ms:.3f} ms a call), bound "
              f"{bound:.2f} ms ({bound_by}), plain {plain_ms:.2f} ms, cdist "
              f"{library_ms:.2f} ms, cuBLAS bf16 products {gemm_ms:.2f} ms, "
              f"{2.0 * p * p * d * n_pairs * passes / ms / 1e9:.1f} "
              "TFLOP/s", flush=True)
        out[mode] = dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=bound_by,
                         library_ms=library_ms, gemm_ms=gemm_ms,
                         max_abs_err=err)
        del Z, bank, zf, bf, z_parts, b_parts
        torch.cuda.empty_cache()
    return out


def phase_window_timing(torch, dist, n: int, dp: int) -> dict:
    """The window kernel at one rank's shape of the mesh path (rank 1 of
    dp over N images, bf16: the rank whose window wraps around the bank
    end): agreement, time, bound, plain, and cdist + both mins over the
    active tiles as the yardstick."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    p, d = 784, 4096
    n_local = n // dp
    z_loc, bank_w, h = _window_inputs(torch, gen, n, n_local, n_local, p, d,
                                      scale=0.5)
    n_w = bank_w.shape[0]
    n_pairs = len(dist.window_pairs(n_local, n_w, h))
    # f32 inputs read once; row [I, W, P] and col [W, I, Q] f32 written
    bound, bound_by = _bound_ms(n_pairs, p, p, d, 1,
                                (n_local + n_w) * p * d * 4,
                                2 * n_local * n_w * p * 4)
    got = dist.min_dists_window(z_loc, bank_w, window=h, precision="bf16")
    want = dist.min_dists_window_plain(z_loc, bank_w, window=h,
                                       precision="bf16")
    err = _check_window(torch, got, want, z_loc, bank_w, h,
                        f"kernel window bf16 I={n_local} W={n_w} H={h} "
                        f"p=q={p} d={d} (a rank of the mesh path)")
    del got, want
    ms, host_ms = _time_ms(lambda: dist.min_dists_window(
        z_loc, bank_w, window=h, precision="bf16"), reps=3)
    plain_ms, _ = _time_ms(lambda: dist.min_dists_window_plain(
        z_loc, bank_w, window=h, precision="bf16"), reps=1, warmup=0)
    zf, bf = (x.to(torch.bfloat16).float() for x in (z_loc, bank_w))

    def library():
        for r in range(n_local):
            hi = min(r + h, n_w)
            dd = torch.cdist(zf[r:r + 1].expand(hi - r, -1, -1), bf[r:hi])
            dd.amin(-1)
            dd.amin(-2)

    library_ms, _ = _time_ms(library, reps=1, warmup=0)
    zb, bb = (x.to(torch.bfloat16) for x in (z_loc, bank_w))

    def gemm():  # cuBLAS on the same bf16 products, no min
        for r in range(n_local):
            torch.matmul(zb[r], bb[r:min(r + h, n_w)].transpose(1, 2))

    gemm_ms, _ = _time_ms(gemm, reps=1)
    print(f"timing window bf16 I={n_local} W={n_w} H={h} ({n_pairs} "
          f"tiles) P=Q={p} D={d}: kernel {ms:.2f} ms (host {host_ms:.3f} "
          f"ms a call), bound {bound:.2f} ms "
          f"({bound_by}), plain {plain_ms:.2f} ms, cdist {library_ms:.2f} "
          f"ms, cuBLAS bf16 products {gemm_ms:.2f} ms, "
          f"{2.0 * p * p * d * n_pairs / ms / 1e9:.1f} TFLOP/s", flush=True)
    del z_loc, bank_w, zf, bf, zb, bb
    torch.cuda.empty_cache()
    return dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=library_ms, gemm_ms=gemm_ms,
                max_abs_err=err, n_pairs=n_pairs)


def _packed_qkv(torch, gen, b: int, h: int, s: int, dh: int, dtype):
    """q, k, v [B, H, S, Dh] as the ViT makes them: strided views of one
    packed [B, S, 3, H, Dh] projection."""
    qkv = torch.randn(b, s, 3, h, dh, device="cuda", generator=gen)
    return qkv.to(dtype).permute(2, 0, 3, 1, 4).unbind(0)


# the largest gap over its per-element limit (attention.flash_tolerance)
# seen by each flash check, by dtype
FLASH_WORST = {}
# head dims over 64, the wide kernels: checked at FLASH_SHAPE's B, H, S
# (one launch a call up to 256 columns, one per 256-column slice of V
# above); timed at the widths of ViT-H/14 (1280 / 16 heads) and of a
# 768-wide ViT of 6 heads
WIDE_HEAD_DIMS = (80, 128, 200, 256, 320)
WIDE_TIMING_SHAPES = ((8, 16, 785, 80), (8, 6, 785, 128))
# {Dh: {dtype: {"max_abs_err", "gap_over_tol", "launches_a_call"}}} of
# those checks
FLASH_WIDE = {}


def _wide_launches(attn, dh: int) -> int:
    """Launches of one flash call at head dim ``dh`` under the wrapper's
    plan: one up to WIDE_SLICE columns, one per slice of V above."""
    return -(-attn.padded_head_dim(dh) // attn.WIDE_SLICE)


def _flash_check(torch, attn, q, k, v, bias, label: str) -> float:
    """Flash kernel vs its plain version, element by element against
    attention.flash_tolerance (bf16: u (P|V|) + 2u |out| with u = 2^-8,
    the kernel's rounding of P and of the two outputs; f32: 1e-5 (P|V|));
    fatal past it, else returns the max abs error."""
    scale = q.shape[-1] ** -0.5
    ids = attn.bias_to_segment_ids(bias, q.shape[2])
    got = attn.flash_attention_impl(q, k, v, scale, bias)
    want = attn.flash_attention_plain(q, k, v, scale, ids)
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        _fatal(f"{label}: shape {tuple(got.shape)} or non-finite values")
    tol = attn.flash_tolerance(q, k, v, scale, ids, want)
    gap = (got.float() - want.float()).abs()
    err, worst = float(gap.max()), float((gap / tol).max())
    dtype = str(q.dtype).split(".")[-1]
    FLASH_WORST[dtype] = max(FLASH_WORST.get(dtype, 0.0), worst)
    print(f"flash {label} {dtype}: max_abs_err={err:.3e}, max gap/tol="
          f"{worst:.3f} (tol per element {float(tol.min()):.2e}.."
          f"{float(tol.max()):.2e}, median {float(tol.median()):.2e}; "
          f"mean |out| {float(want.float().abs().mean()):.2e})", flush=True)
    if worst > 1.0:
        _fatal(f"flash {label} {dtype}: the kernel disagrees with its "
               "plain version")
    return err


def phase_flash_kernel(torch, attn) -> float:
    """Flash kernel vs plain on the card; returns the largest max abs
    error."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, s, dh = FLASH_SHAPE
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        for sl in (s, 1, 17, 26, 127, 128, 129, 130):
            q, k, v = _packed_qkv(torch, gen, b, h, sl, dh, dtype)
            errs.append(_flash_check(torch, attn, q, k, v, None,
                                     f"[{b}, {h}, {sl}, {dh}]"))
        # keys 200..255 masked: the padded rows see only the padded keys
        q, k, v = _packed_qkv(torch, gen, b, h, 256, dh, dtype)
        bias = torch.zeros(1, 1, 1, 256, device="cuda")
        bias[..., 200:] = -1e9
        errs.append(_flash_check(torch, attn, q, k, v, bias,
                                 f"[{b}, {h}, 256, {dh}] segment mask "
                                 "over the last 56 keys"))
        # head dims below 64: zero-padded to 64 by the wrapper
        for dh_small in (16, 32, 48):
            q, k, v = _packed_qkv(torch, gen, b, h, 130, dh_small, dtype)
            errs.append(_flash_check(torch, attn, q, k, v, None,
                                     f"[{b}, {h}, 130, {dh_small}]"))
        # head dims over 64: the wide kernels, S computed once a key tile
        # over every column of q and k
        name = str(dtype).split(".")[-1]
        for dh_wide in WIDE_HEAD_DIMS:
            q, k, v = _packed_qkv(torch, gen, b, h, s, dh_wide, dtype)
            before = (attn.LAUNCHES, attn.LAUNCHES_WIDE)
            worst = FLASH_WORST.get(name, 0.0)
            FLASH_WORST[name] = 0.0
            err = _flash_check(torch, attn, q, k, v, None,
                               f"[{b}, {h}, {s}, {dh_wide}]")
            # and with a segment mask over the last 56 keys of 256
            q, k, v = _packed_qkv(torch, gen, b, h, 256, dh_wide, dtype)
            bias = torch.zeros(1, 1, 1, 256, device="cuda")
            bias[..., 200:] = -1e9
            err = max(err, _flash_check(
                torch, attn, q, k, v, bias,
                f"[{b}, {h}, 256, {dh_wide}] segment mask"))
            n_launch = (attn.LAUNCHES - before[0],
                        attn.LAUNCHES_WIDE - before[1])
            want = 2 * _wide_launches(attn, dh_wide)
            if n_launch != (want, want):
                _fatal(f"flash Dh {dh_wide}: {n_launch} launches (all, "
                       f"wide) for two calls, want {want} of the wide "
                       "kernel")
            FLASH_WIDE.setdefault(dh_wide, {})[name] = {
                "max_abs_err": err, "gap_over_tol": FLASH_WORST[name],
                "launches_a_call": n_launch[0] // 2}
            FLASH_WORST[name] = max(worst, FLASH_WORST[name])
            errs.append(err)
    return max(errs)


def phase_flash_timing(torch, attn) -> dict:
    """Times at the flash path's shape, bf16: the kernel, its plain
    version, the dense bf16 attention the ViT runs without it, and
    scaled_dot_product_attention as the library yardstick; then the f32
    variant (checked again on its timed inputs), its plain version and
    scaled_dot_product_attention in f32."""
    import torch.nn.functional as F

    b, h, s, dh = FLASH_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = _packed_qkv(torch, gen, b, h, s, dh, torch.bfloat16)
    scale = dh ** -0.5
    flops = 4.0 * b * h * s * s * dh
    n_bytes = 4.0 * b * h * s * dh * 2  # q, k, v read, out written
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    bound, bound_by = (t_ops, "operations") if t_ops >= t_bytes \
        else (t_bytes, "bytes")
    t_exp = b * h * s * s / EXP_PER_S * 1e3

    def dense():
        a = torch.softmax(torch.matmul(q, k.transpose(-2, -1)) * scale, -1)
        return torch.matmul(a, v)

    err = _flash_check(torch, attn, q, k, v, None,
                       f"[{b}, {h}, {s}, {dh}] (timed inputs)")
    ms, host_ms = _time_ms(
        lambda: attn.flash_attention_impl(q, k, v, scale), reps=20, warmup=3)
    plain_ms, _ = _time_ms(
        lambda: attn.flash_attention_plain(q, k, v, scale), reps=20, warmup=3)
    dense_ms, _ = _time_ms(dense, reps=20, warmup=3)
    library_ms, _ = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale), reps=20, warmup=3)
    print(f"timing flash bf16 [{b}, {h}, {s}, {dh}]: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s; its wrapper {host_ms:.4f} ms a "
          f"call on the host), bound {bound:.4f} ms "
          f"({bound_by}; bytes {t_bytes:.4f} ms, exponentials "
          f"{t_exp:.4f} ms), plain {plain_ms:.4f} ms, dense bf16 "
          f"{dense_ms:.4f} ms, scaled_dot_product_attention "
          f"{library_ms:.4f} ms", flush=True)
    # the f32 variant (precision="default"/"highest"): 3xTF32 on the tensor
    # cores, three TF32 products for each of the f32 ones; the f32 FMA
    # bound beside it (the variant's first design had no tensor cores)
    q, k, v = (t.float() for t in (q, k, v))
    err = max(err, _flash_check(torch, attn, q, k, v, None,
                                f"[{b}, {h}, {s}, {dh}] (timed inputs)"))
    f32_ms, f32_host_ms = _time_ms(
        lambda: attn.flash_attention_impl(q, k, v, scale), reps=20, warmup=3)
    f32_plain_ms, _ = _time_ms(
        lambda: attn.flash_attention_plain(q, k, v, scale), reps=20,
        warmup=3)
    f32_library_ms, _ = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale), reps=20, warmup=3)
    f32_bound = 3 * flops / PEAK_TF32_FLOPS * 1e3
    print(f"timing flash f32 [{b}, {h}, {s}, {dh}]: kernel {f32_ms:.4f} ms "
          f"({flops / f32_ms / 1e9:.1f} TFLOP/s of f32 work; its wrapper "
          f"{f32_host_ms:.4f} ms a call on the host), bound "
          f"{f32_bound:.4f} ms (operations, 3xTF32: 3 x {flops / 1e9:.2f} "
          f"GFLOP at the TF32 peak; bytes {2 * t_bytes:.4f} ms; f32 FMA "
          f"{flops / PEAK_F32_FLOPS * 1e3:.4f} ms), plain "
          f"{f32_plain_ms:.4f} ms, scaled_dot_product_attention f32 "
          f"{f32_library_ms:.4f} ms", flush=True)
    wide = {}
    for shape in WIDE_TIMING_SHAPES:
        wide["x".join(map(str, shape))] = _flash_wide_timing(torch, attn,
                                                             shape)
    return dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=library_ms, dense_ms=dense_ms,
                f32_ms=f32_ms, f32_host_ms=f32_host_ms,
                f32_bound_ms=f32_bound, f32_plain_ms=f32_plain_ms,
                f32_library_ms=f32_library_ms, max_abs_err=err, wide=wide)


def _time_launches(fn, count) -> tuple[float, float, float]:
    """(device ms, host ms) a call of ``fn`` as _time_ms gives them over
    20 calls after 3, and the launches a call: what ``count()`` rose by
    over the calls ``fn`` received."""
    calls = 0

    def call():
        nonlocal calls
        calls += 1
        fn()

    before = count()
    ms, host_ms = _time_ms(call, reps=20, warmup=3)
    return ms, host_ms, (count() - before) / calls


def _flash_wide_timing(torch, attn, shape) -> dict:
    """A head dim over 64, bf16 and f32: the wide kernel (its launches a
    call counted), its plain version and scaled_dot_product_attention
    beside the bound of the call's own work (Dh, not a padded width)."""
    import torch.nn.functional as F

    b, h, s, dh = shape
    gen = torch.Generator(device="cuda").manual_seed(4)
    flops = 4.0 * b * h * s * s * dh
    row = {}
    for dtype, peak, passes in ((torch.bfloat16, PEAK_BF16_FLOPS, 1),
                                (torch.float32, PEAK_TF32_FLOPS, 3)):
        q, k, v = _packed_qkv(torch, gen, b, h, s, dh, dtype)
        scale = dh ** -0.5
        name = str(dtype).split(".")[-1]
        err = _flash_check(torch, attn, q, k, v, None,
                           f"[{b}, {h}, {s}, {dh}] (timed inputs)")
        ms, host_ms, launches = _time_launches(
            lambda: attn.flash_attention_impl(q, k, v, scale),
            lambda: attn.LAUNCHES_WIDE)
        plain_ms, _ = _time_ms(
            lambda: attn.flash_attention_plain(q, k, v, scale), reps=20,
            warmup=3)
        library_ms, _ = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), reps=20, warmup=3)
        t_ops = passes * flops / peak * 1e3
        t_bytes = 4.0 * b * h * s * dh * q.element_size() / PEAK_HBM_BYTES \
            * 1e3
        bound, bound_by = ((t_ops, "operations") if t_ops >= t_bytes
                           else (t_bytes, "bytes"))
        print(f"timing flash {name} [{b}, {h}, {s}, {dh}]: kernel "
              f"{ms:.4f} ms ({launches:g} launches a call of the wide "
              f"kernel; {flops / ms / 1e9:.1f} TFLOP/s of the call's work; "
              f"its wrapper {host_ms:.4f} ms a call on the host), bound "
              f"{bound:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {library_ms:.4f} ms",
              flush=True)
        row[name] = dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound,
                         bound_by=bound_by, max_abs_err=err,
                         launches_a_call=launches)
    return row


def _make_tree(work: str, sizes: dict[str, int]) -> str:
    from tpu_ac_torch.data.mvtec import make_synthetic_mvtec

    root = os.path.join(work, "mvtec")
    anomalies = ("good", "broken_large", "contamination", "crack")
    for cat, n in sizes.items():
        make_synthetic_mvtec(root, classname=cat, anomalies=anomalies,
                             n_per_anomaly=n // len(anomalies),
                             n_train=n, image_size=256,
                             seed=len(cat))
    return root


def _check_pickles(out_dir: str, cfg, supervised: str, cats,
                   sizes: dict[str, int], n_patches: int = 784) -> None:
    """The stage-1 artifacts: shapes, finite values, alpha rows sum to 1."""
    import numpy as np

    from tpu_ac_torch.pipeline import artifact_dir, load_alpha_X

    d = artifact_dir(out_dir, "mvtec_ad", cfg.backbone_name, supervised,
                     cfg)
    for cat in cats:
        alpha, X = load_alpha_X(os.path.join(
            d, f"matrix_alpha_X_{cat}_{supervised}.pickle"))
        n = sizes[cat]
        if alpha.shape != (n, 1, n_patches) or X.shape != (n, 4096):
            _fatal(f"{cat} {supervised}: shapes {alpha.shape} {X.shape}")
        if not (np.isfinite(alpha).all() and np.isfinite(X).all()):
            _fatal(f"{cat} {supervised}: non-finite alpha or X")
        rowsum = alpha[:, 0].sum(-1)
        if np.abs(rowsum - 1.0).max() > 1e-4:
            _fatal(f"{cat} {supervised}: alpha rows sum to {rowsum}")
        print(f"pickle {out_dir}/.../{cat} {supervised}: alpha "
              f"{alpha.shape} X {X.shape} finite, |rowsum-1| <= "
              f"{np.abs(rowsum - 1.0).max():.1e}", flush=True)


def phase_main_path(torch, dist, attn, work: str, root: str,
                    sizes: dict[str, int]):
    """CLI stage 1 + 2 on the synthetic tree (bf16, attention_impl
    "auto": the flash kernel); returns launches per mode and the run's
    numbers."""
    from tpu_ac_torch.cli.evaluate import main as cli_eval
    from tpu_ac_torch.cli.main import main as cli_main
    from tpu_ac_torch.pipeline import (
        PipelineConfig,
        _pad_bucket,
        build_embedder_for_config,
        compute_alpha_X,
        run_category_sweep,
    )

    out_dir = os.path.join(work, "out")
    cats = list(sizes)
    common = ["--path", root, "--output_dir", out_dir,
              "--backbone_names", "dino_vitbase8"]

    launches = {}
    dist.LAUNCHES = attn.LAUNCHES = 0
    t0 = time.perf_counter()
    cli_main(common + ["--categories", *cats])
    cli_s = time.perf_counter() - t0
    launches["symmetric"] = dist.LAUNCHES
    # "auto" takes the flash kernel in bf16: 12 blocks a batch of 8
    want = 12 * sum(math.ceil(n / 8) for n in sizes.values())
    if attn.LAUNCHES != want:
        _fatal(f"the CLI's bf16 \"auto\" sweep launched the flash kernel "
               f"{attn.LAUNCHES} times; want {want} (12 blocks x "
               f"{want // 12} batches)")
    print(f"CLI sweep (bf16, attention_impl auto): {attn.LAUNCHES} flash "
          f"launches (12 blocks x {want // 12} batches)", flush=True)
    cli_eval(["--path", root, "--output_dir", out_dir, "--backbone_names",
              "dino_vitbase8", "--tau_list", "1.0", "--supervised_modes",
              "unsupervised", "--categories", *cats])

    dist.LAUNCHES = attn.LAUNCHES = 0
    cli_main(common + ["--categories", cats[0], "--precision", "default",
                       "--supervised", "supervised"])
    launches["rectangular"] = dist.LAUNCHES
    if attn.LAUNCHES:
        _fatal(f"the CLI's f32 run launched the flash kernel "
               f"{attn.LAUNCHES} times; \"auto\" is dense in f32")
    for mode, n in launches.items():
        if n <= 0:
            _fatal(f"the {mode} kernel was not launched on the main path")

    cfg = PipelineConfig(batch_size=8, precision="bfloat16")
    _check_pickles(out_dir, cfg, "unsupervised", cats, sizes)
    _check_pickles(out_dir, cfg, "supervised", cats[:1], sizes)
    csv_path = os.path.join(out_dir, "mvtec_ad", "dino_vitbase8",
                            "unsupervised",
                            "blocks.10_blocks.11_2048_4096_tau_result.csv")
    with open(csv_path) as f:
        rows = [r.split(",") for r in f.read().splitlines()]
    scored = [r for r in rows if r[0] in cats]
    if len(scored) != len(cats) or not all(
            math.isfinite(float(v)) for r in scored for v in r[1:]):
        _fatal(f"metrics CSV incomplete: {rows}")
    print(f"metrics CSV: {scored}", flush=True)

    # measurements outside the counted run: embed, alpha, sweep
    from tpu_ac_torch.cluster.alpha import alpha_from_weights
    from tpu_ac_torch.data.mvtec import DatasetSplit, MVTecDataset

    emb = build_embedder_for_config(cfg, device="cuda")
    decode_ms = {}
    images = {}
    for c in cats:
        t0 = time.perf_counter()
        images[c] = MVTecDataset(root, classname=c,
                                 split=DatasetSplit.TEST).load_all_images()
        decode_ms[c] = (time.perf_counter() - t0) * 1e3
    big = cats[-1]
    emb(images[big])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Z = emb(images[big])
    torch.cuda.synchronize()
    embed_ms = (time.perf_counter() - t0) * 1e3 / sizes[big]
    alpha_ms = {}
    for c in cats:
        Zc = Z if c == big else emb(images[c])
        compute_alpha_X(Zc, "unsupervised", 1.0, precision="bf16")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compute_alpha_X(Zc, "unsupervised", 1.0, precision="bf16")
        torch.cuda.synchronize()
        alpha_ms[c] = (time.perf_counter() - t0) * 1e3
    # the kernel on real embeddings against its plain version, in the form
    # the main path and the exported programs give it: Z padded to the
    # 32-image bucket, the valid count below it; and the alpha each gives
    # (printed: alpha follows from the mins)
    Zs = emb(images[cats[0]])
    n = len(Zs)
    zp = _pad_bucket(Zs, 32)
    cap = len(zp)
    mins_k = dist.min_dists_all_pairs(zp, zp, precision="bf16",
                                      symmetric=True, n_valid=n)
    mins_p = dist.min_dists_all_pairs_plain(zp, zp, precision="bf16",
                                            symmetric=True, n_valid=n)
    _check_padded(torch, mins_k, mins_p, zp, zp, n, n,
                  f"kernel symmetric on {cats[0]}'s embeddings (N={n} of "
                  f"{cap}, bf16)")
    a_k = alpha_from_weights(mins_k[:n, :n].sum(1) / (n - 1), 1.0)
    a_p = alpha_from_weights(mins_p[:n, :n].sum(1) / (n - 1), 1.0)
    print(f"alpha from the kernel vs the plain version ({cats[0]}): max "
          f"relative gap {float(((a_k - a_p).abs() / a_p).max()):.3e}",
          flush=True)
    del mins_k, mins_p
    # the rectangular op as the supervised program gives it: both counts
    # below their capacities (f32, the supervised run's "default")
    n_t = 20
    ztp = _pad_bucket(emb(MVTecDataset(root, classname=cats[0],
                                       split=DatasetSplit.TRAIN)
                          .load_all_images()[:n_t]), 32)
    got = dist.min_dists_all_pairs(zp, ztp, precision="f32", n_valid=n,
                                   n_bank_valid=n_t)
    want = dist.min_dists_all_pairs_plain(zp, ztp, precision="f32",
                                          n_valid=n, n_bank_valid=n_t)
    _check_padded(torch, got, want, zp, ztp, n, n_t,
                  f"kernel rectangular on {cats[0]}'s embeddings (N={n} of "
                  f"{cap}, J={n_t} of {len(ztp)}, f32)")
    del got, want, ztp
    # the window op as the dp-2 programs give it over the padded bucket:
    # rows and wrapped columns past n masked out, at both ranks
    n_local, h = cap // 2, cap // 2
    for rank in range(2):
        off = rank * n_local
        b_idx = (off + 1 + torch.arange(n_local - 1 + h)) % cap
        row_valid = off + torch.arange(n_local) < n
        col_valid = b_idx < n
        z_loc = zp[off:off + n_local]
        bank_w = zp[b_idx.cuda()]
        got = dist.min_dists_window(z_loc, bank_w, window=h,
                                    precision="f32", row_valid=row_valid,
                                    col_valid=col_valid)
        want = dist.min_dists_window_plain(z_loc, bank_w, window=h,
                                           precision="f32",
                                           row_valid=row_valid,
                                           col_valid=col_valid)
        _check_window(torch, got, want, z_loc, bank_w, h,
                      f"kernel window on {cats[0]}'s embeddings (rank "
                      f"{rank} of 2, N={n} of {cap}, f32)",
                      row_valid=row_valid, col_valid=col_valid)
        del got, want, z_loc, bank_w
    del Z, Zs, Zc, zp
    sweep_s = []
    for _ in range(2):  # the first is warm-up
        t0 = time.perf_counter()
        for _c, _r in run_category_sweep(root, cats, cfg, emb):
            pass
        sweep_s.append(time.perf_counter() - t0)
    n_img = sum(sizes.values())
    busy = _profile_sweep(
        torch, lambda: run_category_sweep(root, cats, cfg, emb), sweep_s[-1])
    return launches, dict(
        cli_s=cli_s, embed_ms_per_image=embed_ms, alpha_ms=alpha_ms,
        decode_ms=decode_ms, busy_pct=busy,
        sweep_img_s=n_img / sweep_s[-1], sweep_s=sweep_s,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _profile_sweep(torch, sweep, sweep_s: float) -> float:
    """One more sweep under torch.profiler (see _profile_busy)."""
    def drain():
        for _c, _r in sweep():
            pass

    return _profile_busy(torch, drain, sweep_s, "one sweep")


def _profile_busy(torch, work, wall_s: float, label: str) -> float:
    """``work()`` once more under torch.profiler: the device time by
    kernel, and its sum against the unprofiled run's wall time (the busy
    share, in %, returned; it ignores overlap between the copy engines and
    the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    events = prof.key_averages()
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in events if _device_work(e, DeviceType)]
    busy_ms = sum(r[0] for r in rows)
    aten = sum(e.count for e in events if e.key.startswith("aten::"))
    print(f"profile of {label}: device busy {busy_ms:.1f} ms of the "
          f"unprofiled run's {wall_s * 1e3:.1f} ms ("
          f"{100 * busy_ms / (wall_s * 1e3):.1f}% busy); {aten} aten ops "
          f"and {sum(r[1] for r in rows)} device kernels", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f}% x{count:<6d} "
              f"{key[:90]}", flush=True)
    return 100 * busy_ms / (wall_s * 1e3)


def _device_work(event, DeviceType) -> bool:
    """A profiler event of the card's own work: a kernel, copy or memset,
    not the device mirror of a ``record_function`` range (the sweep's
    ``ac.*`` spans), whose time the work inside it already counts."""
    return event.device_type == DeviceType.CUDA and not getattr(
        event, "is_user_annotation", False)


def _embed_device_ms(torch, embed, images) -> tuple[float, float]:
    """Device ms an image of one ``embed(images)``, which the host's pace
    of launching does not change (an embed's wall time it does): the
    length of the union of its kernel, copy and memset intervals under
    torch.profiler (the card's busy time, as the benchmark's
    ``sweep_busy_s`` reads it), and beside it their summed durations,
    which exceed the union where operations overlap on the card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        embed(images)
        torch.cuda.synchronize()
    spans = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if "CUDA" in str(e.device_type()) and e.duration_ns() > 0
        and not getattr(e, "is_user_annotation", lambda: False)())
    union, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    summed = sum(b - a for a, b in spans)
    if not union > 0:
        _fatal("the profiler saw no device time in an embed")
    return union / 1e6 / len(images), summed / 1e6 / len(images)


def _rel_gap(torch, a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def phase_flash_path(torch, dist, attn, work: str, root: str,
                     sizes: dict[str, int]) -> dict:
    """The checkpoint route at full width, then the flash sweep from it."""
    from tpu_ac_torch.cli.convert import main as cli_convert
    from tpu_ac_torch.data.mvtec import DatasetSplit, MVTecDataset
    from tpu_ac_torch.models.registry import BACKBONE_CONFIGS
    from tpu_ac_torch.models.vit import init_vit_params
    from tpu_ac_torch.pipeline import (
        PipelineConfig,
        build_embedder_for_config,
        compute_alpha_X,
        run_category_sweep,
    )

    # a .pth as a DDP run saves it, with a classifier head the ViT lacks
    spec = BACKBONE_CONFIGS["dino_vitbase8"]
    init = init_vit_params(CKPT_SEED, spec.config)
    sd = {"module." + k: torch.from_numpy(v) for k, v in init.items()}
    sd["module.head.weight"] = torch.zeros(1000, 768)
    raw = os.path.join(work, "dino_vitbase8_ddp.pth")
    torch.save(sd, raw)
    del sd
    ckpt_dir = os.path.join(work, "ckpt")
    t0 = time.perf_counter()
    report = cli_convert([raw, "--backbone", "dino_vitbase8", "--verify",
                          "--install", "--cache_dir", ckpt_dir])
    convert_s = time.perf_counter() - t0
    if report["missing"] or report["shape_mismatch"] or \
            report["unexpected"] != ["head.weight"] or not os.path.isfile(
                os.path.join(ckpt_dir, spec.checkpoint)):
        _fatal(f"cli.convert --verify --install: {report}")
    cfg = PipelineConfig(batch_size=8, precision="bfloat16")
    emb = build_embedder_for_config(cfg, device="cuda",
                                    checkpoint_dir=ckpt_dir,
                                    attention_impl="flash")
    state = emb._model.state_dict()
    bad = sorted(set(state) ^ set(init)) + [
        k for k in init if not torch.equal(
            state[k].cpu(), torch.from_numpy(init[k]).to(torch.bfloat16))]
    if bad:
        _fatal(f"the flash embedder's weights are not the installed "
               f"checkpoint's: {bad[:8]}")
    print(f"checkpoint route: cli.convert --verify --install "
          f"{convert_s:.1f} s; the flash embedder holds the installed "
          f"seed-{CKPT_SEED} init exactly ({len(init)} tensors, bf16)",
          flush=True)

    # the flash sweep, its launches counted: 12 blocks per batch of 8
    cats = list(sizes)
    want = 12 * sum(math.ceil(n / cfg.batch_size) for n in sizes.values())
    out_dir = os.path.join(work, "out_flash")
    sweep_s = []
    for _ in range(2):  # the first is warm-up
        dist.LAUNCHES = attn.LAUNCHES = attn.LAUNCHES_F32 = 0
        t0 = time.perf_counter()
        for _c, _r in run_category_sweep(root, cats, cfg, emb,
                                         output_dir=out_dir):
            pass
        sweep_s.append(time.perf_counter() - t0)
        launches = {"flash_attention": attn.LAUNCHES,
                    "of_them_f32": attn.LAUNCHES_F32,
                    "min_dists_symmetric": dist.LAUNCHES}
        print(f"flash sweep: launches {launches}", flush=True)
        if launches["flash_attention"] != want or launches["of_them_f32"] \
                or launches["min_dists_symmetric"] != len(cats):
            _fatal(f"the flash sweep launched {launches}; want "
                   f"{want} flash launches (12 blocks x "
                   f"{want // 12} batches) and {len(cats)} min_dists")
    _check_pickles(out_dir, cfg, "unsupervised", cats, sizes)

    # bottle through the flash, dense and f32 embedders of the same weights
    images = {c: MVTecDataset(root, classname=c, split=DatasetSplit.TEST)
              .load_all_images() for c in cats}
    dense = build_embedder_for_config(cfg, device="cuda",
                                      checkpoint_dir=ckpt_dir,
                                      attention_impl="dense")
    cfg32 = PipelineConfig(batch_size=8, precision="highest")
    f32 = build_embedder_for_config(cfg32, device="cuda",
                                    checkpoint_dir=ckpt_dir,
                                    attention_impl="dense")
    small = cats[0]
    Zf, Zd, Z32 = (e(images[small]) for e in (emb, dense, f32))
    # and through the f32 flash embedder: the f32 kernel, 12 launches a
    # batch of 8, none of the bf16 variant
    f32_flash = build_embedder_for_config(cfg32, device="cuda",
                                          checkpoint_dir=ckpt_dir,
                                          attention_impl="flash")
    want32 = 12 * math.ceil(sizes[small] / cfg32.batch_size)
    attn.LAUNCHES = attn.LAUNCHES_F32 = 0
    Zf32 = f32_flash(images[small])
    torch.cuda.synchronize()
    launches32 = (attn.LAUNCHES, attn.LAUNCHES_F32)
    if launches32 != (want32, want32):
        _fatal(f"the f32 flash embed of {small} launched {launches32} "
               f"(all, f32); want {want32} f32 launches and no other")
    gap32 = _rel_gap(torch, Zf32, Z32)
    if not (gap32 <= F32_FLASH_GAP_BOUND and bool(
            torch.isfinite(Zf32).all()) and Zf32.shape == Z32.shape):
        _fatal(f"f32 flash vs dense f32 embeddings of {small}: relative L2 "
               f"{gap32:.3e} > {F32_FLASH_GAP_BOUND:.1e}, or non-finite")
    print(f"{small}'s f32 flash embed: {launches32[1]} f32 kernel launches "
          f"({want32 // 12} batches x 12 blocks), relative L2 gap to the "
          f"dense f32 embed {gap32:.3e} (bound {F32_FLASH_GAP_BOUND:.1e})",
          flush=True)
    del Zf32
    gap, noise = _rel_gap(torch, Zf, Zd), _rel_gap(torch, Zd, Z32)
    flash_f32 = _rel_gap(torch, Zf, Z32)
    a_f, _ = compute_alpha_X(Zf, "unsupervised", 1.0, precision="bf16")
    a_d, _ = compute_alpha_X(Zd, "unsupervised", 1.0, precision="bf16")
    alpha_gap = float(((a_f - a_d).abs() / a_d).max())
    print(f"{small}'s embeddings, relative L2 gaps: flash vs dense bf16 "
          f"{gap:.3e}, dense bf16 vs f32 {noise:.3e}, flash vs f32 "
          f"{flash_f32:.3e}; max abs flash vs dense "
          f"{float((Zf - Zd).abs().max()):.3e} (max |Z| "
          f"{float(Zd.abs().max()):.3e}); alpha max relative gap "
          f"{alpha_gap:.3e}", flush=True)
    # two bf16 paths that each round about as much as the dense one does
    # against f32 differ by about sqrt(2) times that; 3x leaves room for
    # the flash path's rounding of P, and a wrong kernel is far beyond it
    if not gap <= 3.0 * noise:
        _fatal(f"flash vs dense embeddings {gap:.3e} > 3 x the bf16 "
               f"rounding noise {noise:.3e}")
    del Zf, Zd, Z32

    # the embed's device time an image (what the attention changes) and
    # its wall time, which the host's launching paces
    embed_ms, summed_ms, wall_ms = {}, {}, {}
    big = cats[-1]
    for tag, e in (("flash", emb), ("dense", dense),
                   ("flash_f32", f32_flash), ("dense_f32", f32)):
        e(images[big])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e(images[big])
        torch.cuda.synchronize()
        wall_ms[tag] = (time.perf_counter() - t0) * 1e3 / sizes[big]
        embed_ms[tag], summed_ms[tag] = _embed_device_ms(
            torch, e, images[big])
    n_img = sum(sizes.values())
    print(f"flash path: embed device busy {embed_ms['flash']:.3f} ms/image "
          f"(dense {embed_ms['dense']:.3f}, same weights, bf16, batch 8; "
          f"wall {wall_ms['flash']:.3f} and {wall_ms['dense']:.3f}); f32 "
          f"(precision highest) flash {embed_ms['flash_f32']:.3f} ms/image "
          f"(dense f32 {embed_ms['dense_f32']:.3f}; wall "
          f"{wall_ms['flash_f32']:.3f} and {wall_ms['dense_f32']:.3f}); "
          f"summed operation time flash {summed_ms['flash']:.3f}, dense "
          f"{summed_ms['dense']:.3f}, flash f32 {summed_ms['flash_f32']:.3f}"
          f", dense f32 {summed_ms['dense_f32']:.3f}; "
          f"sweep {n_img / sweep_s[-1]:.1f} img/s over {n_img} images "
          f"(sweeps {sweep_s} s)", flush=True)
    del f32, f32_flash
    busy = _profile_sweep(
        torch, lambda: run_category_sweep(root, cats, cfg, emb), sweep_s[-1])
    del emb, dense
    vith = phase_vith_flash(torch, dist, attn, images[small])
    return dict(launches=launches["flash_attention"], embed_ms=embed_ms,
                embed_summed_ms=summed_ms, embed_wall_ms=wall_ms,
                sweep_img_s=n_img / sweep_s[-1], busy_pct=busy,
                convert_s=convert_s, rel_gaps=[gap, noise, flash_f32],
                alpha_gap=alpha_gap, f32_gap=gap32,
                f32_launches=launches32[1], vith=vith)


def _seeded_vit_on_card(torch, cfg, seed: int):
    """A ViT of ``cfg`` in f32 on the card, its weights drawn there from
    ``seed`` with the distributions of models.vit.init_vit_params: normal
    of std 0.02 for the tokens and the linear weights (the init's bounds
    of 100 std never cut), 1 / sqrt(3 ps^2) for the patch projection, ones
    for the norms' weights, zeros for every bias."""
    from tpu_ac_torch.models.vit import ViT

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.device("cuda"):
        model = ViT(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "norm" in name:
                p.fill_(1.0)
            elif name == "patch_embed.proj.weight":
                p.normal_(0.0, (3 * cfg.patch_size ** 2) ** -0.5,
                          generator=gen)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model


def phase_vith_flash(torch, dist, attn, images) -> dict:
    """ViT-H/14 at full width (Dh 80, the wide kernel) through the
    pipeline's own entry: ``images`` (bottle's test images) embedded at
    224 px (257 tokens) by CategoryEmbedder(..., attention_impl="flash")
    in bf16, then compute_alpha_X; against the dense embed of the same
    weights in bf16 and in f32."""
    import copy

    from tpu_ac_torch.device import card_report
    from tpu_ac_torch.models.vit import ViTConfig
    from tpu_ac_torch.pipeline import (
        CategoryEmbedder,
        PipelineConfig,
        compute_alpha_X,
    )

    t_phase = time.perf_counter()
    vcfg = ViTConfig(**VITH14)
    model = _seeded_vit_on_card(torch, vcfg, CKPT_SEED)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    layers = (f"blocks.{vcfg.depth - 2}", f"blocks.{vcfg.depth - 1}")
    cfg = PipelineConfig(layers=layers, batch_size=8, precision="bfloat16")
    cfg32 = PipelineConfig(layers=layers, batch_size=8, precision="highest")
    n = images.shape[0]
    # the f32 embedder keeps the f32 weights; the bf16 ones cast a copy
    dense32 = CategoryEmbedder(model, cfg32, device="cuda",
                               attention_impl="dense")
    Z32 = dense32(images)
    del dense32
    bf16 = copy.deepcopy(model)
    del model
    flash = CategoryEmbedder(bf16, cfg, device="cuda", attention_impl="flash")
    dense = CategoryEmbedder(bf16, cfg, device="cuda", attention_impl="dense")
    want = vcfg.depth * math.ceil(n / cfg.batch_size)
    # the wide kernel at the shapes the embed gives it: full batches and the
    # last, smaller one
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h = cfg.batch_size, vcfg.num_heads
    s, dh = vcfg.num_patches + 1, vcfg.embed_dim // h
    for bb in sorted({b, n % b or b}, reverse=True):
        q, k, v = _packed_qkv(torch, gen, bb, h, s, dh, torch.bfloat16)
        _flash_check(torch, attn, q, k, v, None,
                     f"[{bb}, {h}, {s}, {dh}] (the ViT-H/14 path's shape)")
    dist.LAUNCHES = attn.LAUNCHES = attn.LAUNCHES_F32 = 0
    attn.LAUNCHES_WIDE = 0
    Zf = flash(images)
    torch.cuda.synchronize()
    launches = (attn.LAUNCHES, attn.LAUNCHES_WIDE, attn.LAUNCHES_F32)
    if launches != (want, want, 0):
        _fatal(f"the ViT-H/14 flash embed launched {launches} flash kernels "
               f"(all, wide, f32); want {want} of the wide bf16 kernel "
               f"({vcfg.depth} blocks x {want // vcfg.depth} batches)")
    Zd = dense(images)
    gap, noise = _rel_gap(torch, Zf, Zd), _rel_gap(torch, Zd, Z32)
    if not (Zf.shape == Zd.shape == Z32.shape and bool(
            torch.isfinite(Zf).all()) and gap <= VITH_GAP_FACTOR * noise):
        _fatal(f"ViT-H/14 flash vs dense embeddings: shapes "
               f"{tuple(Zf.shape)}, {tuple(Zd.shape)}, relative L2 "
               f"{gap:.3e} > {VITH_GAP_FACTOR} x the bf16 rounding noise "
               f"{noise:.3e}, or non-finite")
    dist.LAUNCHES = 0
    alpha, X = compute_alpha_X(Zf, "unsupervised", 1.0, precision="bf16")
    torch.cuda.synchronize()
    row_err = float((alpha.sum(1) - 1.0).abs().max())
    if dist.LAUNCHES != 1 or not (bool(torch.isfinite(alpha).all()) and bool(
            torch.isfinite(X).all())) or row_err > 1e-4 or tuple(
            alpha.shape) != tuple(Zf.shape[:2]):
        _fatal(f"ViT-H/14 alpha/X: {dist.LAUNCHES} min_dists launches "
               f"(want 1), alpha {tuple(alpha.shape)} rows off 1 by "
               f"{row_err:.2e}, or non-finite values")
    # device time an image (the median of 3), and the wall time beside it
    embed_ms, wall_ms = {}, {}
    for tag, e in (("flash", flash), ("dense", dense)):
        runs = []
        for _ in range(3):  # the median of 3 (one run varied 2x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e(images)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / n)
        wall_ms[tag] = sorted(runs)[1]
        embed_ms[tag] = sorted(_embed_device_ms(torch, e, images)[0]
                               for _ in range(3))[1]
    # the kernel's share: one call at the embed's shape, timed alone, times
    # the launches of the embed
    q, k, v = _packed_qkv(torch, gen, b, h, s, dh, torch.bfloat16)
    call_ms, _ = _time_ms(lambda: attn.flash_attention_impl(
        q, k, v, dh ** -0.5), reps=20, warmup=3)
    share = call_ms * want / (embed_ms["flash"] * n)
    card = card_report()
    phase_s = time.perf_counter() - t_phase
    print(f"ViT-H/14 flash path ({n_params / 1e6:.1f} M parameters seeded "
          f"on the card in {init_s:.1f} s): bottle, {n} images at "
          f"224 px, {want} launches of the wide bf16 kernel ([{b}, {h}, "
          f"{s}, {dh}]), 1 min_dists; embed device busy "
          f"{embed_ms['flash']:.3f} ms/image flash, {embed_ms['dense']:.3f} "
          f"dense (wall {wall_ms['flash']:.3f}, {wall_ms['dense']:.3f}); "
          f"the flash kernel "
          f"{call_ms:.4f} ms a call, {100 * share:.1f}% of the flash embed; "
          f"relative L2 flash vs dense bf16 {gap:.3e}, dense bf16 vs f32 "
          f"{noise:.3e} (bound {VITH_GAP_FACTOR} x); alpha rows off 1 by "
          f"{row_err:.2e}; {phase_s:.1f} s; card {card['line']}",
          flush=True)
    return dict(launches=want, embed_ms=embed_ms, embed_wall_ms=wall_ms,
                kernel_ms=call_ms,
                kernel_share=share, rel_gaps=[gap, noise], phase_s=phase_s)


def _d_bound(torch, mins, Z, bank):
    """Per entry of ``mins`` [I, J, P], how far another kernel's min
    distance from the same bf16 products may lie: its d2 agrees to
    tol = 1e-4 (|a|^2 + max|b|^2) (_check_agree), so the distance to
    min(sqrt(tol), tol / d), since |sqrt(x) - sqrt(y)| <= sqrt|x - y| and
    <= |x - y| / sqrt(y).  A mean over j of such entries moves by at most
    the mean of their bounds, a min by at most their max."""
    a2 = Z.square().sum(-1)  # [I, P]
    b2 = bank.square().sum(-1).amax(-1)  # [J]
    tol = D2_RTOL * (a2[:, None, :] + b2[None, :, None])
    return torch.minimum(tol.sqrt(), tol / mins.clamp_min(1e-30))


def _hold_w(torch, got, want, bound, label: str) -> float:
    """|got - want| <= bound everywhere; fatal past it, else returns the
    largest gap over its bound."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        _fatal(f"{label}: shape {tuple(got.shape)} or non-finite values")
    gap = (got - want).abs()
    worst = float((gap / bound).max())
    print(f"{label}: max |W gap| {float(gap.max()):.3e} (max W "
          f"{float(want.max()):.3e}), max gap / bound = {worst:.3e}",
          flush=True)
    if not worst <= 1.0:
        _fatal(f"{label}: W off by more than the 1e-4 rule on d2 allows")
    return worst


def phase_mesh_path(torch, dist, attn, work: str, root: str,
                    sizes: dict[str, int], dp: int = 2) -> dict:
    """The multi-device sweep on a virtual mesh of dp x cuda:0: dp embed
    and the triangle-sharded alpha through run_category_sweep (CLI
    defaults), then its W, embeddings and the other sharded schemes held
    to the single-device kernels'."""
    from tpu_ac_torch.data.mvtec import DatasetSplit, MVTecDataset
    from tpu_ac_torch.distributed import (
        Mesh,
        shard_batch,
        sharded_weight_distance_supervised,
        sharded_weight_distance_unsupervised,
    )
    from tpu_ac_torch.pipeline import (
        PipelineConfig,
        build_embedder_for_config,
        compute_alpha_X,
        run_category_sweep,
    )

    cats = list(sizes)
    mesh = Mesh(["cuda:0"] * dp)
    cfg = PipelineConfig(batch_size=8, precision="bfloat16")
    emb = build_embedder_for_config(cfg, device="cuda", mesh=mesh)
    if emb.mesh is not mesh:
        _fatal("the embedder did not take the mesh")
    out_dir = os.path.join(work, "out_mesh")
    # "auto" takes the flash kernel in bf16, on every shard of a batch
    want_flash = 12 * dp * sum(math.ceil(n / cfg.batch_size)
                               for n in sizes.values())
    sweep_s = []
    for _ in range(2):  # the first is warm-up; both are counted
        dist.LAUNCHES = dist.WINDOW_LAUNCHES = attn.LAUNCHES = 0
        t0 = time.perf_counter()
        for _c, _r in run_category_sweep(root, cats, cfg, emb,
                                         output_dir=out_dir):
            pass
        sweep_s.append(time.perf_counter() - t0)
        launches = {"min_dists_window": dist.WINDOW_LAUNCHES,
                    "min_dists_symmetric_rectangular": dist.LAUNCHES,
                    "flash_attention": attn.LAUNCHES}
        print(f"mesh sweep (dp={dp} on cuda:0): launches {launches}",
              flush=True)
        if launches != {"min_dists_window": dp * len(cats),
                        "min_dists_symmetric_rectangular": 0,
                        "flash_attention": want_flash}:
            _fatal(f"the mesh sweep launched {launches}; want "
                   f"{dp * len(cats)} window launches ({dp} a category), "
                   f"{want_flash} flash launches (12 blocks x {dp} shards "
                   f"x {want_flash // (12 * dp)} batches) and no other "
                   "kernel")
    window_launches = launches["min_dists_window"]
    _check_pickles(out_dir, cfg, "unsupervised", cats, sizes)

    # per category: the dp embeddings against one device's, the triangle W
    # against the symmetric kernel's without its self-term
    single = build_embedder_for_config(cfg, device="cuda", mesh=None)
    f32 = build_embedder_for_config(
        PipelineConfig(batch_size=8, precision="highest"), device="cuda",
        mesh=None)
    images = {c: MVTecDataset(root, classname=c, split=DatasetSplit.TEST)
              .load_all_images() for c in cats}
    w_worst, embed_gaps = 0.0, {}
    for c in cats:
        Z = emb(images[c])
        Z1 = single(images[c])
        gap, noise = _rel_gap(torch, Z, Z1), _rel_gap(torch, Z1,
                                                      f32(images[c]))
        embed_gaps[c] = gap
        print(f"{c}: dp embeddings vs one device, relative L2 {gap:.3e} "
              f"(one device bf16 vs f32 {noise:.3e})", flush=True)
        if not gap <= 3.0 * noise:
            _fatal(f"{c}: dp embeddings {gap:.3e} from one device's, over "
                   f"3 x the bf16 rounding noise {noise:.3e}")
        n = len(Z)
        z_sh, _ = shard_batch(mesh, Z)
        w_tri = torch.cat(sharded_weight_distance_unsupervised(
            mesh, z_sh, n_valid=n, precision="bf16"))[:n]
        mins = dist.min_dists_all_pairs(Z, Z, precision="bf16",
                                        symmetric=True)
        idx = torch.arange(n, device="cuda")
        w_sym = (mins.sum(1) - mins[idx, idx]) / (n - 1)
        per = _d_bound(torch, mins, Z, Z)
        w_worst = max(w_worst, _hold_w(
            torch, w_tri, w_sym,
            (per.sum(1) - per[idx, idx]) / (n - 1),
            f"{c} (N={n}): triangle W on the mesh vs the symmetric "
            "kernel's without the self-term"))
        if c == cats[0]:
            # the rect scheme and the sharded supervised path: the
            # rectangular kernel on the mesh
            w_rect = torch.cat(sharded_weight_distance_unsupervised(
                mesh, z_sh, n_valid=n, precision="bf16", scheme="rect"))[:n]
            _hold_w(torch, w_rect, mins.sum(1) / (n - 1),
                    per.sum(1) / (n - 1),
                    f"{c}: rect-scheme W on the mesh vs the symmetric "
                    "kernel's")
            train = MVTecDataset(root, classname=c,
                                 split=DatasetSplit.TRAIN).load_all_images()
            Zt = emb(train)
            w_sup = torch.cat(sharded_weight_distance_supervised(
                mesh, z_sh, Zt, precision="bf16"))[:n]
            mins_t = dist.min_dists_all_pairs(Z, Zt, precision="bf16")
            _hold_w(torch, w_sup, mins_t.amin(1),
                    _d_bound(torch, mins_t, Z, Zt).amax(1),
                    f"{c}: sharded supervised W vs the rectangular "
                    f"kernel's (J={len(Zt)})")
            a_m, _ = compute_alpha_X(Z, "supervised", 1.0, Zt,
                                     precision="bf16", use_mesh=True,
                                     mesh=mesh)
            a_1, _ = compute_alpha_X(Z, "supervised", 1.0, Zt,
                                     precision="bf16")
            print(f"{c}: supervised alpha on the mesh vs one device, max "
                  f"relative gap {float(((a_m - a_1).abs() / a_1).max()):.3e}",
                  flush=True)
            del train, Zt, mins_t, w_sup, w_rect
        del Z, Z1, z_sh, mins, per, w_tri, w_sym
    del single, f32

    # alpha ms a category on the mesh, and one profiled sweep
    alpha_ms = {}
    for c in cats:
        Z = emb(images[c])
        for rep in range(2):  # the first is warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compute_alpha_X(Z, "unsupervised", 1.0, precision="bf16",
                            use_mesh=True, mesh=mesh)
            torch.cuda.synchronize()
            alpha_ms[c] = (time.perf_counter() - t0) * 1e3
        del Z
    n_img = sum(sizes.values())
    print(f"mesh path (dp={dp} on cuda:0, ranks one after another): sweep "
          f"{n_img / sweep_s[-1]:.1f} img/s over {n_img} images (sweeps "
          f"{sweep_s} s), alpha " + ", ".join(
              f"{c} (N={sizes[c]}) {ms:.1f} ms" for c, ms in alpha_ms.items()),
          flush=True)
    busy = _profile_sweep(
        torch, lambda: run_category_sweep(root, cats, cfg, emb), sweep_s[-1])
    return dict(launches=window_launches, sweep_img_s=n_img / sweep_s[-1],
                alpha_ms=alpha_ms, w_gap_over_bound=w_worst, busy_pct=busy,
                embed_gaps=embed_gaps)


# the export phase's three artifacts: (tag, extra cli.export flags, extra
# serving-host flags, min_dists launches a category: (symmetric +
# rectangular, window)); the dp artifact's ranks share cuda:0
EXPORT_CASES = (
    ("unsupervised", [], ["--bench"], (1, 0)),
    ("supervised", ["--supervised", "supervised", "--precision", "bfloat16",
                    "--n_train_images", "32"], [], (1, 0)),
    ("dp2", ["--dp", "2"], ["--devices", "cuda:0", "cuda:0"], (0, 2)),
)
EXPORT_CAPACITY = 96  # bottle's 84 test images, padded to the 32-bucket
EXPORT_TRAIN = 32


def _served_z(torch, np, path: str, params_np: dict, images):
    """The artifact's embed program in this process, on the card, under
    the TF32 switches of its precision: Z [N, P, D] of ``images``."""
    from tpu_ac_torch.device import precision_scope
    from tpu_ac_torch.utils.export import load_exported

    progs = load_exported(path, device="cuda")
    meta = progs["meta"]
    dtype = getattr(torch, meta["param_dtype"])
    params = {k: torch.from_numpy(v).to("cuda", dtype)
              for k, v in params_np.items()}
    bs = meta["batch_size"] // meta.get("n_devices", 1)
    n = len(images)
    pad = np.zeros(((-n) % bs, *images.shape[1:]), images.dtype)
    full = torch.from_numpy(np.concatenate([images, pad])).cuda()
    with precision_scope(meta["precision"]), torch.inference_mode():
        z = torch.cat([progs["embed"](params, full[i:i + bs])
                       for i in range(0, len(full), bs)])
    return z[:n], meta


def _live_alpha_x(torch, tag: str, z, zt, meta):
    """The live alpha+X of the same Z: compute_alpha_X, or for the dp
    artifact the mesh path (triangle partials on 2 x cuda:0) on Z padded to
    the artifact's capacity, the placement the served ranks have."""
    from tpu_ac_torch.cluster.alpha import (
        alpha_from_weights,
        weighted_embedding,
    )
    from tpu_ac_torch.distributed import (
        Mesh,
        shard_batch,
        sharded_weight_distance_unsupervised,
    )
    from tpu_ac_torch.pipeline import compute_alpha_X

    n, prec, tau = len(z), meta["alpha_precision"], meta["tau"]
    if tag == "supervised":
        return compute_alpha_X(z, "supervised", tau, zt, precision=prec,
                               use_mesh=False, packed=True)
    if tag == "unsupervised":
        return compute_alpha_X(z, "unsupervised", tau, precision=prec,
                               use_mesh=False, packed=True)
    mesh = Mesh(["cuda:0"] * meta["n_devices"])
    z_pad = torch.cat([z, z.new_zeros(meta["n_images_capacity"] - n,
                                      *z.shape[1:])])
    z_sh, _ = shard_batch(mesh, z_pad)
    w = torch.cat(sharded_weight_distance_unsupervised(mesh, z_sh, n_valid=n,
                                                       precision=prec))
    alpha = alpha_from_weights(w, tau)
    return torch.cat([alpha, weighted_embedding(alpha, z_pad)], 1)[:n]


def _check_native(np) -> str:
    """The native host library (Hungarian, kNN, coreset) is built and
    loaded here, and solves an assignment as scipy does."""
    from scipy.optimize import linear_sum_assignment

    from tpu_ac_torch import native

    if native.get_lib() is None:
        _fatal("tpu_ac_torch.native: the host library did not build/load")
    cost = np.random.default_rng(5).uniform(size=(64, 64))
    assignment, total = native.hungarian(cost)
    rows, cols = linear_sum_assignment(cost)
    if not math.isclose(total, cost[rows, cols].sum(), rel_tol=1e-10):
        _fatal(f"native hungarian total {total} vs scipy "
               f"{cost[rows, cols].sum()}")
    return native.library_path(native._compiler())


def _serve(cmd: list[str], d: str, env: dict) -> subprocess.Popen:
    return subprocess.Popen(cmd, env=env, cwd=d, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _served(tag: str, proc: subprocess.Popen, t0: float) -> dict:
    """The serving host's JSON line, once its process has ended."""
    out, err = proc.communicate(timeout=600)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        _fatal(f"serving host ({tag}) exit {proc.returncode}:\n"
               f"{out[-3000:]}\n{err[-3000:]}")
    served = json.loads([ln for ln in out.splitlines()
                         if ln.startswith('{"serving"')][-1])["serving"]
    served["host_process_s"] = wall_s
    return served


def phase_export(torch, work: str, root: str, sizes: dict[str, int]) -> dict:
    """The serving export path (module docstring, phase 7): cli.export on
    the card, the serving host in a process of its own, held against the
    live path.  The unsupervised artifact is served (and timed) alone;
    the other two are served side by side while this process checks the
    first."""
    import copy

    import numpy as np

    from tpu_ac_torch.cli.export import main as cli_export
    from tpu_ac_torch.data.mvtec import DatasetSplit, MVTecDataset
    from tpu_ac_torch.device import card_report
    from tpu_ac_torch.distributed import Mesh
    from tpu_ac_torch.models.registry import load_backbone
    from tpu_ac_torch.pipeline import (
        CategoryEmbedder,
        PipelineConfig,
        compute_alpha_X,
    )

    t_start = time.perf_counter()
    so = _check_native(np)
    print(f"native host library loaded: {so}", flush=True)
    card = card_report()["line"]
    d = os.path.join(work, "export")
    os.makedirs(d)
    cat = "bottle"
    images = MVTecDataset(root, classname=cat,
                          split=DatasetSplit.TEST).load_all_images()
    train = MVTecDataset(root, classname=cat, split=DatasetSplit.TRAIN) \
        .load_all_images()[:EXPORT_TRAIN]
    n = len(images)
    paths = {k: os.path.join(d, f"{k}.npy") for k in ("images", "train")}
    np.save(paths["images"], images)
    np.save(paths["train"], train)
    params = os.path.join(d, "params.npy")
    host = os.path.join(HERE, "scripts", "serving_host_torch.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs, arts, cmds = {}, {}, {}
    for tag, export_flags, serve_flags, _ in EXPORT_CASES:
        arts[tag] = os.path.join(d, f"{tag}.tpuac")
        argv = ["--n_images", str(EXPORT_CAPACITY), "--output", arts[tag],
                *export_flags]
        if not runs:
            argv += ["--dump_params", params]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli_export(argv)
        runs[tag] = dict(export_s=time.perf_counter() - t0,
                         artifact_bytes=os.path.getsize(arts[tag]))
        cmds[tag] = [sys.executable, host, arts[tag], "--params", params,
                     "--images", paths["images"], "--out",
                     os.path.join(d, f"{tag}.npz"), *serve_flags]
        if tag == "supervised":
            cmds[tag] += ["--train_images", paths["train"]]
    params_np = np.load(params, allow_pickle=True).item()
    # the live embedders of the same weights: one seeded init, copied;
    # the dense attention, which the artifacts export
    model = load_backbone("dino_vitbase8")[0]
    live_emb = {}
    for tag, _, _, _ in EXPORT_CASES:
        prec = "bfloat16" if tag == "supervised" else "default"
        live_emb[tag] = CategoryEmbedder(
            copy.deepcopy(model), PipelineConfig(batch_size=8,
                                                 precision=prec),
            device="cuda", attention_impl="dense",
            mesh=Mesh(["cuda:0"] * 2) if tag == "dp2" else None)
    del model

    first = EXPORT_CASES[0][0]
    t0 = time.perf_counter()
    served = {first: _served(first, _serve(cmds[first], d, env), t0)}
    # the live path's embed + alpha of the same category, timed alone
    emb = live_emb[first]
    live_s = []
    for _ in range(4):  # the first is warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compute_alpha_X(emb(images), "unsupervised", 1.0, precision="f32",
                        use_mesh=False, packed=True).cpu()
        live_s.append(time.perf_counter() - t0)
    live_med = sorted(live_s[1:])[1]
    t0 = time.perf_counter()
    procs = {tag: _serve(cmds[tag], d, env) for tag, _, _, _ in
             EXPORT_CASES[1:]}
    for tag, _, _, (want_l, want_w) in EXPORT_CASES:
        if tag not in served:
            served[tag] = _served(tag, procs[tag], t0)
        s = served[tag]
        k = s["categories"]
        got = (s["launches"] / k, s["window_launches"] / k,
               s["plain_calls"])
        print(f"export {tag}: cli.export {runs[tag]['export_s']:.1f} s, "
              f"artifact {runs[tag]['artifact_bytes']:,} bytes; serving "
              f"host {s['host_process_s']:.1f} s (process), first category "
              f"{s['first_s']:.3f} s"
              + (f", {s['median_s']:.3f} s a category, "
                 f"{s['images_per_s']:.1f} images/s (the live embed + "
                 f"alpha {live_med:.3f} s)" if "median_s" in s else "")
              + f"; min_dists launches a category {got[0]:g} (window "
              f"{got[1]:g}), plain calls {got[2]} on {s['card']}",
              flush=True)
        if got != (want_l, want_w, 0):
            _fatal(f"the served {tag} artifact launched {got} (symmetric/"
                   f"rectangular, window a category; plain calls); want "
                   f"({want_l}, {want_w}, 0)")
        # Z: the artifact's embed program here against the live embedder
        z_srv, meta = _served_z(torch, np, arts[tag], params_np, images)
        z_live = live_emb[tag](images)
        zt_srv = zt_live = None
        if tag == "supervised":
            zt_srv = _served_z(torch, np, arts[tag], params_np, train)[0]
            zt_live = live_emb[tag](train)
        z_equal = bool(torch.equal(z_srv, z_live))
        z_gap = _rel_gap(torch, z_srv, z_live)
        # alpha and X: the served ones against the live path on the served
        # Z (one kernel: bit-equal) and on the live Z
        res = np.load(os.path.join(d, f"{tag}.npz"))
        p = meta["n_patches"]
        srv = torch.from_numpy(np.concatenate([res["alpha"], res["X"]], 1))
        same = _live_alpha_x(torch, tag, z_srv, zt_srv, meta).cpu()
        live = _live_alpha_x(torch, tag, z_live, zt_live, meta).cpu()
        ax_equal = bool(torch.equal(srv, same))
        a_gap = float((srv[:, :p] - live[:, :p]).abs().max())
        x_gap = float((srv[:, p:] - live[:, p:]).abs().max())
        print(f"export {tag} ({meta['precision']}): served Z "
              + ("bit-equal to" if z_equal else f"{z_gap:.3e} (relative L2) "
                 "from") + " the live embedder's; served alpha/X "
              + ("bit-equal to" if ax_equal else "NOT equal to")
              + f" the live path's on the served Z; against the live Z: "
              f"max |d alpha| {a_gap:.3e}, max |d X| {x_gap:.3e}",
              flush=True)
        if not ax_equal:
            _fatal(f"export {tag}: the served alpha/X differ from the live "
                   "path's on the same Z")
        if not z_equal and not z_gap <= ZOO_GAP_BOUND:
            _fatal(f"export {tag}: served Z {z_gap:.3e} from the live "
                   f"embedder's, over {ZOO_GAP_BOUND}")
        if not np.isfinite(srv.numpy()).all() or srv.shape != (n, p + 4096):
            _fatal(f"export {tag}: served alpha/X {tuple(srv.shape)}, "
                   "finite values wanted")
        runs[tag].update(host_process_s=s["host_process_s"],
                         first_s=s["first_s"], z_equal=z_equal, z_gap=z_gap,
                         alpha_gap=a_gap, x_gap=x_gap,
                         launches_per_category=got[0],
                         window_launches_per_category=got[1])
        if "median_s" in s:
            runs[tag].update(median_s=s["median_s"],
                             images_per_s=s["images_per_s"],
                             live_s=live_med)
        del z_srv, z_live, srv, same, live
    del live_emb
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_start
    print(f"export phase: {phase_s:.1f} s on {card}", flush=True)
    return dict(runs=runs, phase_s=phase_s, card=card)


# the flagship PatchCore recipe's category: MVTec bottle's 83 test images
# (20 good, 63 with defects) and 220 train images
PC_TRAIN = 220
PC_TEST = (("good", 20), ("broken_large", 20), ("broken_small", 22),
           ("contamination", 21))


def _make_patchcore_tree(work: str) -> str:
    from tpu_ac_torch.data.mvtec import make_synthetic_mvtec

    root = os.path.join(work, "mvtec_patchcore")
    for i, (anomaly, n) in enumerate(PC_TEST):
        make_synthetic_mvtec(root, classname="bottle", anomalies=(anomaly,),
                             n_per_anomaly=n,
                             n_train=PC_TRAIN if i == 0 else 0,
                             image_size=256, seed=10 + i)
    return root


def _check_results_csv(path: str) -> dict:
    """results.csv: the category's row and the Mean row, every AUROC and
    the PRO finite and in [0, 1]."""
    import csv

    with open(os.path.join(path, "results.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    keys = ["instance_auroc", "full_pixel_auroc", "anomaly_pixel_auroc",
            "full_pro"]
    if [r["dataset_name"] for r in rows] != ["mvtec_bottle", "Mean"] or \
            list(rows[0]) != ["dataset_name", *keys] or not all(
                0.0 <= float(r[k]) <= 1.0 for r in rows for k in keys):
        _fatal(f"patchcore results.csv incomplete or out of [0, 1]: {rows}")
    print(f"patchcore results.csv: {rows[0]}", flush=True)
    return {k: float(rows[0][k]) for k in keys}


def _knn_check(torch, np, q, bank, k: int) -> int:
    """knn on the card against a float64 search on the host: squared
    distances within 1e-4 of |q|^2 + max|b|^2 (_check_agree's rule), index
    sets equal wherever the k-th and (k+1)-th distances differ by more
    than that.  Returns the number of rows whose sets were compared."""
    from tpu_ac_torch.ops.distances import knn

    d2, idx = knn(q, bank, k)
    q64, b64 = q.double().cpu().numpy(), bank.double().cpu().numpy()
    full = ((q64 ** 2).sum(1)[:, None] + (b64 ** 2).sum(1)[None]
            - 2.0 * q64 @ b64.T)
    part = np.argpartition(full, k + 1, axis=1)[:, :k + 1]
    ref = np.take_along_axis(full, part, 1)
    order = np.argsort(ref, axis=1)
    ref, part = np.take_along_axis(ref, order, 1), np.take_along_axis(
        part, order, 1)
    tol = D2_RTOL * ((q64 ** 2).sum(1) + (b64 ** 2).sum(1).max())
    gap = np.abs(d2.cpu().numpy() - ref[:, :k]) / tol[:, None]
    clear = ref[:, k] - ref[:, k - 1] > tol
    same = (np.sort(idx.cpu().numpy(), 1) == np.sort(part[:, :k], 1)).all(1)
    print(f"patchcore knn on the card vs float64 on the host ({len(q)} "
          f"queries x {len(bank)} rows, k={k}): max |d2 gap| / tol = "
          f"{gap.max():.3e}, index sets equal on {int(same[clear].sum())} "
          f"of {int(clear.sum())} rows without a tie at the k-th place",
          flush=True)
    if not (gap.max() <= 1.0 and same[clear].all()):
        _fatal("patchcore knn disagrees with the float64 search")
    return int(clear.sum())


def phase_patchcore(torch, work: str) -> dict:
    """The flagship PatchCore recipe through tpu_ac_torch.cli.patchcore:
    wideresnet50 (seeded init) layer2 + layer3, 1024 -> 1024, patchsize 3,
    256 -> 224 px, 220 train / 83 test images, the CLI defaults (10%
    approximate greedy coreset, exact scorer, k = 5, batch 8) with
    --compute_pro; then fit and predict timed on the CLI's own builder,
    the coreset at k = 1 and 16, the predict's kNN, the checks of kNN,
    sharded kNN, coreset and blur against their plain versions, and one
    profiled fit + predict."""
    import numpy as np
    from scipy import ndimage

    from tpu_ac_torch.cli import patchcore as cli
    from tpu_ac_torch.data.mvtec import DatasetSplit, MVTecDataset
    from tpu_ac_torch.detect import ApproximateGreedyCoresetSampler
    from tpu_ac_torch.detect.sampler import _project
    from tpu_ac_torch.distributed import Mesh
    from tpu_ac_torch.ops.distances import knn, knn_sharded
    from tpu_ac_torch.ops.interpolate import interpolate_bilinear

    root = _make_patchcore_tree(work)
    out = os.path.join(work, "patchcore")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cli.main([out, "--data_path", root, "--subdatasets", "bottle",
              "--compute_pro"])
    cli_s = time.perf_counter() - t0
    metrics = _check_results_csv(out)

    # the CLI's own builder on its defaults, timed outside the CLI's run
    args = cli.build_parser().parse_args([out, "--data_path", root])
    pc = cli._build_patchcore("wideresnet50", ["layer2", "layer3"], args)
    train, test = (MVTecDataset(root, classname="bottle", split=sp)
                   .load_all_images()
                   for sp in (DatasetSplit.TRAIN, DatasetSplit.TEST))
    k = args.anomaly_scorer_num_nn

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    _, fit_s = timed(lambda: pc.fit(train))
    (scores, masks), predict_s = timed(lambda: pc.predict(test))
    bank = pc.anomaly_scorer.detection_features
    if not (np.isfinite(scores).all() and np.isfinite(masks).all()
            and masks.shape == (len(test), 224, 224)):
        _fatal("patchcore predict: non-finite scores or masks of the wrong "
               f"shape {masks.shape}")
    with torch.inference_mode():
        z, embed_s = timed(lambda: pc._embed_all(train))
        full = z.reshape(-1, z.shape[-1])
        del z
        coreset_s = {}
        for sb in (1, 16):
            sampler = ApproximateGreedyCoresetSampler(
                args.percentage, seed=args.seed, select_batch=sb)
            picked, coreset_s[sb] = timed(lambda: sampler.run(full))
            if picked.shape != bank.shape:
                _fatal(f"coreset of {picked.shape}, want {bank.shape}")
        q = pc._embed_all(test)
        q = q.reshape(-1, q.shape[-1])
        knn_ms, _ = _time_ms(lambda: knn(q, bank, k), reps=3)
        matmul_ms, _ = _time_ms(lambda: torch.matmul(q, bank.T), reps=3)
    m, n, d = q.shape[0], bank.shape[0], bank.shape[1]
    knn_flops = 2.0 * m * n * d
    knn_bound = max(knn_flops / PEAK_F32_FLOPS,
                    4.0 * (m * d + n * d + 2 * m * k) / PEAK_HBM_BYTES) * 1e3
    # the k = 1 loop streams the projected bank once a pick
    core_bound = len(bank) * full.shape[0] * 128 * 4 / PEAK_HBM_BYTES
    n_rows = full.shape[0]
    print(f"patchcore: CLI {cli_s:.1f} s incl. set-up; fit {fit_s:.3f} s "
          f"({len(train) / fit_s:.1f} img/s; embed {embed_s:.3f} s), predict "
          f"{predict_s:.3f} s ({len(test) / predict_s:.1f} img/s); bank "
          f"{n_rows} -> {len(bank)} rows; coreset k=1 {coreset_s[1]:.3f} s "
          f"(bytes bound {core_bound:.3f} s), select_batch 16 "
          f"{coreset_s[16]:.3f} s; knn {knn_ms:.2f} ms for {m} queries x {n}"
          f" x {d} (bound {knn_bound:.2f} ms, f32 FMA peak; its product "
          f"alone {matmul_ms:.2f} ms, {knn_flops / matmul_ms / 1e9:.1f} "
          f"TFLOP/s)", flush=True)

    # checks against plain versions on the same inputs
    clear = _knn_check(torch, np, q[:2048], bank, k)
    with torch.inference_mode():
        d6, i6 = knn(q, bank, k + 1)
        d_s, i_s = knn_sharded(q, bank, k, Mesh(["cuda:0"] * 2))
    tol = D2_RTOL * (q.square().sum(1) + bank.square().sum(1).max())
    no_tie = ((d6[:, 1:] - d6[:, :-1]) > tol[:, None]).all(1)
    d_gap = float(((d_s - d6[:, :k]).abs() / tol[:, None]).max())
    idx_ok = bool((i_s == i6[:, :k]).all(1)[no_tie].all())
    print(f"patchcore knn_sharded on 2 x cuda:0 vs knn: max |d2 gap| / tol "
          f"= {d_gap:.3e}, indices equal on "
          f"{int((i_s == i6[:, :k]).all(1).sum())} of {m} rows (all "
          f"{int(no_tie.sum())} rows without a near-tie required)",
          flush=True)
    if not (d_gap <= 1.0 and idx_ok):
        _fatal("patchcore knn_sharded disagrees with knn")
    with torch.inference_mode():
        proj = _project(full, 128, args.seed)[:16384].contiguous()
        sampler = ApproximateGreedyCoresetSampler(args.percentage,
                                                  seed=args.seed)
        n_sel = int(len(proj) * args.percentage)
        on_card = sampler._indices(proj, n_sel).cpu()
        on_cpu = sampler._indices(proj.cpu(), n_sel)
    if not torch.equal(on_card, on_cpu):
        first = int((on_card != on_cpu).nonzero()[0, 0])
        _fatal(f"coreset picks on the card differ from the CPU's from pick "
               f"{first} of {n_sel}")
    print(f"patchcore coreset at k=1 on {len(proj)} projected rows: the "
          f"card's {n_sel} picks equal the CPU's", flush=True)
    del full, proj
    with torch.inference_mode():
        grid = torch.from_numpy(pc.anomaly_scorer.predict(
            [q[:4 * 784]])[0]).reshape(4, 28, 28).cuda()
        seg = pc.anomaly_segmentor.segment(grid).cpu().numpy()
        up = interpolate_bilinear(grid[:, None], size=(224, 224))[:, 0]
    want = np.stack([ndimage.gaussian_filter(u, sigma=4.0)
                     for u in up.cpu().numpy()])
    seg_gap = float((np.abs(seg - want) / np.abs(want)).max())
    print(f"patchcore segmentor on the card vs scipy gaussian_filter of the "
          f"same bilinear grids (4 images): max relative gap {seg_gap:.3e}",
          flush=True)
    if not seg_gap <= 1e-5:
        _fatal("patchcore segmentor disagrees with scipy")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del q, d6, i6, d_s, i_s, grid
    busy = _profile_busy(torch, lambda: (pc.fit(train), pc.predict(test)),
                         fit_s + predict_s, "one fit + predict")
    return dict(cli_s=cli_s, fit_s=fit_s, predict_s=predict_s,
                fit_img_s=len(train) / fit_s,
                predict_img_s=len(test) / predict_s, embed_s=embed_s,
                bank_rows=[n_rows, len(bank)], coreset_s=coreset_s,
                knn_ms=knn_ms, knn_bound_ms=knn_bound, matmul_ms=matmul_ms,
                knn_rows_checked=clear, seg_gap=seg_gap, busy_pct=busy,
                peak_gib=peak_gib, metrics=metrics)


# The zoo: one registry name per family beside the ViT-B/8 and WRN50 of
# the earlier paths, each at its full registered width, tapped at two
# layers giving ~28 x 28 and ~14 x 14 grids at 224 px where the family has
# them (PatchCore's layer2 + layer3): AlexNet 27 + 13, Inception-v4 25 +
# 12, and the R50+ViT hybrid's one 7 x 7 token grid.
ZOO = (
    ("vgg19_bn", ("stage4", "stage5")),
    ("alexnet", ("conv2", "conv5")),
    ("densenet201", ("denseblock2", "denseblock3")),
    ("inception_v4", ("features.9", "features.17")),
    ("bninception", ("inception_3b", "inception_4d")),
    ("resnest50", ("layer2", "layer3")),
    ("resnetv2_50_bit", ("stage2", "stage3")),
    ("efficientnet_b7", ("stage3", "stage5")),
    ("efficientnetv2_l", ("stage3", "stage5")),
    ("mnasnet_a1", ("stage3", "stage5")),
    ("vit_r50", ("blocks.22", "blocks.23")),
    ("vit_swin_base", ("layers.1", "layers.2")),
    ("dino_xcit_medium_24_p8", ("blocks.22", "blocks.23")),
    ("vit_deit_distilled", ("blocks.10", "blocks.11")),
)
# The card against the CPU, both in f32 with TF32 off: max |gap| / max
# |value| of the [2, P, 4096] embedding.  Derivation: a K-term f32 dot
# product summed in another order moves by about sqrt(K) u (u = 2^-24;
# K <= 7 x 7 x 2048 here, so <= 1.9e-5 relative); cuDNN's Winograd and
# FFT algorithms for f32 convs can add up to ~10x that per layer; over
# the deepest trunk's ~100 dependent layers a random walk of such steps
# gives sqrt(100) x ~2e-5 x ~5 = 1e-3.  The tail is the same torch code on
# both sides.  A port error (a pad, a pool count, a mask) moves whole
# border rows by O(1), far above it.
ZOO_GAP_BOUND = 1e-3


def _zoo_cli(work: str, root: str) -> dict:
    """cli.main + cli.evaluate as a user runs them, each in a process of
    its own, on a family of this slice (dino_xcit_small_12_p8, the CLI
    defaults: blocks.10 + blocks.11, 2048 -> 4096, bf16, batch 8; the
    12-block model keeps the script inside its time limit)."""
    from tpu_ac_torch.pipeline import PipelineConfig

    out = os.path.join(work, "zoo_cli")
    name = "dino_xcit_small_12_p8"
    common = ["--path", root, "--output_dir", out, "--backbone_names", name,
              "--categories", "bottle"]
    env = dict(os.environ, PYTHONPATH=HERE)
    times = {}
    for stage, extra in (("main", []),
                         ("evaluate", ["--tau_list", "1.0",
                                       "--supervised_modes",
                                       "unsupervised"])):
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", f"tpu_ac_torch.cli.{stage}", *common,
             *extra], cwd=HERE, env=env, capture_output=True, text=True,
            timeout=300)
        times[stage] = time.perf_counter() - t0
        if run.returncode:
            print(run.stdout[-3000:], run.stderr[-3000:], sep="\n",
                  file=sys.stderr)
            _fatal(f"python -m tpu_ac_torch.cli.{stage} --backbone_names "
                   f"{name} exited {run.returncode}")
    _check_pickles(out, PipelineConfig(backbone_name=name), "unsupervised",
                   ["bottle"], {"bottle": 84})
    csv_path = os.path.join(out, "mvtec_ad", name, "unsupervised",
                            "blocks.10_blocks.11_2048_4096_tau_result.csv")
    with open(csv_path) as f:
        rows = [r.split(",") for r in f.read().splitlines()]
    scored = [r for r in rows if r[0] == "bottle"]
    if len(scored) != 1 or not all(math.isfinite(float(v))
                                   for v in scored[0][1:]):
        _fatal(f"{name} metrics CSV incomplete: {rows}")
    print(f"zoo CLI {name}: cli.main {times['main']:.1f} s, cli.evaluate "
          f"{times['evaluate']:.1f} s (processes of their own, set-up "
          f"included); bottle NMI/ARI/F1 {scored[0][1:]}", flush=True)
    return times


ZOO_FLASH_IMAGES = 16  # two batches of 8


def _zoo_flash_gaps(torch, emb, model, model32, cfg, images, name):
    """A zoo ViT's bf16 "auto" embedder ``emb`` (the flash kernel, one
    launch a block up to the deepest tap, a batch) against a "dense"
    embedder of the same bf16 ``model`` and the f32 dense embed of
    ``model32``: (flash vs dense bf16, dense bf16 vs f32) relative L2 gaps,
    the first within 3x the second, as the flash path holds the flash
    sweep."""
    import dataclasses

    from tpu_ac_torch.kernels import attention as attn
    from tpu_ac_torch.pipeline import CategoryEmbedder

    dense = CategoryEmbedder(model, cfg, device="cuda", mesh=None,
                             attention_impl="dense")
    f32 = CategoryEmbedder(model32, dataclasses.replace(
        cfg, precision="highest"), device="cuda", mesh=None)
    want = (max(cfg.embed_config.tap_indices) + 1) * math.ceil(
        len(images) / cfg.batch_size)
    before = attn.LAUNCHES
    z_flash = emb(images)
    torch.cuda.synchronize()
    launches = attn.LAUNCHES - before
    z_dense, z32 = dense(images), f32(images)
    gap, noise = _rel_gap(torch, z_flash, z_dense), _rel_gap(
        torch, z_dense, z32)
    if launches != want or not (bool(torch.isfinite(z_flash).all()) and
                                gap <= 3.0 * noise):
        _fatal(f"zoo {name}: the bf16 auto embed launched the flash kernel "
               f"{launches} times (want {want}); flash vs dense "
               f"{gap:.3e} against 3 x the bf16 rounding noise {noise:.3e}")
    return gap, noise


def phase_zoo(torch, dist, attn, work: str, root: str) -> dict:
    """Each ZOO name at full width on its seeded init: the card's f32
    embedding of 1 image against the CPU's; for a ViT, the bf16 "auto"
    embed (the flash kernel) against the dense bf16 one within 3x the bf16
    rounding noise (_zoo_flash_gaps); then the clustering sweep of
    the 84-image bottle category at the CLI defaults (bf16, batch 8,
    unsupervised, tau 1, 2048 -> 4096) with its pickles checked and its
    symmetric min_dists launches counted, embed ms/image, sweep img/s and
    the peak memory; then cli.main + cli.evaluate on an XCiT."""
    import copy
    import gc

    import numpy as np

    from tpu_ac_torch.data.mvtec import (
        DatasetSplit,
        MVTecDataset,
        normalize_on_device,
    )
    from tpu_ac_torch.device import precision_scope
    from tpu_ac_torch.features.embedding import EmbedConfig, embed_features
    from tpu_ac_torch.models.registry import load_backbone
    from tpu_ac_torch.pipeline import (
        CategoryEmbedder,
        PipelineConfig,
        run_category_sweep,
    )

    images = MVTecDataset(root, classname="bottle",
                          split=DatasetSplit.TEST).load_all_images()
    # one image: the CPU's f32 forward of a full-width trunk is the
    # phase's slowest part, and the script has a time limit
    x_cpu = normalize_on_device(torch.from_numpy(images[:1]))
    out = os.path.join(work, "zoo")
    rows = {}
    for name, taps in ZOO:
        t_start = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        model, _cfg, family = load_backbone(name, use_checkpoint=False)
        n_params = sum(t.numel() for t in model.state_dict().values())
        ecfg = EmbedConfig(layers=taps)
        with precision_scope("highest"), torch.inference_mode():
            z_cpu = embed_features(family, model, x_cpu, ecfg)
            model.to("cuda")
            z_card = embed_features(family, model, x_cpu.cuda(), ecfg).cpu()
        gap = float((z_card - z_cpu).abs().max() / z_cpu.abs().max())
        if not (z_card.shape == z_cpu.shape and gap <= ZOO_GAP_BOUND):
            _fatal(f"zoo {name}: the card's f32 embedding is "
                   f"{gap:.3e} (of max |value|) from the CPU's, bound "
                   f"{ZOO_GAP_BOUND}")
        n_patches = z_card.shape[1]
        cfg = PipelineConfig(backbone_name=name, layers=taps, batch_size=8,
                             precision="bfloat16")
        # the f32 weights, kept for a ViT's flash check below (an
        # embedder casts its model to bf16 in place)
        model32 = copy.deepcopy(model) if family == "vit" else None
        emb = CategoryEmbedder(model, cfg, device="cuda", mesh=None)
        flash_gaps = None
        if model32 is not None:
            flash_gaps = _zoo_flash_gaps(torch, emb, model, model32, cfg,
                                         images[:ZOO_FLASH_IMAGES], name)
            del model32
        emb(images)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb(images)
        torch.cuda.synchronize()
        embed_ms = (time.perf_counter() - t0) * 1e3 / len(images)
        dist.LAUNCHES = dist.WINDOW_LAUNCHES = attn.LAUNCHES = 0
        for _c, _r in run_category_sweep(root, ["bottle"], cfg, emb,
                                         output_dir=out):
            pass
        launches = dist.LAUNCHES
        # a ViT's bf16 "auto" embed takes the flash kernel: one launch a
        # block up to the deepest tap, a batch
        want_flash = 0 if family != "vit" else (
            max(cfg.embed_config.tap_indices) + 1) * math.ceil(
                len(images) / cfg.batch_size)
        if launches <= 0 or dist.WINDOW_LAUNCHES or \
                attn.LAUNCHES != want_flash:
            _fatal(f"zoo {name}: the sweep launched min_dists {launches} "
                   f"times (window {dist.WINDOW_LAUNCHES}, flash "
                   f"{attn.LAUNCHES}); want the symmetric kernel and "
                   f"{want_flash} flash launches")
        _check_pickles(out, cfg, "unsupervised", ["bottle"],
                       {"bottle": len(images)}, n_patches)
        t0 = time.perf_counter()
        for _c, _r in run_category_sweep(root, ["bottle"], cfg, emb):
            pass
        sweep_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows[name] = dict(family=family, taps=list(taps),
                          params=n_params, patches=n_patches,
                          embed_ms=embed_ms,
                          sweep_img_s=len(images) / sweep_s,
                          gap=gap, launches=launches, peak_gib=peak,
                          flash_gaps=flash_gaps,
                          phase_s=time.perf_counter() - t_start)
        print(f"zoo {name} ({family}, taps {', '.join(taps)} -> "
              f"{n_patches} patches): {n_params / 1e6:.1f} M params, embed "
              f"{embed_ms:.3f} ms/image (bf16, batch 8), sweep "
              f"{len(images) / sweep_s:.1f} img/s, card vs CPU f32 gap "
              f"{gap:.3e} (bound {ZOO_GAP_BOUND}), min_dists launches "
              f"{launches}, peak {peak:.2f} GiB, "
              + ("" if flash_gaps is None else
                 f"bf16 auto (flash) vs dense {flash_gaps[0]:.3e}, dense "
                 f"bf16 vs f32 {flash_gaps[1]:.3e} (relative L2), ")
              + f"{rows[name]['phase_s']:.1f} s", flush=True)
        del model, emb, z_cpu, z_card
        gc.collect()
        torch.cuda.empty_cache()
    cli_s = _zoo_cli(work, root)
    return dict(rows=rows, cli_s=cli_s)


DINO_BATCH = 64
DINO_IMAGES = 7 * DINO_BATCH  # 2 classes of 224 PNGs at 256 px
DINO_LR = 0.0005 * DINO_BATCH / 256  # the recipe's peak lr at batch 64
# The card against the CPU, one f32 step (TF32 off) at full width, batch
# 2: the loss's relative gap, and each parameter's gradient's ||gap|| /
# ||gradient||.  Derivation: on the CPU the f32 gradients of ViT-S/16
# (12 blocks, out_dim 4096, 64/32 px crops) sit at most 1.5e-6 from a
# float64 run (the loss 7.6e-9); the card's sums go in other orders, so
# the two f32 runs differ by about sqrt(2) of that, and the full width's
# longer sums (65536 logits, 197 tokens: 4-16x the terms) about 4x more:
# ~1e-5; 10x above that for cuBLAS's split-K orders.  An error of the
# port on the card (a wrong mask, cast or order of crops) moves whole
# gradients by O(1).
DINO_LOSS_GAP_BOUND = 1e-5
DINO_GRAD_GAP_BOUND = 1e-4


def _dino_recipe():
    """main_dino's defaults as tpu_ac.cli.dino parses them: ViT-S/16 on
    224 px globals, DINOConfig's head and crops."""
    import dataclasses

    from tpu_ac_torch.data.device_aug import DeviceAugConfig
    from tpu_ac_torch.models.vit import VIT_SMALL
    from tpu_ac_torch.train.dino import DINOConfig

    vit_cfg = dataclasses.replace(VIT_SMALL, patch_size=16, img_size=224)
    cfg = DINOConfig(epochs=100, steps_per_epoch=DINO_IMAGES // DINO_BATCH)
    return vit_cfg, cfg, DeviceAugConfig()


def _dino_step_flops(vit_cfg, cfg, batch: int) -> float:
    """Model FLOPs of one train step (2 a multiply-add): the student's
    forward over every crop and its backward (2x the forward), the
    teacher's forward over the globals.  A block costs 24 N D^2 + 4 N^2 D
    over N tokens, the patch projection 2 N_p (3 p^2) D, the head its four
    products.  Recomputation under --remat is not counted."""
    d, ps = vit_cfg.embed_dim, vit_cfg.patch_size

    def vit(size):
        n_p = (size // ps) ** 2
        n = n_p + 1
        return (vit_cfg.depth * (24 * n * d * d + 4 * n * n * d)
                + 2 * n_p * 3 * ps * ps * d)

    h, bn = cfg.head_hidden_dim, cfg.head_bottleneck_dim
    head = 2 * (d * h + h * h + h * bn + bn * cfg.out_dim)
    student = (2 * (vit(cfg.global_size) + head)
               + cfg.local_crops_number * (vit(cfg.local_size) + head))
    teacher = 2 * (vit(cfg.global_size) + head)
    return batch * (3 * student + teacher)


def _make_imagefolder(work: str, n_images: int = DINO_IMAGES) -> str:
    """2 classes of n_images / 2 PNGs at 256 px: seeded 16 x 16 noise,
    bicubic-upsampled (smooth, image-like), plus fine noise."""
    import numpy as np
    from PIL import Image

    root = os.path.join(work, "imagefolder")
    rng = np.random.default_rng(0)
    for c in ("a", "b"):
        os.makedirs(os.path.join(root, c))
        for i in range(n_images // 2):
            low = Image.fromarray(rng.integers(0, 256, (16, 16, 3),
                                               dtype=np.uint8))
            arr = np.asarray(low.resize((256, 256), Image.BICUBIC),
                             np.int16)
            arr = arr + rng.integers(-12, 13, arr.shape, dtype=np.int16)
            Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
                os.path.join(root, c, f"{i:03d}.png"))
    return root


def _dino_cli(work: str, root: str, tag: str, args: list[str],
              timeout: int = 300) -> dict:
    """python -m tpu_ac_torch.cli.dino as a user runs it, a process of its
    own; its dino_epoch lines, the losses of its log.txt (finite, one a
    epoch) and its last checkpoint checked; the output dir removed after
    (a checkpoint holds 0.7 GB at this width)."""
    out = os.path.join(work, "dino", tag)
    cmd = [sys.executable, "-m", "tpu_ac_torch.cli.dino", "--data_path",
           root, "--output_dir", out, "--saveckp_freq", "0", *args]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if run.returncode:
        print(run.stdout[-3000:], run.stderr[-3000:], sep="\n",
              file=sys.stderr)
        _fatal(f"python -m tpu_ac_torch.cli.dino ({tag}) exited "
               f"{run.returncode}")
    epochs = [json.loads(line.split(" ", 1)[1])
              for line in run.stdout.splitlines()
              if line.startswith("dino_epoch ")]
    with open(os.path.join(out, "log.txt")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in rows]
    last = os.path.join(out, f"checkpoint-{len(rows) - 1:08d}")
    with open(os.path.join(last, "meta.json")) as f:
        meta = json.load(f)
    if not (rows and len(epochs) == len(rows)
            and all(math.isfinite(v) for v in losses)
            and meta["extra"] == {"epoch": len(rows) - 1}
            and os.path.getsize(os.path.join(last, "arrays.npz")) > 1e8):
        _fatal(f"cli.dino ({tag}): log.txt {rows}, epochs {epochs}, "
               f"checkpoint meta {meta}")
    shutil.rmtree(out)
    print(f"cli.dino {tag}: {wall:.1f} s (set-up included), losses "
          f"{losses}, " + "; ".join(
              f"epoch {e['epoch']}: {e['steps']} steps, "
              f"{e['step_ms']:.2f} ms a step, loader wait "
              f"{e['data_wait_ms']:.2f} ms, peak {e['peak_gib']:.2f} GiB"
              for e in epochs), flush=True)
    return dict(epochs=epochs, losses=losses, wall_s=wall)


def _dino_card_vs_cpu(torch, base_u8) -> dict:
    """One f32 step (TF32 off) at full width and batch 2 on the CPU and
    on the card from one state and one set of crops (made on the CPU)."""
    from tpu_ac_torch.data.device_aug import device_multicrop
    from tpu_ac_torch.train.dino import (
        build_dino_model,
        dino_loss_and_grads,
        dino_state_from_numpy,
        dino_state_to_numpy,
        dino_update,
        init_dino_state,
    )
    from tpu_ac_torch.utils.checkpoint import tree_flatten

    vit_cfg, cfg, aug_cfg = _dino_recipe()
    model = build_dino_model(vit_cfg, cfg)
    cpu = init_dino_state(0, vit_cfg, cfg, device="cpu")
    card = dino_state_from_numpy(dino_state_to_numpy(cpu), device="cuda")
    g, l = device_multicrop(base_u8[:2], torch.Generator().manual_seed(0),
                            aug_cfg)
    temp = torch.tensor(cfg.teacher_temp)
    t0 = time.perf_counter()
    loss_c, t_c, grads_c = dino_loss_and_grads(model, cpu, g, l, temp, cfg)
    cpu_s = time.perf_counter() - t0
    loss_g, t_g, grads_g = dino_loss_and_grads(
        model, card, g.cuda(), l.cuda(), temp.cuda(), cfg)
    loss_gap = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    gaps = {k: float(torch.linalg.vector_norm(grads_g[k].cpu() - v)
                     / torch.linalg.vector_norm(v))
            for k, v in grads_c.items()}
    worst = max(gaps, key=gaps.get)
    if not (loss_gap <= DINO_LOSS_GAP_BOUND
            and gaps[worst] <= DINO_GRAD_GAP_BOUND):
        _fatal(f"dino card vs CPU: loss gap {loss_gap:.3e} (bound "
               f"{DINO_LOSS_GAP_BOUND}), gradient gap {gaps[worst]:.3e} at "
               f"{worst} (bound {DINO_GRAD_GAP_BOUND})")

    def update(state, grads, t_out, dev):
        def f(v):
            return torch.tensor(v, device=dev)

        return dino_update(state, grads, t_out, f(DINO_LR), f(0.04),
                           f(0.996), torch.tensor(False, device=dev), cfg)

    new_c = update(cpu, grads_c, t_c, "cpu")
    new_g = update(card, grads_g, t_g, "cuda")
    # the CPU's update of the card's gradients: the card's update alone
    new_x = update(cpu, {k: v.cpu() for k, v in grads_g.items()}, t_g.cpu(),
                   "cpu")
    upd_gap = step_gap = 0.0
    for a, x, c in zip(tree_flatten(new_g), tree_flatten(new_x),
                       tree_flatten(new_c)):
        a = a.cpu().double()
        upd_gap = max(upd_gap, float(((a - x.double()).abs()
                                      / (x.double().abs() + DINO_LR)).max()))
        step_gap = max(step_gap, float((a - c.double()).abs().max()))
    # Adam's first step moves an element by lr * (|g| / (|g| + eps) + wd
    # |p|), about lr * sign(g): elements whose gradient is near zero may
    # step either way on the two devices, so the states stay 2 lr apart
    # at most (|p| < 1 here)
    if upd_gap > 1e-5 or step_gap > 2 * DINO_LR * (1 + 0.04):
        _fatal(f"dino card vs CPU after the step: the card's update "
               f"{upd_gap:.3e} from the CPU's update of the same gradients "
               f"(bound 1e-5 of |value| + lr); states {step_gap:.3e} apart "
               f"(bound 2 lr = {2 * DINO_LR:.3e})")
    print(f"dino card vs CPU (f32, TF32 off, batch 2, full width): loss "
          f"{float(loss_g):.6f} vs {float(loss_c):.6f} (gap {loss_gap:.3e}, "
          f"bound {DINO_LOSS_GAP_BOUND}), worst gradient gap "
          f"{gaps[worst]:.3e} at {worst}, median "
          f"{sorted(gaps.values())[len(gaps) // 2]:.3e} (bound "
          f"{DINO_GRAD_GAP_BOUND}); update vs the CPU's update of the "
          f"card's gradients {upd_gap:.3e}; states after the step "
          f"{step_gap / DINO_LR:.3f} lr apart at most; CPU step "
          f"{cpu_s:.1f} s", flush=True)
    return dict(loss_gap=loss_gap, grad_gap=gaps[worst], upd_gap=upd_gap,
                step_gap_lr=step_gap / DINO_LR)


def _dino_profile(torch, base_u8) -> dict:
    """The train step in this process (device aug, bf16, batch 64): 2
    warm-up steps, 3 timed, 3 under torch.profiler; the aug alone."""
    from tpu_ac_torch.data.device_aug import device_multicrop
    from tpu_ac_torch.train.dino import (
        init_dino_state,
        make_dino_train_step,
        make_schedules,
        make_step_schedule_tables,
    )

    vit_cfg, cfg, aug_cfg = _dino_recipe()
    state = init_dino_state(0, vit_cfg, cfg, device="cuda")
    tables = make_step_schedule_tables(cfg, make_schedules(cfg, DINO_BATCH),
                                       "cuda")
    step = make_dino_train_step(vit_cfg, cfg, compute_dtype=torch.bfloat16,
                                resident_schedules=True)
    raw = base_u8[:DINO_BATCH].cuda()
    gen = torch.Generator(device="cuda")

    def steps(n):
        nonlocal state
        for i in range(n):
            gen.manual_seed(i)
            g, l = device_multicrop(raw, gen, aug_cfg)
            state, m = step(state, g, l, tables)
        torch.cuda.synchronize()
        if not math.isfinite(float(m["loss"])):
            _fatal(f"dino profile: loss {float(m['loss'])}")

    steps(2)
    t0 = time.perf_counter()
    steps(3)
    wall_s = time.perf_counter() - t0
    # one step from an idle card: the host's time to queue it against the
    # time until the card has run it (equal where the host sets the pace)
    t0 = time.perf_counter()
    gen.manual_seed(0)
    state, _ = step(state, *device_multicrop(raw, gen, aug_cfg), tables)
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    busy = _profile_busy(torch, lambda: steps(3), wall_s,
                         "3 DINO steps (ViT-S/16, batch 64, bf16, device "
                         "aug)")
    # one call: its ~900 launches fit in the card's queue behind the sleep
    aug_ms, aug_host_ms = _time_ms(
        lambda: device_multicrop(raw, gen, aug_cfg), 1)
    print(f"dino in-process: {wall_s * 1e3 / 3:.2f} ms a step (host clock, "
          f"synchronised); one step from an idle card queued in "
          f"{queue_ms:.2f} ms on the host, done after {one_ms:.2f} ms; "
          f"device aug alone {aug_ms:.2f} ms on the card, "
          f"{aug_host_ms:.2f} ms to queue on the host", flush=True)
    del state
    return dict(inproc_step_ms=wall_s * 1e3 / 3, busy_pct=busy,
                queue_ms=queue_ms, one_step_ms=one_ms, aug_ms=aug_ms,
                aug_host_ms=aug_host_ms)


def phase_dino(torch, work: str) -> dict:
    """DINO pre-training at main_dino's recipe through cli.dino (see the
    module docstring, phase 10)."""
    import numpy as np

    from tpu_ac_torch.data.device_aug import build_base_cache
    from tpu_ac_torch.data.imagefolder import ImageFolder

    t_start = time.perf_counter()
    vit_cfg, cfg, _ = _dino_recipe()
    flops = _dino_step_flops(vit_cfg, cfg, DINO_BATCH)
    root = _make_imagefolder(work)
    cache = os.path.join(work, "dino_cache")
    base = torch.from_numpy(np.array(build_base_cache(
        ImageFolder(root), 256, cache)[:DINO_BATCH]))
    dev_aug = ["--device_aug", "--data_cache", cache]

    timed_args = dev_aug + ["--epochs", "2", "--max_steps_per_epoch", "6"]
    timed = _dino_cli(work, root, "timed", timed_args)
    e1 = timed["epochs"][1]
    step_s = e1["step_ms"] / 1e3
    crops = DINO_BATCH * cfg.ncrops
    print(f"dino timed (epoch 1, {e1['steps']} steps, {e1['device']}): "
          f"{e1['step_ms']:.2f} ms a step, {DINO_BATCH / step_s:.1f} "
          f"images/s, {crops / step_s:.1f} crops/s, "
          f"{flops / 1e12:.3f} TFLOP a step = "
          f"{100 * flops / step_s / PEAK_BF16_FLOPS:.2f}% of the dense bf16 "
          f"peak, peak {e1['peak_gib']:.2f} GiB", flush=True)

    n_cpu = os.cpu_count()
    pil = _dino_cli(work, root, "pil", ["--num_workers", str(n_cpu),
                                        "--epochs", "1",
                                        "--max_steps_per_epoch", "3"])
    p0 = pil["epochs"][0]
    print(f"dino PIL path ({n_cpu} CPUs, {n_cpu} workers): "
          f"{p0['step_ms']:.2f} ms a step, the step waits "
          f"{p0['data_wait_ms']:.2f} ms a step on the loader", flush=True)

    # the flag runs against the timed run (not a plain run of their own:
    # the script's time limit)
    flags = {}
    for tag, extra in (("k2", ["--steps_per_dispatch", "2"]),
                       ("remat", ["--remat", "true"])):
        run = _dino_cli(work, root, tag, timed_args + extra)
        if run["losses"] != timed["losses"]:
            _fatal(f"cli.dino {' '.join(extra)}: epoch losses "
                   f"{run['losses']}, the timed run's {timed['losses']}: "
                   "the same kernels on the same crops must give the same "
                   "bits")
        flags[tag] = run
    print(f"dino flags: --steps_per_dispatch 2 and --remat true epoch "
          f"losses bit-equal to the timed run's {timed['losses']}; peak "
          f"{flags['remat']['epochs'][1]['peak_gib']:.2f} GiB with --remat "
          f"against {e1['peak_gib']:.2f} GiB without; step "
          f"{flags['remat']['epochs'][1]['step_ms']:.2f} against "
          f"{e1['step_ms']:.2f} ms", flush=True)

    prof = _dino_profile(torch, base)
    gaps = _dino_card_vs_cpu(torch, base)
    phase_s = time.perf_counter() - t_start
    print(f"dino phase: {phase_s:.1f} s", flush=True)
    return dict(step_ms=e1["step_ms"], img_s=DINO_BATCH / step_s,
                crops_s=crops / step_s, tflop=flops / 1e12,
                peak_pct=100 * flops / step_s / PEAK_BF16_FLOPS,
                peak_gib=e1["peak_gib"], cli_s=timed["wall_s"],
                pil_step_ms=p0["step_ms"], pil_wait_ms=p0["data_wait_ms"],
                cpus=n_cpu,
                remat_peak_gib=flags["remat"]["epochs"][1]["peak_gib"],
                plain_peak_gib=e1["peak_gib"],
                remat_step_ms=flags["remat"]["epochs"][1]["step_ms"],
                plain_step_ms=e1["step_ms"],
                phase_s=phase_s, **prof, **gaps)



# The SCAN recipe: tpu_ac/configs/{pretext,scan,selflabel}/*cifar-10.yml
# with epochs 1 (every batch size, width and option as shipped), on a
# synthetic CIFAR-10 in its real format, cut from 50,000 train and 10,000
# test images to SCAN_TRAIN and SCAN_TEST for the time limit: the stages
# are host-bound (the augmentation and the dispatch), and on an H100 the
# phase took 315 s at 50,000, 223-245 s at 20,000 and 176.4 s at 10,000
# (the stages 25-30 s each as processes); 5,000 keeps the script with the
# export phase inside 900 s.  Mining is timed at the full bank,
# SCAN_BANK_ROWS x 128.
SCAN_TRAIN = 5_000
SCAN_TEST = 1_000
SCAN_BANK_ROWS = 50_000
SCAN_CLASSES = 10
SCAN_AUG_IMAGES = 512
SCAN_EXPS = ("pretext/simclr_cifar-10.yml", "scan/scan_cifar-10.yml",
             "selflabel/selflabel_cifar-10.yml")
# MoCo transfer: a synthetic ImageFolder of SCAN_MOCO_WNIDS classes at
# 256 px (224 px crops), SCAN_MOCO_TRAIN + SCAN_MOCO_VAL images a class
SCAN_MOCO_WNIDS = 4
SCAN_MOCO_TRAIN = 32
SCAN_MOCO_VAL = 8
SCAN_MOCO_SEED = 1  # not the CLI's init seed: a failed load cannot pass
# Card against CPU, one f32 step of each kind (TF32 off) at full width,
# from one state and one batch: SimCLR at 32 pairs, SCAN at 32 anchors +
# 32 neighbours (full and head-only), self-label at 64 weak + 64 strong.
# A float64 run on the CPU is the reference, since ResNet-18's f32
# gradients through train-mode BatchNorm are ill-conditioned (this phase
# prints the card's and the CPU's gaps to it, relative L2 per parameter).
# The card is held to the CPU's own error: the loss, each parameter's
# gradient, the whole gradient and each running statistic no further from
# float64 than twice the CPU's f32 gap, or
# SCAN_LOSS_GAP_BOUND, SCAN_GRAD_GAP_BOUND, SCAN_GLOBAL_GRAD_BOUND and
# SCAN_BN_GAP_BOUND of its norm where the CPU's gap is smaller (the CPU
# sums BatchNorm's batch reductions in float64, the card's cuDNN in
# f32).  SCAN's loss is a sum over 10 heads of consistency - w entropy,
# terms near 4.6 that cancel to near 0 (-0.25 in one run, 0.0114 in
# another), so its floor is SCAN_LOSS_GAP_BOUND of the terms' magnitude,
# sum over heads of |consistency| + w |entropy| in float64, and not of
# the loss: on an H100 the card's f32 loss sat 1.07e-6 from float64,
# 9.4e-5 of a loss of 0.0114, which a floor of 1e-5 of the loss failed.
# The per-parameter floor is
# 1e-2: a BN parameter's gradient is a sum over the batch and the pixels
# (64 x 4 x 4 terms at layer4, 64 x 32 x 32 at layer1) that nearly
# cancels, and on an H100 the card's f32 sums sat up to 4.3e-3 from
# float64 there (layer4.1.bn1.bias) where the CPU's sat at 2.4e-6; the
# card's conv weight gradients sat up to 1.7e-4 (cuDNN may take another
# algorithm than a GEMM, which rounds more).  An error of the port on the
# card (a mask, a BN mode, a missing head) moves whole gradients by O(1).
# The states after the step: SGD (SimCLR, self-label) moves a parameter
# by lr x its gradient (+ lr wd p, the same on both), so the states
# differ by lr x the gradients' gap (+ 1e-6 of |p| for the rounding of
# p + u); Adam (SCAN) by up to 2 lr where a gradient is near 0 (its first
# step is about lr sign(g)), as in the DINO phase.
SCAN_LOSS_GAP_BOUND = 1e-5
SCAN_GRAD_GAP_BOUND = 1e-2
SCAN_GLOBAL_GRAD_BOUND = 1e-3
SCAN_BN_GAP_BOUND = 1e-5
SCAN_VS_CPU_BATCH = {"simclr": 32, "scan": 32, "selflabel": 64}
SELFLABEL_FALLBACK_THRESHOLDS = (0.95, 0.9, 0.8, 0.5)
# processes of the CLI: (stage, exp) in the order a user runs them
SCAN_DEVICE = "cuda"


def _make_cifar10(work: str) -> str:
    """A synthetic CIFAR-10 in the real cifar-10-batches-py/ pickle format
    (5 train batches + test_batch, uint8 [N, 3072] CHW rows, labels):
    each class a seeded base colour and a smooth 8 x 8 pattern, each image
    its own smooth 4 x 4 pattern and pixel noise; made from one numpy
    seed."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(0)
    base = rng.integers(40, 216, (SCAN_CLASSES, 1, 1, 3))
    pattern = np.kron(rng.integers(-40, 41, (SCAN_CLASSES, 8, 8, 1)),
                      np.ones((1, 4, 4, 3), np.int64))
    root = os.path.join(work, "scan_data")
    batches = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(batches)

    def write(name, n):
        labels = rng.integers(0, SCAN_CLASSES, n)
        # an image's own smooth 4 x 4 pattern over its class's look, so
        # that images differ as instances, not only by pixel noise
        own = np.kron(rng.integers(-40, 41, (n, 4, 4, 3)),
                      np.ones((1, 8, 8, 1), np.int64))
        imgs = (base[labels] + pattern[labels] + own
                + rng.integers(-20, 21, (n, 32, 32, 3)))
        data = np.clip(imgs, 0, 255).astype(np.uint8).transpose(
            0, 3, 1, 2).reshape(n, 3072)
        with open(os.path.join(batches, name), "wb") as f:
            pickle.dump({b"data": data, b"labels": labels.tolist()}, f)

    for i in range(5):
        write(f"data_batch_{i + 1}", SCAN_TRAIN // 5)
    write("test_batch", SCAN_TEST)
    return root


def _make_moco_tree(work: str) -> tuple[str, str]:
    """<root>/{train,val}/<wnid>/*.png at 256 px and a subset file."""
    import numpy as np
    from PIL import Image

    root = os.path.join(work, "moco_data")
    rng = np.random.default_rng(1)
    wnids = [f"n0100000{i}" for i in range(SCAN_MOCO_WNIDS)]
    for split, n in (("train", SCAN_MOCO_TRAIN), ("val", SCAN_MOCO_VAL)):
        for ci, wnid in enumerate(wnids):
            d = os.path.join(root, split, wnid)
            os.makedirs(d)
            for i in range(n):
                low = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                low[..., ci % 3] = 255 - 40 * (ci // 3)
                arr = np.asarray(Image.fromarray(low).resize(
                    (256, 256), Image.BICUBIC), np.int16)
                arr = arr + rng.integers(-12, 13, arr.shape, dtype=np.int16)
                Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
                    os.path.join(d, f"{i:03d}.png"))
    subset = os.path.join(root, "subset.txt")
    with open(subset, "w") as f:
        f.writelines(f"{w} class_{i}\n" for i, w in enumerate(wnids))
    return root, subset


def _scan_cli(stage: str, env: str, exp: str, timeout: int = 600) -> dict:
    """python -m tpu_ac_torch.cli.scan STAGE as a user runs it, a process
    of its own; its scan_epoch, scan_mining and scan_stage lines."""
    cmd = [sys.executable, "-m", "tpu_ac_torch.cli.scan", stage,
           "--config_env", env, "--config_exp", exp, "--device", SCAN_DEVICE]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if run.returncode:
        print(run.stdout[-3000:], run.stderr[-3000:], sep="\n",
              file=sys.stderr)
        _fatal(f"python -m tpu_ac_torch.cli.scan {stage} exited "
               f"{run.returncode}")
    return _scan_lines(stage, run.stdout, wall, "as a process")


def _scan_lines(stage: str, stdout: str, wall: float, how: str) -> dict:
    """A stage's scan_epoch, scan_mining and scan_stage lines, printed
    short."""
    out = {"epochs": [], "mining": [], "stage": None, "wall_s": wall}
    for line in stdout.splitlines():
        tag, _, rest = line.partition(" ")
        if tag == "scan_epoch":
            out["epochs"].append(json.loads(rest))
        elif tag == "scan_mining":
            out["mining"].append(json.loads(rest))
        elif tag == "scan_stage":
            out["stage"] = json.loads(rest)
    if out["stage"] is None:
        _fatal(f"cli.scan {stage}: no scan_stage line in\n"
               f"{stdout[-2000:]}")
    for e in out["epochs"]:
        print(f"cli.scan {stage} epoch {e['epoch']} ({e['device']}): "
              f"{e['steps']} steps of {e['images_per_step']:.0f} images, "
              f"{e['step_ms']:.2f} ms a step (host clock "
              f"{e['wall_step_ms']:.2f}), {e['images_s']:.1f} images/s, "
              f"loader wait {e['data_wait_ms']:.2f} ms a step, peak "
              f"{e['peak_gib'] or 0:.2f} GiB", flush=True)
    for m in out["mining"]:
        print(f"cli.scan {stage} mining ({m['stage']}): {m['rows']} x "
              f"{m['dim']}, top-{m['topk'] + 1}, {m['ms']:.2f} ms (host "
              f"clock, the index copy included), neighbour accuracy "
              f"{m['accuracy']:.4f}", flush=True)
    print(f"cli.scan {stage}: {wall:.1f} s {how} (set-up included), "
          f"stage {json.dumps(out['stage'])}", flush=True)
    return out


def _scan_moco(torch, work: str) -> dict:
    """The moco stage on RESNET50_IMAGENET at 224 px from a MoCo-v2-format
    .pth of a seeded init (module.encoder_q.* keys, fc.0/fc.2 for the
    head, the key encoder, the queue and a BN counter that the loader
    drops); the pretext model it saves must equal the .pth."""
    import numpy as np

    from tpu_ac_torch.config import CONFIG_DIR
    from tpu_ac_torch.models.resnet_cifar import RESNET50_IMAGENET
    from tpu_ac_torch.train import scan as ts
    from tpu_ac_torch.utils import latest_checkpoint, restore_checkpoint

    root, subset = _make_moco_tree(work)
    mcfg = ts.SCANModelConfig(backbone=RESNET50_IMAGENET, feature_dim=128,
                              n_clusters=SCAN_MOCO_WNIDS)
    p, bn = ts.init_contrastive_model(SCAN_MOCO_SEED, mcfg, "cpu")
    sd = {}
    for k, v in {**p, **bn}.items():
        name = ("fc." + k[len("contrastive_head."):]
                if k.startswith("contrastive_head.") else k)
        sd["module.encoder_q." + name] = v
    sd["module.encoder_q.bn1.num_batches_tracked"] = torch.tensor(7)
    sd["module.encoder_k.conv1.weight"] = torch.zeros_like(p["conv1.weight"])
    sd["module.queue"] = torch.zeros(128, 16)
    pth = os.path.join(work, "moco_v2_seeded.pth.tar")
    torch.save({"state_dict": sd, "epoch": 800, "arch": "resnet50"}, pth)
    with open(os.path.join(CONFIG_DIR, "pretext",
                           "moco_imagenet_50.yml")) as f:
        text = f.read()
    exp = os.path.join(work, "moco_exp.yml")
    with open(exp, "w") as f:
        f.write(text.replace("\nnum_classes:", "\n# recipe num_classes:")
                .replace("\nmoco_checkpoint:", "\n# moco_checkpoint:")
                + f"num_classes: {SCAN_MOCO_WNIDS}\nmoco_checkpoint: {pth}\n"
                f"subset_file: {subset}\n")
    out_root = os.path.join(work, "moco_out")
    env = os.path.join(work, "moco_env.yml")
    with open(env, "w") as f:
        f.write(f"root_dir: {out_root}\ndata_root: {root}\n")
    # in this process (the stage function cli.scan's main calls): a
    # process's start costs the phase more than the stage's own work
    from tpu_ac_torch.cli import scan as cli
    from tpu_ac_torch.config import create_config

    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        cli.run_moco(create_config(env, exp), SCAN_DEVICE)
    run = _scan_lines("moco", text.getvalue(), time.perf_counter() - t0,
                      "in this process")
    base = os.path.join(out_root, "imagenet_50")
    q, qbn = ts.init_contrastive_model(0, mcfg, "cpu")
    got, _ = restore_checkpoint(latest_checkpoint(
        os.path.join(base, "pretext"), "model"), {"params": q, "bn": qbn})
    wrong = [k for k, v in {**p, **bn}.items()
             if not torch.equal(v, {**got["params"], **got["bn"]}[k])]
    n_train = SCAN_MOCO_WNIDS * SCAN_MOCO_TRAIN
    n_val = SCAN_MOCO_WNIDS * SCAN_MOCO_VAL
    tr = np.load(os.path.join(base, "top50-train-neighbors.npy"))
    va = np.load(os.path.join(base, "top5-val-neighbors.npy"))
    if wrong or tr.shape != (n_train, 51) or va.shape != (n_val, 6):
        _fatal(f"cli.scan moco: {len(wrong)} loaded tensors differ from the "
               f".pth ({wrong[:3]}); neighbours {tr.shape}, {va.shape}")
    print(f"cli.scan moco: the pretext model equals the .pth in all "
          f"{len(p) + len(bn)} tensors (the 3 extra keys dropped); "
          f"{n_train} + {n_val} images at 224 px mined", flush=True)
    return dict(stage_s=run["stage"]["seconds"], cli_s=run["wall_s"],
                mining_ms=[m["ms"] for m in run["mining"]],
                neighbor_accuracy=run["stage"]["neighbor_accuracy"])


def _cifar_resnet_flops(cfg, size: int) -> float:
    """Forward FLOPs of one image through a basic-block CIFAR ResNet (2 a
    multiply-add): every conv; BN, the pool and the elementwise ops not
    counted."""
    hw, in_c = size, 3
    flops = 2.0 * in_c * cfg.widths[0] * 9 * hw * hw
    in_c = cfg.widths[0]
    for li, (n, w) in enumerate(zip(cfg.block_counts, cfg.widths)):
        for b in range(n):
            stride = 2 if (li > 0 and b == 0) else 1
            hw //= stride
            flops += 2 * hw * hw * (in_c + w) * w * 9
            if in_c != w or stride == 2:
                flops += 2 * hw * hw * in_c * w
            in_c = w
    return flops


def _scan_card_vs_cpu(torch, ds, cfg) -> dict:
    """One f32 step of each kind (TF32 off) at full width on the CPU and on
    the card from one state and one batch (augmented on the host)."""
    from tpu_ac_torch.cli import scan as cli
    from tpu_ac_torch.data.augment import (
        SimCLRAugmentation,
        StrongAugmentation,
        WeakAugmentation,
    )
    from tpu_ac_torch.device import precision_scope
    from tpu_ac_torch.train import optim
    from tpu_ac_torch.train import scan as ts
    from tpu_ac_torch.utils import latest_checkpoint, restore_checkpoint

    mcfg = cli._model_config(cfg)
    one = cli._single_head(cfg)
    pool = _aug_pool(8)
    sim = SimCLRAugmentation(32, seed=0)

    def views(aug, n, stream, first=0):
        return torch.from_numpy(pool.stack(aug, ds.get_pil,
                                           range(first, first + n),
                                           stream=stream))

    def restored(name, template):
        ckpt = latest_checkpoint(os.path.join(cfg.root_dir, cfg.db, name),
                                 "model")
        return restore_checkpoint(ckpt, template)

    # the states: SimCLR from the seeded init; SCAN from the pretext
    # model as run_scan loads it; self-label from the SCAN model's best
    # head as run_selflabel loads it
    p, bn = ts.init_contrastive_model(0, mcfg, "cpu")
    cp, cbn = ts.init_clustering_model(0, mcfg, "cpu")
    pre, _ = restored("pretext", {"params": p, "bn": bn})
    cp = {**cp, **{k: v for k, v in pre["params"].items()
                   if not k.startswith("contrastive_head")}}
    scan_params, scan_bn = cp, dict(pre["bn"])
    sc, meta = restored("scan", {"params": cp, "bn": cbn})
    best = meta["extra"]["best_head"]
    sl = {k: v for k, v in sc["params"].items()
          if not k.startswith("cluster_head")}
    sl["cluster_head.0.weight"] = sc["params"][f"cluster_head.{best}.weight"]
    sl["cluster_head.0.bias"] = sc["params"][f"cluster_head.{best}.bias"]
    bsz = SCAN_VS_CPU_BATCH
    # self-label's mask: a row whose confidence lies within the two
    # devices' noise of the threshold could flip it, so the batch is the
    # first of the split's batches whose rows all lie 1e-4 or more from it
    # (on the CPU), with at least one row over it.  After one epoch of
    # each stage few rows pass 0.99 (train-mode BN, so the batch is
    # searched whole): the first 8 batches of 64 held none in one run, and
    # the whole split none in another.  So the threshold is the first of
    # the recipe's and SELFLABEL_FALLBACK_THRESHOLDS for which a batch
    # qualifies: the same step and mask, the loaded head unchanged (the
    # dist phase's head, scaled by 8 so that rows pass, puts the card's
    # f32 gradient 3-4e-3 from float64, over SCAN_GLOBAL_GRAD_BOUND).
    # Each batch is passed through the model once.
    n_sl = bsz["selflabel"]
    confs = {}

    def qualifies(first, thr):
        if first not in confs:
            weak = views(WeakAugmentation(32, seed=0), n_sl, "w", first)
            with torch.no_grad():
                confs[first] = (weak, torch.softmax(ts.clustering_forward(
                    sl, sc["bn"], weak, one, train=True)[0][0], 1).amax(1))
        conf = confs[first][1]
        return (conf - thr).abs().min() >= 1e-4 and (conf > thr).any()

    thresholds = (cfg.confidence_threshold, *SELFLABEL_FALLBACK_THRESHOLDS)
    found = next(((thr, first) for thr in thresholds
                  for first in range(0, len(ds) - n_sl + 1, n_sl)
                  if qualifies(first, thr)), None)
    if found is None:
        _fatal("scan card vs CPU, selflabel: no candidate batch has its "
               f"confidences 1e-4 or more from a threshold of {thresholds} "
               "with a row over it")
    thr, first = found
    weak = confs[first][0]
    strong = views(StrongAugmentation(32, seed=0), n_sl, "s", first)
    lr_scan = cfg.scan_lr

    def sim_opt():
        return optim.chain(optim.add_decayed_weights(cfg.weight_decay),
                           optim.sgd(cfg.lr, momentum=0.9))

    anchors = views(sim, bsz["scan"], "a")
    neighbours = views(sim, bsz["scan"], "n")
    # name: (optimizer, lr, Adam?, loss_and_grads, batch, start params, bn)
    cases = {
        "simclr": (sim_opt(), cfg.lr, False,
                   lambda s, a, b: ts.simclr_loss_and_grads(
                       s, a, b, mcfg, cfg.temperature),
                   (views(sim, bsz["simclr"], "i"),
                    views(sim, bsz["simclr"], "j")), p, bn),
        "scan": (optim.adam(lr_scan), lr_scan, True,
                 lambda s, a, b: ts.scan_loss_and_grads(
                     s, a, b, mcfg, cfg.entropy_weight),
                 (anchors, neighbours), scan_params, scan_bn),
        "scan_head_only": (optim.adam(lr_scan), lr_scan, True,
                           lambda s, a, b: ts.scan_loss_and_grads(
                               s, a, b, mcfg, cfg.entropy_weight, True),
                           (anchors, neighbours), scan_params, scan_bn),
        "selflabel": (optim.sgd(cfg.selflabel_lr, momentum=0.9),
                      cfg.selflabel_lr, False,
                      lambda s, a, b: ts.selflabel_loss_and_grads(
                          s, a, b, one, thr, cfg.apply_class_balancing),
                      (weak, strong), sl, sc["bn"]),
    }
    pool.close()
    out = {}
    def norm(x) -> float:
        return float(torch.linalg.vector_norm(x.detach().cpu().double()))

    def held(card, cpu, ref, floor, scale=None) -> float:
        """The card's gap to float64 over its bound (<= 1 passes): twice
        the CPU's gap, or ``floor`` of ``scale`` (|ref| if None)."""
        scale = norm(ref) if scale is None else scale
        bound = max(2 * norm(cpu - ref), floor * scale, 1e-30)
        return norm(card.cpu().double() - ref) / bound

    def scan_terms(state, anchors, neighbours, head_only) -> float:
        """The magnitude of what SCAN's loss sums: over the heads,
        |consistency| + w |entropy|, as scan_loss_and_grads computes them
        (two forwards, the second from the first's BN statistics)."""
        with torch.no_grad():
            a, _, bn1 = ts.clustering_forward(
                state.params, state.bn_state, anchors, mcfg,
                train=not head_only)
            n, _, _ = ts.clustering_forward(state.params, bn1, neighbours,
                                            mcfg, train=not head_only)
            _, cons, ent = ts.scan_loss(a, n, cfg.entropy_weight)
        return float((cons.abs() + cfg.entropy_weight * ent.abs()).sum())

    with precision_scope("highest"):
        for name, (opt, lr, is_adam, lg, batch, params, bns) in \
                cases.items():
            state = ts.init_train_state(params, bns, opt)
            frozen = ((lambda k: not k.startswith("cluster_head"))
                      if name == "scan_head_only" else None)
            card = ts.scan_state_from_numpy(ts.scan_state_to_numpy(state),
                                            opt, SCAN_DEVICE)
            ref = ts.init_train_state(
                {k: v.double() for k, v in params.items()},
                {k: v.double() for k, v in bns.items()}, opt)
            t0 = time.perf_counter()
            loss_c, aux_c, g_c = lg(state, *batch)
            cpu_s = time.perf_counter() - t0
            loss_r, aux_r, g_r = lg(ref, *(x.double() for x in batch))
            loss_g, aux_g, g_g = lg(card, *(x.to(SCAN_DEVICE) for x in batch))
            bn_c, bn_r, bn_g = (a[0] if isinstance(a, tuple) else a
                                for a in (aux_c, aux_r, aux_g))
            loss_gap = abs(float(loss_g) - float(loss_r)) / abs(float(loss_r))
            scale = (scan_terms(ref, *(x.double() for x in batch),
                                name == "scan_head_only")
                     if name.startswith("scan") else None)
            loss_over = held(loss_g.double(), loss_c.double(), loss_r,
                             SCAN_LOSS_GAP_BOUND, scale)
            gaps = {k: held(g_g[k], g_c[k], v, SCAN_GRAD_GAP_BOUND)
                    for k, v in g_r.items() if norm(v) > 0}
            worst = max(gaps, key=gaps.get)
            card_rel = norm(g_g[worst].cpu().double() - g_r[worst]) / norm(
                g_r[worst])
            cpu_rel = norm(g_c[worst].double() - g_r[worst]) / norm(
                g_r[worst])
            bn_over = max(held(bn_g[k], bn_c[k], v, SCAN_BN_GAP_BOUND)
                          for k, v in bn_r.items())
            ref_sq = sum(norm(v) ** 2 for v in g_r.values())
            whole, whole_cpu = (math.sqrt(sum(
                norm(g[k].cpu().double() - v) ** 2
                for k, v in g_r.items()) / ref_sq) for g in (g_g, g_c))
            if whole > max(2 * whole_cpu, SCAN_GLOBAL_GRAD_BOUND):
                _fatal(f"scan card vs CPU, {name}: the whole gradient "
                       f"{whole:.3e} from float64, the CPU's {whole_cpu:.3e} "
                       f"(bound: twice that or {SCAN_GLOBAL_GRAD_BOUND})")
            if max(loss_over, gaps[worst], bn_over) > 1:
                _fatal(f"scan card vs CPU, {name}: loss {float(loss_g)}, "
                       f"CPU {float(loss_c)}, float64 {float(loss_r)} "
                       f"({loss_over:.3f} of its bound); gradient of "
                       f"{worst} at {gaps[worst]:.3f} of its bound (card "
                       f"{card_rel:.3e} from float64, CPU {cpu_rel:.3e}); "
                       f"BN statistics at {bn_over:.3f} of their bound")
            new_c = ts.apply_gradients(state, g_c, bn_c, opt, frozen)
            new_g = ts.apply_gradients(card, g_g, bn_g, opt, frozen)
            # the CPU's update of the card's gradients: the card's update
            new_x = ts.apply_gradients(
                state, {k: v.cpu() for k, v in g_g.items()},
                {k: v.cpu() for k, v in bn_g.items()}, opt, frozen)
            upd_gap = state_gap = 0.0
            for k in new_c.params:
                a = new_g.params[k].cpu().double()
                x = new_x.params[k].double()
                c = new_c.params[k].double()
                upd_gap = max(upd_gap, float(((a - x).abs()
                                              / (x.abs() + lr)).max()))
                if is_adam:
                    # Adam's first step, about lr sign(g): 2 lr apart
                    gap, bound = float((a - c).abs().max()), 2 * lr
                else:
                    gap = norm(a - c)
                    bound = (lr * (1 + 1e-3) * norm(g_g[k].cpu() - g_c[k])
                             + 1e-6 * norm(c))
                if gap > bound + 1e-12:
                    _fatal(f"scan card vs CPU, {name}: after the step {k} "
                           f"is {gap:.3e} apart (bound {bound:.3e})")
                state_gap = max(state_gap, gap / max(bound, 1e-30))
            if upd_gap > 1e-5:
                _fatal(f"scan card vs CPU, {name}: the card's update "
                       f"{upd_gap:.3e} from the CPU's update of the same "
                       f"gradients (bound 1e-5 of |value| + lr)")
            row = dict(loss_gap=loss_gap, loss_terms=scale,
                       grad_over_bound=gaps[worst],
                       grad_gap=card_rel, cpu_grad_gap=cpu_rel,
                       whole_grad_gap=whole,
                       bn_over_bound=bn_over, upd_gap=upd_gap,
                       state_gap_over_bound=state_gap, cpu_s=cpu_s)
            extra = ""
            if name == "selflabel":
                with torch.no_grad():
                    probs = [torch.softmax(ts.clustering_forward(
                        s.params, s.bn_state, weak.to(d), one,
                        train=True)[0][0], 1).amax(1).cpu()
                        for s, d in ((state, "cpu"), (card, SCAN_DEVICE))]
                masks = [p > thr for p in probs]
                if not torch.equal(masks[0], masks[1]) or not masks[0].any():
                    _fatal(f"scan card vs CPU, selflabel: confident rows "
                           f"{int(masks[0].sum())} on the CPU, "
                           f"{int(masks[1].sum())} on the card (the masks "
                           "must be equal and not empty)")
                row["confident"] = int(masks[0].sum())
                row["threshold_margin"] = float((probs[0] - thr).abs().min())
                row["threshold"] = thr
                extra = (f"; images {first}-{first + n_sl - 1}: "
                         f"{row['confident']} of {n_sl} rows over {thr} on "
                         f"both, the nearest {row['threshold_margin']:.3e} "
                         "from it")
            print(f"scan card vs CPU ({name}, f32, TF32 off, full width; "
                  f"float64 on the CPU the reference): loss "
                  f"{float(loss_g):.6f}, CPU {float(loss_c):.6f}, float64 "
                  f"{float(loss_r):.6f} (card gap {loss_gap:.3e}, "
                  f"{loss_over:.3f} of its bound"
                  + ("" if scale is None else
                     f", its floor {SCAN_LOSS_GAP_BOUND} of the terms' "
                     f"magnitude {scale:.4f}")
                  + f"); the worst gradient "
                  f"{worst} at {gaps[worst]:.3f} of its bound (card "
                  f"{card_rel:.3e} from float64, CPU {cpu_rel:.3e}; "
                  f"bound: twice the CPU's gap or {SCAN_GRAD_GAP_BOUND}); "
                  f"the whole gradient {whole:.3e} from float64 (CPU "
                  f"{whole_cpu:.3e}); BN statistics at "
                  f"{bn_over:.3f} of their bound; update "
                  f"vs the CPU's update of the card's gradients "
                  f"{upd_gap:.3e}; states after the step at "
                  f"{state_gap:.3f} of their bound; CPU {cpu_s:.1f} s"
                  f"{extra}", flush=True)
            out[name] = row
    return out


def _scan_aug_rates(ds) -> dict:
    """The SimCLR transform's host rate on SCAN_AUG_IMAGES images, us an
    image: one thread, 8 threads (tpu_ac's pool), and the port's pool of
    8 worker processes (warm); the three must give the same arrays."""
    import random
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from tpu_ac_torch.data.augment import SimCLRAugmentation

    aug, n = SimCLRAugmentation(32, seed=0), SCAN_AUG_IMAGES

    def one(i):
        return aug(ds.get_pil(i), rng=random.Random(f"0/r/0/{i}"))

    out, arrays = {}, []
    t0 = time.perf_counter()
    arrays.append(np.stack([one(i) for i in range(n)]))
    out["serial"] = time.perf_counter() - t0
    with ThreadPoolExecutor(8) as threads:
        list(threads.map(one, range(64)))
        t0 = time.perf_counter()
        arrays.append(np.stack(list(threads.map(one, range(n)))))
        out["8 threads"] = time.perf_counter() - t0
    pool = _aug_pool(8, seed=0)
    try:
        pool.stack(aug, ds.get_pil, range(64), stream="r")
        t0 = time.perf_counter()
        arrays.append(pool.stack(aug, ds.get_pil, range(n), stream="r"))
        out["8 processes"] = time.perf_counter() - t0
    finally:
        pool.close()
    if not all(np.array_equal(a, arrays[0]) for a in arrays[1:]):
        _fatal("scan aug: the thread and process pools' arrays differ from "
               "the serial loop's")
    us = {k: 1e6 * v / n for k, v in out.items()}
    print(f"scan aug (SimCLR transform, {n} images at 32 px, "
          f"{os.cpu_count()} CPUs), us an image: " + ", ".join(
              f"{k} {v:.1f}" for k, v in us.items())
          + "; the same arrays", flush=True)
    return us


def _scan_mining(torch, k: int) -> dict:
    """Neighbour mining at the recipe's bank, SCAN_BANK_ROWS x 128 unit
    rows (seeded on the card), top-k: ``knn_ip`` timed by CUDA events, and
    ``MemoryBank.mine_nearest_neighbors``'s lists for 1,000 sampled rows
    held to a float64 host search: every pick within 1e-5 of the k-th best
    score (ties), in descending order within 1e-5, each row itself
    first."""
    import numpy as np

    from tpu_ac_torch.ops.distances import knn_ip
    from tpu_ac_torch.train import scan as ts

    gen = torch.Generator(device=SCAN_DEVICE).manual_seed(0)
    feats = torch.randn(SCAN_BANK_ROWS, 128, device=SCAN_DEVICE,
                        generator=gen)
    feats /= torch.linalg.vector_norm(feats, dim=1, keepdim=True)
    bank = ts.MemoryBank(SCAN_BANK_ROWS, 128, SCAN_CLASSES,
                         device=SCAN_DEVICE)
    bank.update(feats, np.arange(SCAN_BANK_ROWS) % SCAN_CLASSES)
    ms, _host = _time_ms(lambda: knn_ip(bank.features, bank.features, k), 3)
    idx = bank.mine_nearest_neighbors(k - 1, calculate_accuracy=False)
    host = feats.cpu().double()
    rows = np.random.default_rng(0).choice(SCAN_BANK_ROWS, 1000,
                                           replace=False)
    sims = (host[rows] @ host.T).numpy()
    kth = -np.sort(-sims, axis=1)[:, k - 1]
    picked = np.take_along_axis(sims, idx[rows].astype(np.int64), axis=1)
    if not (np.all(picked >= kth[:, None] - 1e-5)
            and np.all(np.diff(picked, axis=1) <= 1e-5)
            and np.array_equal(idx[rows, 0], rows)):
        _fatal("scan mining: a mined list holds a row outside the float64 "
               f"top-{k} (worst {float((kth[:, None] - picked).max()):.3e} "
               "below the k-th score), out of order, or not led by itself")
    n, d = SCAN_BANK_ROWS, 128
    bound_ms = 1e3 * max(2.0 * n * n * d / PEAK_F32_FLOPS,
                         (n * d * 4 + n * k * 8) / PEAK_HBM_BYTES)
    print(f"scan mining: {n} x {d}, top-{k}: {ms:.2f} ms (CUDA events) "
          f"against a {bound_ms:.2f} ms bound (operations: the f32 product "
          "at the f32 peak); 1,000 sampled rows match a float64 host search",
          flush=True)
    return dict(ms=ms, bound_ms=bound_ms)


def _scan_profile(torch, ds, cfg) -> dict:
    """SimCLR, SCAN and self-label steps in this process, fed as cli.scan
    feeds them (augmentation pool, one batch ahead, pinned uploads): 2
    warm-up steps, 4 timed, 4 under torch.profiler, each stage's busy
    share."""
    import numpy as np

    from tpu_ac_torch.cli import scan as cli
    from tpu_ac_torch.data.augment import (
        SimCLRAugmentation,
        StrongAugmentation,
        WeakAugmentation,
    )
    from tpu_ac_torch.data.prefetch import to_device
    from tpu_ac_torch.device import precision_scope
    from tpu_ac_torch.train import optim
    from tpu_ac_torch.train import scan as ts

    mcfg, one = cli._model_config(cfg), cli._single_head(cfg)
    put = to_device(SCAN_DEVICE)
    pool = _aug_pool(8)
    p, bn = ts.init_contrastive_model(0, mcfg, SCAN_DEVICE)
    sim_opt = optim.chain(optim.add_decayed_weights(cfg.weight_decay),
                          optim.sgd(cfg.lr, momentum=0.9))
    cp, cbn = ts.init_clustering_model(0, one, SCAN_DEVICE)
    sl_opt = optim.sgd(cfg.selflabel_lr, momentum=0.9)
    hp, hbn = ts.init_clustering_model(0, mcfg, SCAN_DEVICE)
    scan_opt = optim.adam(cfg.scan_lr)
    stages = {
        "simclr": (ts.init_train_state(p, bn, sim_opt),
                   ts.make_simclr_step(mcfg, sim_opt, cfg.temperature),
                   SimCLRAugmentation(32, seed=0),
                   SimCLRAugmentation(32, seed=0), cfg.simclr_batch),
        "scan": (ts.init_train_state(hp, hbn, scan_opt),
                 ts.make_scan_step(mcfg, scan_opt, cfg.entropy_weight),
                 SimCLRAugmentation(32, seed=0),
                 SimCLRAugmentation(32, seed=0), cfg.scan_batch),
        "selflabel": (ts.init_train_state(cp, cbn, sl_opt),
                      ts.make_selflabel_step(
                          one, sl_opt, cfg.confidence_threshold,
                          cfg.apply_class_balancing),
                      WeakAugmentation(32, seed=0),
                      StrongAugmentation(32, seed=0), cfg.selflabel_batch),
    }
    out = {}
    with precision_scope("default"):
        for name, (state, step, aug_a, aug_b, bs) in stages.items():
            order = np.random.default_rng(0).permutation(len(ds))

            def run(n, first=0):
                nonlocal state

                def thunks():
                    for i in range(first, first + n):
                        # the indices wrap: 10 self-label batches of 1,000
                        # outnumber SCAN_TRAIN's images
                        idxs = order[np.arange(i * bs, (i + 1) * bs)
                                     % len(order)]
                        yield (lambda idxs=idxs, i=i: (
                            put(pool.stack(aug_a, ds.get_pil, idxs, epoch=i,
                                           stream="a")),
                            put(pool.stack(aug_b, ds.get_pil, idxs, epoch=i,
                                           stream="b"))))
                for a, b in pool.lookahead(thunks()):
                    state, out = step(state, a, b)
                torch.cuda.synchronize()
                loss = float(out["total"] if isinstance(out, dict) else out)
                if not math.isfinite(loss):
                    _fatal(f"scan profile {name}: loss {loss}")

            run(2)
            t0 = time.perf_counter()
            run(4, 2)
            wall_s = time.perf_counter() - t0
            busy = _profile_busy(torch, lambda: run(4, 6), wall_s,
                                 f"4 {name} steps (batch {bs}, fed by the "
                                 "augmentation pool)")
            out[name] = dict(step_ms=wall_s * 1e3 / 4, busy_pct=busy)
    pool.close()
    return out


def phase_scan(torch, work: str) -> dict:
    """SCAN at the CIFAR-10 recipe through cli.scan (see the module
    docstring, phase 11)."""
    import numpy as np

    from tpu_ac_torch.config import CONFIG_DIR, Config, load_yaml, merge
    from tpu_ac_torch.data.classification import load_cifar10
    from tpu_ac_torch.models.resnet_cifar import RESNET18_CIFAR
    from tpu_ac_torch.utils import latest_checkpoint

    t_start = time.perf_counter()
    data = _make_cifar10(work)
    out_root = os.path.join(work, "scan_out")
    env = os.path.join(work, "scan_env.yml")
    with open(env, "w") as f:
        f.write(f"root_dir: {out_root}\ndata_root: {data}\n")
    exps, merged = {}, Config()
    for rel in SCAN_EXPS:
        with open(os.path.join(CONFIG_DIR, rel)) as f:
            text = f.read()
        exp = os.path.join(work, "scan_" + os.path.basename(rel))
        with open(exp, "w") as f:
            f.write(text.replace("\nepochs:", "\n# recipe epochs:")
                    + "epochs: 1\n")
        exps[rel.split("/")[0]] = exp
        merged = merge(merged, load_yaml(exp))
    print(f"scan: synthetic CIFAR-10 ({SCAN_TRAIN} train, {SCAN_TEST} test, "
          f"{SCAN_CLASSES} classes, 32 px) in {time.perf_counter() - t_start:.1f}"
          f" s; the recipe {json.dumps(merged)}", flush=True)
    runs = {"simclr": _scan_cli("simclr", env, exps["pretext"])}
    base = os.path.join(out_root, "cifar-10")
    nbrs = np.load(os.path.join(base, "top20-train-neighbors.npy"))
    if not (nbrs.shape == (SCAN_TRAIN, 21) and nbrs.dtype == np.int32
            and nbrs.min() >= 0 and nbrs.max() < SCAN_TRAIN):
        _fatal(f"cli.scan simclr: neighbours {nbrs.shape} {nbrs.dtype}, "
               f"range [{nbrs.min()}, {nbrs.max()}]")
    runs["scan"] = _scan_cli("scan", env, exps["scan"])
    runs["selflabel"] = _scan_cli("selflabel", env, exps["selflabel"])
    runs["eval"] = _scan_cli("eval", env, exps["selflabel"])
    for stage in ("pretext", "scan", "selflabel"):
        if latest_checkpoint(os.path.join(base, stage), "model") is None:
            _fatal(f"cli.scan: no {stage} model checkpoint")
    ev = runs["eval"]["stage"]
    if not all(0.0 <= ev[k] <= 1.0 for k in ("ACC", "NMI", "ARI",
                                              "ACC Top-5")):
        _fatal(f"cli.scan eval: scores {ev}")
    moco = _scan_moco(torch, work)

    ds = load_cifar10(data, "train")
    cfg = Config(merged, root_dir=out_root, db="cifar-10",
                 simclr_batch=load_yaml(exps["pretext"]).batch_size,
                 scan_batch=load_yaml(exps["scan"]).batch_size,
                 selflabel_batch=load_yaml(exps["selflabel"]).batch_size)
    cfg["lr"] = load_yaml(exps["pretext"]).lr
    aug_us = _scan_aug_rates(ds)
    mined = _scan_mining(torch, merged.num_neighbors + 1)
    prof = _scan_profile(torch, ds, cfg)
    gaps = _scan_card_vs_cpu(torch, ds, cfg)

    e = runs["simclr"]["epochs"][0]
    flops = 3 * _cifar_resnet_flops(RESNET18_CIFAR, 32) * 2 * cfg.simclr_batch
    step_s = e["step_ms"] / 1e3
    print(f"scan simclr step: {flops / 1e12:.3f} TFLOP of convs a step "
          f"(forward + 2x backward, {2 * cfg.simclr_batch} images) = "
          f"{100 * flops / step_s / PEAK_TF32_FLOPS:.2f}% of the dense TF32 "
          f"peak, {100 * flops / step_s / PEAK_F32_FLOPS:.2f}% of the f32 "
          "peak", flush=True)
    mining = runs["simclr"]["mining"][0]
    phase_s = time.perf_counter() - t_start
    print(f"scan phase: {phase_s:.1f} s", flush=True)
    return dict(
        stage_s={s: r["stage"]["seconds"] for s, r in runs.items()},
        cli_s={s: r["wall_s"] for s, r in runs.items()},
        step_ms={s: r["epochs"][0]["step_ms"] for s, r in runs.items()
                 if r["epochs"]},
        images_s={s: r["epochs"][0]["images_s"] for s, r in runs.items()
                  if r["epochs"]},
        loader_wait_ms={s: r["epochs"][0]["data_wait_ms"]
                        for s, r in runs.items() if r["epochs"]},
        peak_gib={s: r["epochs"][0]["peak_gib"] for s, r in runs.items()
                  if r["epochs"]},
        simclr_tflop=flops / 1e12,
        simclr_tf32_peak_pct=100 * flops / step_s / PEAK_TF32_FLOPS,
        mining_ms=mined["ms"], mining_bound_ms=mined["bound_ms"],
        mining_cli_ms=mining["ms"], neighbor_accuracy=mining["accuracy"],
        eval={k: ev[k] for k in ("ACC", "NMI", "ARI", "ACC Top-5")},
        aug_us=aug_us, moco=moco, profile=prof, card_vs_cpu=gaps,
        phase_s=phase_s)


EVAL_CLASSES = 4
EVAL_TRAIN = 64  # images a class: 256 train images, 2 probe steps of 128
EVAL_VAL = 32  # images a class: 128 val images
# ImageNet-1k at the k-NN recipe: ViT-S/16 CLS features of the train and
# val sets
KNN_BANK, KNN_QUERIES, KNN_DIM, KNN_CLASSES, KNN_K = (1_281_167, 50_000,
                                                      384, 1000, 20)
KNN_CHECK = (20_000, 1_000)  # bank rows, queries held to float64
PROBE_STEPS, PROBE_DIM, PROBE_BATCH = 500, 1536, 256
IMAGENET_PROBE_STEPS = 5005  # 1,281,167 / 256, drop-last
COPYDAYS_ORIGINALS = 8
COPYDAYS_EXTRA = (("distractors", 16), ("whitening", 32))
ROXFORD = dict(n_db=40, n_q=8, image_size=300)
DAVIS_FRAMES, DAVIS_HW = 10, (480, 854)
# every run of the phase goes here (the CLIs' --device)
EVAL_DEVICE = "cuda"


def _vit_flops(cfg, h: int, w: int) -> float:
    """FLOPs of one image's forward through every block (2 a multiply-add,
    as _dino_step_flops reckons them)."""
    d, ps = cfg.embed_dim, cfg.patch_size
    n_p = (h // ps) * (w // ps)
    n = n_p + cfg.num_prefix_tokens
    return (cfg.depth * (24 * n * d * d + 4 * n * n * d)
            + 2 * n_p * 3 * ps * ps * d)


def _smooth_images(rng, n: int, hw: tuple[int, int], tint=None):
    """n seeded uint8 HWC images: 16 x 16 noise bicubic-upsampled to hw
    plus fine noise, optionally tinted (a class's colour)."""
    import numpy as np
    from PIL import Image

    out = []
    for _ in range(n):
        low = Image.fromarray(rng.integers(0, 256, (16, 16, 3),
                                           dtype=np.uint8))
        a = np.asarray(low.resize(hw[::-1], Image.BICUBIC), np.int16)
        a = a + rng.integers(-12, 13, a.shape, dtype=np.int16)
        if tint is not None:
            a = (a + np.asarray(tint, np.int16)) // 2
        out.append(np.clip(a, 0, 255).astype(np.uint8))
    return out


def _make_eval_trees(work: str) -> dict:
    """The synthetic trees of the eval phase, from numpy seeds: an
    ImageFolder with train/ and val/ (EVAL_CLASSES tinted classes at 256
    px), a Copydays tree with distractor and whitening dirs (400 x 300),
    make_synthetic_roxford's revisited Oxford (300 px), one DAVIS video
    of DAVIS_FRAMES frames at 854 x 480 with a 2-object first mask."""
    import numpy as np
    from PIL import Image

    from tpu_ac_torch.cli.eval_video_segmentation import davis_palette
    from tpu_ac_torch.data.oxford_paris import make_synthetic_roxford
    from tpu_ac_torch.train.copy_detection import CROP_LEVELS, JPEG_LEVELS

    rng = np.random.default_rng(0)
    root = os.path.join(work, "evals")
    folder = os.path.join(root, "imagefolder")
    for split, n in (("train", EVAL_TRAIN), ("val", EVAL_VAL)):
        for c in range(EVAL_CLASSES):
            d = os.path.join(folder, split, f"class_{c}")
            os.makedirs(d)
            tint = [255 * ((c >> b) & 1) for b in range(3)]
            for i, a in enumerate(_smooth_images(rng, n, (256, 256), tint)):
                Image.fromarray(a).save(os.path.join(d, f"{i:03d}.png"))

    copydays = os.path.join(root, "copydays")
    bases = _smooth_images(rng, COPYDAYS_ORIGINALS, (300, 400))
    names = [f"{2000 + i}.jpg" for i in range(COPYDAYS_ORIGINALS)]

    def save(block, fnames, arrays):
        d = os.path.join(copydays, block)
        os.makedirs(d, exist_ok=True)
        for f, a in zip(fnames, arrays):
            Image.fromarray(a).save(os.path.join(d, f), quality=90)

    def noised(scale):
        return [np.clip(b.astype(np.int16) + rng.integers(
            -scale, scale + 1, b.shape, dtype=np.int16), 0, 255).astype(
                np.uint8) for b in bases]

    save("original", names, bases)
    save("strong", [f"{n[:4]}_strong.jpg" for n in names[::2]],
         noised(40)[::2])
    for lvl in JPEG_LEVELS:
        save(f"jpegqual/{lvl}", names, noised(8))
    for lvl in CROP_LEVELS:
        save(f"crops/{lvl}", names, noised(8))
    extra = {}
    for d, n in COPYDAYS_EXTRA:
        save(d, [f"{i:03d}.jpg" for i in range(n)],
             _smooth_images(rng, n, (300, 400)))
        extra[d] = os.path.join(copydays, d)

    revisited = make_synthetic_roxford(os.path.join(root, "revisited"),
                                       **ROXFORD)

    davis = os.path.join(root, "davis")
    vid = os.path.join(davis, "JPEGImages", "480p", "synthetic")
    ann = os.path.join(davis, "Annotations", "480p", "synthetic")
    for d in (vid, ann, os.path.join(davis, "ImageSets", "2017")):
        os.makedirs(d)
    h, w = DAVIS_HW
    backgrounds = _smooth_images(rng, DAVIS_FRAMES, DAVIS_HW)
    labels = np.zeros(DAVIS_HW, np.uint8)
    for t, a in enumerate(backgrounds):
        for obj, (y, x, dy, dx, colour) in enumerate(
                ((80, 100, 6, 10, (230, 40, 40)),
                 (260, 560, -8, -12, (40, 220, 230))), 1):
            sl = np.s_[y + dy * t:y + dy * t + 120, x + dx * t:x + dx * t
                       + 160]
            a[sl] = colour
            if t == 0:
                labels[sl] = obj
        Image.fromarray(a).save(os.path.join(vid, f"{t:05d}.jpg"),
                                quality=90)
    seg = Image.fromarray(labels)
    seg.putpalette(davis_palette().ravel().tolist())
    seg.save(os.path.join(ann, "00000.png"))
    with open(os.path.join(davis, "ImageSets", "2017", "val.txt"), "w") as f:
        f.write("synthetic\n")
    return dict(folder=folder, copydays=copydays, revisited=revisited,
                davis=davis, **extra)


def _run_cli(main, argv: list[str], label: str):
    """``main(argv)`` in this process, its standard output printed as it
    is and returned beside the result and the wall seconds."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = main(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"  {label}: {line}", flush=True)
    print(f"{label}: {wall:.1f} s in this process", flush=True)
    return res, out, wall


def _knn_vote_f64(np, bank, labels, q, k: int, T: float, n_cls: int):
    """(classes best first [n, 5], kept): the float64 host vote, and the
    queries away from ties: the k-th and (k+1)-th similarities more than
    1e-5 apart and the six best class weights more than 1e-5 (relative)
    apart, where f32 and float64 may order them differently."""
    sims = q @ bank.T
    idx = np.argpartition(-sims, k, axis=1)[:, :k + 1]
    top = np.take_along_axis(sims, idx, 1)
    order = np.argsort(-top, axis=1)
    idx, top = (np.take_along_axis(a, order, 1) for a in (idx, top))
    probs = np.zeros((len(q), n_cls))
    np.add.at(probs, (np.arange(len(q))[:, None], labels[idx[:, :k]]),
              np.exp(top[:, :k] / T))
    cls = np.argsort(-probs, axis=1)
    best = np.take_along_axis(probs, cls[:, :6], 1)
    kept = ((top[:, k - 1] - top[:, k] > 1e-5)
            & np.all(-np.diff(best, axis=1) > 1e-5 * best[:, :1], axis=1))
    return cls[:, :5], kept


def _evals_knn_imagenet(torch) -> dict:
    """knn_classifier at ImageNet's size on seeded unit features that live
    on the card (host wall time, and the device time of its 100 chunks'
    votes by CUDA events), beside the f32 product's bound; then on a
    KNN_CHECK subset, the card's top-5 classes against a float64 host
    vote away from ties."""
    import numpy as np

    from tpu_ac_torch.device import precision_scope
    from tpu_ac_torch.train import evals

    gen = torch.Generator(device=EVAL_DEVICE).manual_seed(0)

    def unit(n):
        x = torch.randn(n, KNN_DIM, device=EVAL_DEVICE, generator=gen)
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    bank, queries = unit(KNN_BANK), unit(KNN_QUERIES)
    labels = torch.randint(0, KNN_CLASSES, (KNN_BANK,), device=EVAL_DEVICE,
                           generator=gen)
    q_labels = torch.randint(0, KNN_CLASSES, (KNN_QUERIES,),
                             device=EVAL_DEVICE,
                             generator=gen).cpu().numpy()
    evals.knn_classifier(bank, labels, queries[:1000], q_labels[:1000],
                         KNN_K, 0.07, KNN_CLASSES)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    top1, top5 = evals.knn_classifier(bank, labels, queries, q_labels,
                                      KNN_K, 0.07, KNN_CLASSES)
    wall_ms = (time.perf_counter() - t0) * 1e3
    chunk = KNN_QUERIES // 100
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with precision_scope("highest"):
        start.record()
        for i in range(0, KNN_QUERIES, chunk):
            evals._vote(queries[i:i + chunk], bank, labels, KNN_K, 0.07,
                        KNN_CLASSES)
        stop.record()
    stop.synchronize()
    device_ms = start.elapsed_time(stop)
    flops = 2.0 * KNN_QUERIES * KNN_BANK * KNN_DIM
    bytes_ = 4 * (KNN_BANK + KNN_QUERIES) * KNN_DIM + 8 * KNN_BANK
    bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, bytes_ / PEAK_HBM_BYTES)
    part = KNN_QUERIES // 5

    def vote_part():
        evals.knn_classifier(bank, labels, queries[:part], q_labels[:part],
                             KNN_K, 0.07, KNN_CLASSES)

    t0 = time.perf_counter()
    vote_part()
    busy = _profile_busy(torch, vote_part, time.perf_counter() - t0,
                         f"knn_classifier on {part} queries")
    print(f"evals k-NN at ImageNet's size ({KNN_BANK} x {KNN_DIM} f32 bank, "
          f"{KNN_CLASSES} classes, {KNN_QUERIES} queries, k = {KNN_K}, TF32 "
          f"off): knn_classifier {wall_ms:.1f} ms on the host clock, its "
          f"votes {device_ms:.1f} ms on the card (CUDA events), bound "
          f"{bound_ms:.1f} ms (operations: {flops / 1e12:.1f} TFLOP at the "
          f"f32 peak); top-1 {top1:.3f}, top-5 {top5:.3f} (random labels)",
          flush=True)

    n_bank, n_q = KNN_CHECK
    got = evals.knn_predictions(bank[:n_bank], labels[:n_bank],
                                queries[:n_q], KNN_K, 0.07, KNN_CLASSES)
    want, kept = _knn_vote_f64(np, bank[:n_bank].cpu().double().numpy(),
                               labels[:n_bank].cpu().numpy(),
                               queries[:n_q].cpu().double().numpy(), KNN_K,
                               0.07, KNN_CLASSES)
    bad = int(np.sum(np.any(got != want, axis=1) & kept))
    if bad or kept.sum() < 0.9 * n_q:
        _fatal(f"evals k-NN: {bad} of {int(kept.sum())} queries away from "
               f"ties disagree with the float64 vote (of {n_q})")
    print(f"evals k-NN check: {n_bank} x {n_q}, the top-5 classes of "
          f"{int(kept.sum())} queries away from ties equal a float64 host "
          f"vote ({n_q - int(kept.sum())} near ties left out)", flush=True)
    del bank, queries, labels
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, device_ms=device_ms, bound_ms=bound_ms,
                busy_pct=busy, checked=int(kept.sum()))


def _evals_probe_rate(torch) -> dict:
    """PROBE_STEPS probe steps at PROBE_DIM -> 1000, batch PROBE_BATCH, on
    seeded features on the card (the index rows uploaded once)."""
    from tpu_ac_torch.train import evals

    gen = torch.Generator(device=EVAL_DEVICE).manual_seed(1)
    n = 64 * PROBE_BATCH
    feats = torch.randn(n, PROBE_DIM, device=EVAL_DEVICE, generator=gen)
    labels = torch.randint(0, 1000, (n,), device=EVAL_DEVICE, generator=gen)
    rows = torch.randint(0, n, (PROBE_STEPS, PROBE_BATCH), device=EVAL_DEVICE,
                         generator=gen)
    state, step, _ = evals.make_linear_probe(PROBE_DIM, 1000,
                                             device=EVAL_DEVICE)
    for r in rows[:5]:  # warm-up
        state, loss = step(state, feats.index_select(0, r),
                           labels.index_select(0, r), 0.001)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in rows:
        state, loss = step(state, feats.index_select(0, r),
                           labels.index_select(0, r), 0.001)
    loss = float(loss)
    steps_s = PROBE_STEPS / (time.perf_counter() - t0)
    if not math.isfinite(loss):
        _fatal(f"evals probe: loss {loss}")
    epoch_s = IMAGENET_PROBE_STEPS / steps_s
    print(f"evals probe: {PROBE_STEPS} steps at {PROBE_DIM} -> 1000, batch "
          f"{PROBE_BATCH}: {steps_s:.1f} steps/s; an ImageNet epoch "
          f"({IMAGENET_PROBE_STEPS} steps) {epoch_s:.1f} s; loss {loss:.4f}",
          flush=True)
    return dict(steps_s=steps_s, imagenet_epoch_s=epoch_s)


def _evals_rates(torch) -> dict:
    """images/s of the two full-width extracts (TF32, seeded uint8 images
    on the card): ViT-S/16 CLS at 224, batch 128; ViT-B/8 last-block
    tokens + GeM at 320, batch 16; each beside its share of the dense TF32
    peak."""
    from tpu_ac_torch.models.registry import load_backbone
    from tpu_ac_torch.train.copy_detection import gem_cls_features
    from tpu_ac_torch.train.evals import make_embedder

    out = {}
    for name, size, batch, fwd in (
            ("dino_deitsmall16", 224, 128, lambda m, x: m.forward_cls(x)),
            ("dino_vitbase8", 320, 16, lambda m, x: gem_cls_features(
                m.intermediate_layers(x, 1)[0]))):
        model, cfg, _ = load_backbone(name)
        embed = make_embedder(model.to(EVAL_DEVICE), fwd)
        x = torch.randint(0, 256, (batch, 3, size, size), dtype=torch.uint8,
                          device=EVAL_DEVICE)
        # 2 calls: more would fill the card's launch queue while it sleeps
        with torch.inference_mode():
            ms, _host = _time_ms(lambda: embed(x), reps=2, warmup=2)
        img_s = batch * 1e3 / ms
        share = 100 * _vit_flops(cfg, size, size) * img_s / PEAK_TF32_FLOPS
        print(f"evals rate {name} at {size} px, batch {batch} (TF32): "
              f"{ms:.2f} ms a batch, {img_s:.1f} images/s, "
              f"{share:.1f}% of the dense TF32 peak "
              f"({_vit_flops(cfg, size, size) / 1e9:.2f} GFLOP an image)",
              flush=True)
        out[name] = dict(batch_ms=ms, images_s=img_s, tf32_peak_pct=share)
        del model, embed
        torch.cuda.empty_cache()
    return out


def _evals_davis_times(torch, davis: str) -> dict:
    """ms a frame of the DAVIS embed and of the propagation at the CLI's
    defaults, on the synthetic video (CUDA-synchronized host clock)."""
    import glob

    from tpu_ac_torch.cli import eval_video_segmentation as vs
    from tpu_ac_torch.models.registry import load_backbone
    from tpu_ac_torch.train.video_seg import propagate_video

    model, cfg, _ = load_backbone("dino_deitsmall16")
    model = model.to(EVAL_DEVICE)
    paths = sorted(glob.glob(os.path.join(davis, "JPEGImages", "480p",
                                          "synthetic", "*.jpg")))
    frames = [vs.read_frame(p, [480])[0] for p in paths]
    first, _ = vs.read_seg(paths[0].replace("JPEGImages", "Annotations")
                           .replace("jpg", "png"), cfg.patch_size, [480])
    grid = tuple(s // cfg.patch_size for s in frames[0].shape[1:])
    with torch.inference_mode():
        dev = torch.device(EVAL_DEVICE)
        vs.extract_frame_features(model, frames[:6], 6, dev)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = vs.extract_frame_features(model, frames, 6, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        propagate_video(feats, first, grid, normalize=False)
        t2 = time.perf_counter()
        busy = _profile_busy(
            torch, lambda: propagate_video(feats, first, grid,
                                           normalize=False), t2 - t1,
            f"the propagation of {len(frames) - 1} frames")
    n = len(frames)
    embed_ms, prop_ms = 1e3 * (t1 - t0) / n, 1e3 * (t2 - t1) / (n - 1)
    print(f"evals DAVIS at {frames[0].shape[1]} x {frames[0].shape[2]} "
          f"({grid[0]} x {grid[1]} patches, ViT-S/16, f32, batch 6): embed "
          f"{embed_ms:.2f} ms a frame, propagation {prop_ms:.2f} ms a frame "
          "(7 context frames, top-5, neighbourhood 12)", flush=True)
    return dict(embed_ms_per_frame=embed_ms, propagate_ms_per_frame=prop_ms,
                propagate_busy_pct=busy)


def phase_evals(torch, work: str) -> dict:
    """DINO's evaluation suite through its five CLIs in this process, at
    the recipes' full widths on their seeded inits (see the module
    docstring, phase 12)."""
    import numpy as np
    from PIL import Image

    from tpu_ac_torch.cli import (
        eval_copy_detection,
        eval_image_retrieval,
        eval_knn,
        eval_linear,
        eval_video_segmentation,
    )
    from tpu_ac_torch.models.registry import load_backbone
    from tpu_ac_torch.train.evals import make_embedder

    t_start = time.perf_counter()
    trees = _make_eval_trees(work)
    print(f"evals: synthetic trees in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    run: dict = {}

    dump = os.path.join(work, "evals", "knn_features.npz")
    dev = ["--device", EVAL_DEVICE]
    knn, _out, knn_s = _run_cli(eval_knn.main, [
        "--data_path", trees["folder"], "--dump_features", dump, *dev],
        "eval_knn")
    feats = np.load(dump)
    model, cfg, _ = load_backbone("dino_deitsmall16")
    n_train, n_val = EVAL_CLASSES * EVAL_TRAIN, EVAL_CLASSES * EVAL_VAL
    if not (feats["train"].shape == (n_train, cfg.embed_dim)
            and feats["val"].shape == (n_val, cfg.embed_dim)
            and np.isfinite(feats["train"]).all()
            and sorted(knn) == [10, 20, 100, 200]):
        _fatal(f"eval_knn: features {feats['train'].shape}, "
               f"{feats['val'].shape}, results {knn}")
    val_x, _, _ = eval_knn.load_split(os.path.join(trees["folder"], "val"),
                                      224)
    embed = make_embedder(model, lambda m, x: m.forward_cls(x))
    with torch.inference_mode():
        cpu = torch.nn.functional.normalize(
            embed(torch.from_numpy(val_x[:8])), dim=1)
    gap = _rel_gap(torch, torch.from_numpy(feats["val"][:8]), cpu)
    if not gap <= ZOO_GAP_BOUND:
        _fatal(f"eval_knn: the card's TF32 features of 8 images are {gap:.3e}"
               f" (relative L2) from the CPU's f32, bound {ZOO_GAP_BOUND}")
    print(f"eval_knn: {n_train} + {n_val} images at ViT-S/16, 224 px, batch "
          f"128; the card's features of 8 images {gap:.3e} from the CPU's "
          f"f32 (relative L2, bound {ZOO_GAP_BOUND})", flush=True)
    run["knn"] = dict(cli_s=knn_s, gap=gap,
                      top1={str(k): v[0] for k, v in knn.items()},
                      imagenet=_evals_knn_imagenet(torch))

    acc, _out, lin_s = _run_cli(eval_linear.main, [
        "--data_path", trees["folder"], "--epochs", "2", *dev], "eval_linear")
    if not 0.0 <= acc <= 100.0:
        _fatal(f"eval_linear: val top-1 {acc}")
    run["linear"] = dict(cli_s=lin_s, top1=acc, **_evals_probe_rate(torch))

    cd_args = ["--data_path", trees["copydays"], "--distractors_path",
               trees["distractors"], "--whitening_path", trees["whitening"],
               *dev]
    cd, _out, cd_s = _run_cli(eval_copy_detection.main, cd_args,
                              "eval_copy_detection")
    n_cd = (COPYDAYS_ORIGINALS * 19 + COPYDAYS_ORIGINALS // 2
            + COPYDAYS_ORIGINALS + sum(n for _, n in COPYDAYS_EXTRA))
    if not (len(cd) == 20 and all(0.0 <= v <= 1.0 for v in cd.values())):
        _fatal(f"eval_copy_detection: {cd}")
    run["copydays"] = dict(cli_s=cd_s, images=n_cd,
                           cli_images_s=n_cd / cd_s, mAP=cd)

    run["retrieval"] = {}
    for ms in ("0", "1"):
        res, _out, r_s = _run_cli(eval_image_retrieval.main, [
            "--data_path", trees["revisited"], "--multiscale", ms, *dev],
            f"eval_image_retrieval --multiscale {ms}")
        if not all(0.0 <= res[k] <= 1.0 for k in ("mAP_M", "mAP_H")):
            _fatal(f"eval_image_retrieval: {res}")
        run["retrieval"]["multiscale" if ms == "1" else "plain"] = dict(
            cli_s=r_s, mAP_M=res["mAP_M"], mAP_H=res["mAP_H"])

    out_dir = os.path.join(work, "evals", "davis_out")
    written, _out, dv_s = _run_cli(eval_video_segmentation.main, [
        "--data_path", trees["davis"], "--output_dir", out_dir, *dev],
        "eval_video_segmentation")
    labels = set()
    for p in written:
        im = Image.open(p)
        if im.mode != "P" or im.size != DAVIS_HW[::-1]:
            _fatal(f"eval_video_segmentation: {p} is {im.mode} {im.size}")
        labels |= set(np.unique(np.asarray(im)).tolist())
    if len(written) != DAVIS_FRAMES or not labels <= {0, 1, 2}:
        _fatal(f"eval_video_segmentation: {len(written)} PNGs, labels "
               f"{sorted(labels)}")
    run["davis"] = dict(cli_s=dv_s, pngs=len(written),
                        **_evals_davis_times(torch, trees["davis"]))
    run["rates"] = _evals_rates(torch)
    run["phase_s"] = time.perf_counter() - t_start
    print(f"evals phase: {run['phase_s']:.1f} s", flush=True)
    return run


# The viz phase (phase 13).  visualize_attention's arrays at the CLI's
# default arch and size, and at the main path's ViT-B/8 at 224 and at 480
# px (the crop past the 256-px resize: the zero-pad branch, N = 3,601);
# then the attention video of VIZ_FRAMES seeded frames at DAVIS's size.
VIZ_RUNS = (("dino_deitsmall8", 224), ("dino_vitbase8", 224),
            ("dino_vitbase8", 480))
VIZ_THRESHOLD = 0.6
VIZ_FRAMES, VIZ_FRAME_HW = 16, (480, 854)
# The card's f32 CLS attention (TF32 off) against the CPU's or a float64
# run, relative L2: f32's unit roundoff (6e-8) times the sqrt(n) growth of
# a sum of n <= 3,601 terms is about 3.6e-6 a product, and the error of the
# residual stream carries through 12 blocks of 6 products each; 1e-4 holds
# that with room, while a wrong mask, scale or prefix moves the maps at
# O(1).  The threshold masks may differ only where an element's cumulative
# mass lies within this bound (plus its own mass) of 1 - threshold.
VIZ_GAP_BOUND = 1e-4


def _viz_mask_check(np, cli, got, want, label: str) -> int:
    """The final block's threshold masks of ``got`` [nh, N] against
    ``want``'s: equal outside the band (VIZ_GAP_BOUND); returns the
    number of elements inside it."""
    share, cum = cli.cumulative_mass(want)
    band = np.abs(cum - (1 - VIZ_THRESHOLD)) <= share + VIZ_GAP_BOUND
    g = cli.threshold_masks(got, VIZ_THRESHOLD)
    w = cli.threshold_masks(want, VIZ_THRESHOLD)
    bad = int((g != w)[~band].sum())
    if bad:
        _fatal(f"{label}: {bad} threshold-mask elements differ outside the "
               f"band of {VIZ_GAP_BOUND}")
    return int(band.sum())


def _viz_cls_f64(torch, model, chw):
    """Every block's CLS rows [depth, nh, N] of a float64 evaluation of
    ``model`` (moved to float64 in place) on the card."""
    skip = model.cfg.num_prefix_tokens
    model.double()
    with torch.inference_mode():
        x = model.prepare_tokens(torch.from_numpy(chw[None]).cuda().double())
        rows = []
        for blk in model.blocks:
            attn, x = blk(x, return_attention=True)
            rows.append(attn[0, :, 0, skip:])
            del attn
        return torch.stack(rows).cpu().numpy()


def phase_viz(torch, root: str, work: str) -> dict:
    """The visualization layer on the card (module docstring, phase 13):
    visualize_attention's array function and the attention video."""
    import numpy as np
    from PIL import Image

    from tpu_ac_torch.cli import visualize_attention as cli
    from tpu_ac_torch.models.registry import load_backbone
    from tpu_ac_torch.viz import video

    t_start = time.perf_counter()
    # a path relative to the tree: the CLI finds the ground truth by
    # replacing every "test" in the path, as the reference does
    rel = os.path.join("bottle", "test", "broken_large", "000.png")
    runs: dict = {}
    models: dict = {}
    with contextlib.chdir(root):
        if not os.path.isfile(rel.replace("test", "ground_truth")
                              .replace(".png", "_mask.png")):
            _fatal(f"viz: no ground-truth mask for {rel}")
        for name, size in VIZ_RUNS:
            if name not in models:
                models[name] = load_backbone(name)[0]
            model = models[name]
            label = f"viz {name} {size} px"
            want = None
            if size == 224:  # the same function on the CPU
                want = cli.attention_arrays(model, rel, (size, size),
                                            VIZ_THRESHOLD, "cpu")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            got = cli.attention_arrays(model, rel, (size, size),
                                       VIZ_THRESHOLD, "cuda")
            arrays_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            chw = got["image"]
            x = torch.from_numpy(chw[None]).cuda()

            def attn_all(model=model, x=x):
                with torch.inference_mode():
                    model.all_selfattentions(x)

            ms, host_ms = _time_ms(attn_all, reps=3 if size > 256 else 5)
            n = chw.shape[1] // model.cfg.patch_size * (
                chw.shape[2] // model.cfg.patch_size)
            depth, nh = model.cfg.depth, model.cfg.num_heads
            if got["cls_attn"].shape != (depth, nh, n) or not np.isfinite(
                    got["cls_attn"]).all() or got["gt"] is None \
                    or got["maps"].shape != (depth, nh, size, size) \
                    or got["th_attn_up"].shape != (nh, size, size):
                _fatal(f"{label}: cls {got['cls_attn'].shape}, maps "
                       f"{got['maps'].shape}, gt {got['gt'] is not None}")
            if want is None:  # 480: a float64 evaluation on the card
                t0 = time.perf_counter()
                ref = _viz_cls_f64(torch, model, chw)
                ref_s = time.perf_counter() - t0
                model.float()
                yardstick = "float64 on the card"
            else:
                ref, ref_s, yardstick = want["cls_attn"], None, "the CPU"
            gap = _rel_gap(torch, torch.from_numpy(got["cls_attn"]),
                           torch.from_numpy(ref.astype(np.float32)))
            if want is not None and not (
                    np.array_equal(got["disp"], want["disp"])
                    and np.array_equal(chw, want["image"])):
                _fatal(f"{label}: the input or display image differs from "
                       "the CPU's")
            if not gap <= VIZ_GAP_BOUND:
                _fatal(f"{label}: CLS attention {gap:.3e} from {yardstick} "
                       f"(relative L2), bound {VIZ_GAP_BOUND}")
            in_band = _viz_mask_check(np, cli, got["cls_attn"][-1],
                                      ref[-1].astype(np.float32), label)
            n_tok = n + model.cfg.num_prefix_tokens
            share = _vit_flops(model.cfg, size, size) / (ms * 1e-3) \
                / PEAK_F32_FLOPS
            runs[f"{name}_{size}"] = dict(
                tokens=n_tok, all_selfattentions_ms=ms,
                all_selfattentions_host_ms=host_ms, arrays_s=arrays_s,
                peak_gib=(peak - base) / 2**30, gap=gap,
                yardstick=yardstick, mask_band_elements=in_band,
                reference_s=ref_s, flops_share_f32=share)
            print(f"{label}: N = {n_tok}, all_selfattentions {ms:.2f} ms "
                  f"(host {host_ms:.2f} ms), {100 * share:.1f}% "
                  f"of the f32 peak; attention_arrays {arrays_s:.2f} s; "
                  f"peak {(peak - base) / 2**30:.2f} GiB over the "
                  f"{base / 2**30:.2f} GiB already held; CLS rows {gap:.3e} "
                  f"from {yardstick} (bound {VIZ_GAP_BOUND}); masks at "
                  f"{VIZ_THRESHOLD} equal outside {in_band} band elements",
                  flush=True)

    # the video: seeded frames at DAVIS's size, a directory of JPEGs
    frames_dir = os.path.join(work, "viz", "frames")
    os.makedirs(frames_dir)
    rng = np.random.default_rng(13)
    for i, a in enumerate(_smooth_images(rng, VIZ_FRAMES, VIZ_FRAME_HW)):
        Image.fromarray(a).save(os.path.join(frames_dir, f"{i:05d}.jpg"),
                            quality=95)
    model = models["dino_deitsmall8"]
    out = os.path.join(work, "viz", "video.gif")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = video.generate_attention_video_from_path(model, frames_dir, out,
                                                    device="cuda")
    video_s = time.perf_counter() - t0
    gif = Image.open(path)
    ps = model.cfg.patch_size
    hw = tuple(d - d % ps for d in VIZ_FRAME_HW)
    if path != out or gif.n_frames != VIZ_FRAMES or gif.size != hw[::-1]:
        _fatal(f"viz video: {path}, {gif.n_frames} frames of {gif.size}")
    raw = [np.asarray(Image.open(os.path.join(frames_dir, f)).convert("RGB"))
           for f in sorted(os.listdir(frames_dir))]
    frames = video.preprocess_frames(raw, ps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    heat = video.render_attention_frames(model, frames, "mean", "cuda")
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    video.write_video(heat, os.path.join(work, "viz", "again.gif"), 10)
    write_s = time.perf_counter() - t0
    cpu = video.render_attention_frames(model, frames[:1], "mean", "cpu")[0]
    frame_gap = _rel_gap(torch, torch.from_numpy(heat[0]),
                         torch.from_numpy(cpu))
    if not frame_gap <= VIZ_GAP_BOUND:
        _fatal(f"viz video: frame 0's heat map {frame_gap:.3e} from the "
               f"CPU's, bound {VIZ_GAP_BOUND}")
    n_tok = hw[0] // ps * (hw[1] // ps) + model.cfg.num_prefix_tokens
    runs["video"] = dict(frames=VIZ_FRAMES, tokens=n_tok, video_s=video_s,
                         frames_per_s=VIZ_FRAMES / video_s,
                         render_frames_per_s=VIZ_FRAMES / render_s,
                         gif_write_s=write_s, frame_gap=frame_gap)
    print(f"viz video: {VIZ_FRAMES} frames of {hw[1]} x {hw[0]} (N = "
          f"{n_tok}, dino_deitsmall8) -> GIF in {video_s:.2f} s, "
          f"{VIZ_FRAMES / video_s:.2f} frames/s (render alone "
          f"{VIZ_FRAMES / render_s:.2f} frames/s, the GIF writer "
          f"{write_s:.2f} s); frame 0's heat map {frame_gap:.3e} from the "
          f"CPU's (bound {VIZ_GAP_BOUND})", flush=True)
    runs["phase_s"] = time.perf_counter() - t_start
    print(f"viz phase: {runs['phase_s']:.1f} s", flush=True)
    return runs


# The dist phase: training across processes on the one card.  Two ranks
# share cuda:0 over gloo (NCCL refuses two ranks on one GPU; gloo reduces
# CUDA tensors by all_reduce and broadcast, all that collectives.py uses).
# DINO: two steps at main_dino's ViT-S/16 recipe (out_dim 65536), 32
# images a rank, f32 with TF32 off, against one process on the 64 images
# (rank 0 computes it after the group is gone) within
# tests/test_torch_dino_train.py's rules: 2e-6 on the parameters and the
# teacher except Adam's sign swing, 2 lr a step, where the whole batch's
# first gradient is below 1e-6; Adam's moments and the center 1e-4
# relative (+ 1e-5 of the largest).  SCAN: one step of each kind at the
# CIFAR-10 recipe's batches (512, 128 with 10 heads, 1,000), train_dp 2,
# against the whole-batch step: in float64 (TF32 off) the two agree to
# DIST_F64_RTOL in the loss, every gradient, the BN statistics and the
# state after the step (Adam: 2 lr where the gradient is float64 noise
# about zero); in f32, where ResNet-18's gradients sit up to ~5e-3 from
# float64 in one process too, each is held to the float64 step by the SCAN
# phase's card-vs-CPU rules: no further than twice the one-process f32
# step, or SCAN_LOSS_GAP_BOUND, SCAN_GRAD_GAP_BOUND (each gradient and the
# whole gradient) and SCAN_BN_GAP_BOUND; the states after the step lr x
# the gradients' gap apart for SGD, 2 lr for Adam.
# The ranks' states must be bit-equal (SHA-256 of every leaf).  Then rank
# 1, its group gone, is one nccl rank (world 1): an init, an all-reduce
# and one DINO step (bf16, batch 64) bit-equal to the same step without a
# group.  The inputs are
# seeded normal crops made on the card; the self-label head is scaled by
# DIST_SELFLABEL_HEAD_GAIN so that some rows pass the 0.99 threshold, and
# the batch seed is the first whose rows all lie 1e-4 or more from it.
DIST_DEVICE = "cuda"
DIST_DINO_BATCH = 64
DIST_DINO_STEPS = 2
DIST_SCAN_BATCH = {"simclr": 512, "scan": 128, "selflabel": 1000}
DIST_SELFLABEL_HEAD_GAIN = 8.0
DIST_ALLREDUCE_REPS = 3
# float64 sums in other orders over the two ranks' shares
DIST_F64_RTOL = 1e-9


def _digest(tensors: dict) -> str:
    """SHA-256 over every tensor's bytes, in the order of the names."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _dist_dino_inputs(torch, cfg, dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    b = DIST_DINO_BATCH
    return [(torch.randn(2 * b, 3, cfg.global_size, cfg.global_size,
                         device=dev, generator=gen),
             torch.randn(cfg.local_crops_number * b, 3, cfg.local_size,
                         cfg.local_size, device=dev, generator=gen))
            for _ in range(DIST_DINO_STEPS)]


def _share(x, views: int, rank: int, world: int):
    """Rank ``rank``'s share of a crop-major batch [views * B, ...]."""
    v = x.reshape(views, -1, *x.shape[1:])
    m = v.shape[1] // world
    return v[:, rank * m:(rank + 1) * m].reshape(-1, *x.shape[1:])


def _dist_dino(torch, vit_cfg, cfg, state, batches, rank, world):
    """DIST_DINO_STEPS f32 steps on this rank's share: (state, losses)."""
    from tpu_ac_torch.train.dino import make_dino_train_step

    step = make_dino_train_step(vit_cfg, cfg)
    losses = []
    for g, l in batches:
        state, m = step(state, _share(g, 2, rank, world),
                        _share(l, cfg.local_crops_number, rank, world),
                        lr=DINO_LR, wd=0.04, teacher_momentum=0.996,
                        teacher_temp=cfg.teacher_temp, freeze_last=False)
        losses.append(float(m["loss"]))
    return state, losses


def _dist_scan_cases(torch, dev):
    """name: (model config, optimizer, lr, Adam?, loss_and_grads, frozen,
    params, bn, batch size): the CIFAR-10 recipe's steps."""
    from tpu_ac_torch.models.resnet_cifar import RESNET18_CIFAR
    from tpu_ac_torch.train import optim
    from tpu_ac_torch.train import scan as ts

    mcfg = ts.SCANModelConfig(backbone=RESNET18_CIFAR, feature_dim=128,
                              n_clusters=10, n_heads=10)
    one = ts.SCANModelConfig(backbone=RESNET18_CIFAR, feature_dim=128,
                             n_clusters=10, n_heads=1)
    p, bn = ts.init_contrastive_model(0, mcfg, dev)
    cp, cbn = ts.init_clustering_model(0, mcfg, dev)
    sp, sbn = ts.init_clustering_model(0, one, dev)
    sp = {**sp, "cluster_head.0.weight":
          sp["cluster_head.0.weight"] * DIST_SELFLABEL_HEAD_GAIN}

    def head(k):
        return not k.startswith("cluster_head")

    return {
        "simclr": (optim.chain(optim.add_decayed_weights(1e-4),
                               optim.sgd(0.4, momentum=0.9)), 0.4, False,
                   lambda s, a, b: ts.simclr_loss_and_grads(
                       s, a, b, mcfg, 0.1), None, p, bn),
        "scan": (optim.adam(1e-4), 1e-4, True,
                 lambda s, a, b: ts.scan_loss_and_grads(s, a, b, mcfg, 2.0),
                 None, cp, cbn),
        "scan_head_only": (optim.adam(1e-4), 1e-4, True,
                           lambda s, a, b: ts.scan_loss_and_grads(
                               s, a, b, mcfg, 2.0, True), head, cp, cbn),
        "selflabel": (optim.sgd(0.03, momentum=0.9), 0.03, False,
                      lambda s, a, b: ts.selflabel_loss_and_grads(
                          s, a, b, one, 0.99, True), None, sp, sbn),
    }, one


def _dist_scan_batch(torch, name: str, dev, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = DIST_SCAN_BATCH[name.replace("_head_only", "")]
    a = torch.randn(n, 3, 32, 32, device=dev, generator=gen)
    return a, a + 0.5 * torch.randn(n, 3, 32, 32, device=dev, generator=gen)


def _selflabel_seed(torch, one, params, bn, dev, rank, world) -> tuple:
    """The first batch seed whose weak pass (train-mode BN over the global
    batch) puts every row 1e-4 or more from the 0.99 threshold and at
    least one over it: (seed, confident rows)."""
    from tpu_ac_torch.distributed import collectives
    from tpu_ac_torch.train import scan as ts

    for seed in range(1, 9):
        a, _ = _dist_scan_batch(torch, "selflabel", dev, seed)
        m = len(a) // world
        with torch.no_grad():
            conf = torch.softmax(ts.clustering_forward(
                params, bn, a[rank * m:(rank + 1) * m], one,
                train=True)[0][0], 1).amax(1)
        counts = collectives.all_reduce_sum(torch.stack([
            (conf > 0.99).sum(), ((conf - 0.99).abs() < 1e-4).sum()]))
        if int(counts[1]) == 0 and int(counts[0]) > 0:
            return seed, int(counts[0])
    return None, 0


def _dist_scan(torch, cases, dev, rank, world, seed_sl,
               dtype=None):
    """One step of each kind on this rank's share (in ``dtype``, f32 by
    default): {name: (loss, grads, state after)}, every tensor on the
    host."""
    from tpu_ac_torch.device import precision_scope
    from tpu_ac_torch.train import scan as ts

    dtype = dtype or torch.float32
    out = {}
    with precision_scope("highest"):
        for name, (opt, _lr, _adam, lg, frozen, params, bns) in \
                cases.items():
            a, b = _dist_scan_batch(torch, name, dev,
                                    seed_sl if name == "selflabel" else 3)
            m = len(a) // world
            state = ts.init_train_state(
                {k: v.to(dtype) for k, v in params.items()},
                {k: v.to(dtype) for k, v in bns.items()}, opt)
            loss, aux, grads = lg(state,
                                  a[rank * m:(rank + 1) * m].to(dtype),
                                  b[rank * m:(rank + 1) * m].to(dtype))
            new_bn = aux[0] if isinstance(aux, tuple) else aux
            new = ts.apply_gradients(state, grads, new_bn, opt, frozen)
            out[name] = (float(loss), {k: v.cpu() for k, v in grads.items()},
                         {**{f"p/{k}": v.cpu() for k, v in new.params.items()},
                          **{f"bn/{k}": v.cpu()
                             for k, v in new.bn_state.items()}})
    return out


def _dist_rank(rank: int, world: int, coord: str, nccl_coord: str,
               work: str) -> None:
    """One of the two gloo ranks on DIST_DEVICE (spawned); writes
    dist_rank{rank}.json.  After the group is gone rank 0 writes the
    comparison with one process on the whole batch and, meanwhile, rank 1
    runs the nccl rank of world 1 (``_dist_nccl_one``)."""
    import torch

    from tpu_ac_torch.cli.dino import _leaves
    from tpu_ac_torch.device import precision_scope
    from tpu_ac_torch.distributed import collectives, multihost_init
    from tpu_ac_torch.train.dino import init_dino_state

    t0 = time.perf_counter()
    dev = torch.device(DIST_DEVICE)
    multihost_init(coord, world, rank, backend="gloo")
    vit_cfg, cfg, _ = _dino_recipe()
    state0 = init_dino_state(0, vit_cfg, cfg, device=dev)
    batches = _dist_dino_inputs(torch, cfg, dev)
    with precision_scope("highest"):
        state, losses = _dist_dino(torch, vit_cfg, cfg, state0, batches,
                                   rank, world)
    dino_leaves = {**_leaves(state), "step": state.step}
    # the gradient bucket's all-reduce alone, at its size
    bucket = {k: torch.zeros_like(v) for k, v in state.student.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(DIST_ALLREDUCE_REPS):
        collectives.all_reduce_dict(bucket)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    allreduce_ms = (time.perf_counter() - t1) * 1e3 / DIST_ALLREDUCE_REPS
    del bucket
    cases, one = _dist_scan_cases(torch, dev)
    sl = cases["selflabel"]
    with precision_scope("highest"):
        seed_sl, confident = _selflabel_seed(torch, one, sl[5], sl[6], dev,
                                             rank, world)
    if seed_sl is None:
        raise RuntimeError("dist selflabel: no batch seed in 1..8 has its "
                           "confidences 1e-4 or more from 0.99 with a row "
                           "over it")
    scan = {dt: _dist_scan(torch, cases, dev, rank, world, seed_sl,
                           getattr(torch, dt))
            for dt in ("float32", "float64")}
    with open(os.path.join(work, f"dist_rank{rank}.json"), "w") as f:
        json.dump({"dino": _digest(dino_leaves), "dino_losses": losses,
                   "scan": {f"{dt}/{k}": _digest(v[2])
                            for dt, runs in scan.items()
                            for k, v in runs.items()},
                   "allreduce_ms": allreduce_ms,
                   "bucket_mb": sum(v.numel() for v in state.student.values())
                   * 4 / 1e6, "seconds": time.perf_counter() - t0}, f)
    torch.distributed.destroy_process_group()
    if rank:
        del state, state0, batches, dino_leaves
        _dist_nccl_one(nccl_coord, work)
        return
    # one process on the whole batch (no group now: the step's collectives
    # return their inputs)
    rows = {"dino": _dist_dino_check(torch, vit_cfg, cfg, state0, batches,
                                     state, losses),
            "scan": _dist_scan_check(torch, cases, dev, scan, seed_sl),
            "selflabel_confident": confident}
    with open(os.path.join(work, "dist_check.json"), "w") as f:
        json.dump(rows, f)


def _dist_dino_check(torch, vit_cfg, cfg, state0, batches, got, losses):
    """The two ranks' state (rank 0's) against one process's on the whole
    batch (see the block comment above the dist phase)."""
    from tpu_ac_torch.cli.dino import _leaves
    from tpu_ac_torch.device import precision_scope
    from tpu_ac_torch.train.dino import build_dino_model, dino_loss_and_grads

    with precision_scope("highest"):
        g0 = dino_loss_and_grads(build_dino_model(vit_cfg, cfg), state0,
                                 *batches[0], cfg.teacher_temp, cfg)[2]
        want, want_losses = _dist_dino(torch, vit_cfg, cfg, state0, batches,
                                       0, 1)
    a_all, b_all = _leaves(got), _leaves(want)
    worst = {"param": 0.0, "swing_lr": 0.0, "moment": 0.0}
    for k, b in b_all.items():
        a, b = a_all[k].double(), b.double()
        part, _, name = k.partition("/")
        if part in ("student", "teacher"):
            eps = g0[name].abs() < 1e-6
            swing = float((a - b).abs()[eps].max()) if bool(eps.any()) \
                else 0.0
            gap = float((a - b).abs()[~eps].max()) if bool((~eps).any()) \
                else 0.0
            worst["swing_lr"] = max(worst["swing_lr"], swing / DINO_LR)
            worst["param"] = max(worst["param"], gap)
            if swing > 2 * DINO_LR * DIST_DINO_STEPS or gap > 2e-6:
                raise RuntimeError(f"dist dino {k}: {gap:.3e} apart (bound "
                                   f"2e-6), {swing:.3e} where the gradient "
                                   f"is near eps (bound 2 lr a step)")
        elif k != "count":
            over = float(((a - b).abs() / (1e-4 * b.abs()
                                          + 1e-5 * float(b.abs().max())
                                          + 1e-30)).max())
            worst["moment"] = max(worst["moment"], over)
            if over > 1:
                raise RuntimeError(f"dist dino {k}: {over:.3f} of its bound")
        elif not torch.equal(a_all[k], want.opt_state.count):
            raise RuntimeError("dist dino: Adam's count differs")
    return dict(worst, whole_losses=want_losses)


def _dist_scan_check(torch, cases, dev, got, seed_sl) -> dict:
    """Each kind's two-rank step (rank 0's; its gradients are the ranks'
    mean), in float64 and in f32, against the whole-batch step (see the
    block comment above the dist phase)."""
    want = {dt: _dist_scan(torch, cases, dev, 0, 1, seed_sl,
                           getattr(torch, dt))
            for dt in ("float32", "float64")}

    def norm(x) -> float:
        return float(torch.linalg.vector_norm(x.double()))

    def rel(a, b) -> float:
        return norm(a - b) / max(norm(b), 1e-300)

    def over(a, w, r, floor) -> float:
        """a's gap to r over max(2 x w's gap, floor x |r|)."""
        return norm(a - r) / max(2 * norm(w - r), floor * norm(r), 1e-30)

    rows = {}
    for name in cases:
        lr, is_adam = cases[name][1], cases[name][2]
        # float64: the same step to DIST_F64_RTOL
        loss, grads, after = got["float64"][name]
        w_loss, w_grads, w_after = want["float64"][name]
        g_max = max(float(v.abs().max()) for v in w_grads.values())
        f64_gap = abs(loss - w_loss) / abs(w_loss)
        for k, v in w_grads.items():
            f64_gap = max(f64_gap, rel(grads[k], v))
        for k, v in w_after.items():
            if is_adam and k.startswith("p/"):
                noise = w_grads[k[2:]].abs() <= DIST_F64_RTOL * g_max
                allowed = torch.where(noise, 2 * lr, DIST_F64_RTOL
                                      * (v.abs() + lr))
                if bool(((after[k] - v).abs() > allowed).any()):
                    f64_gap = math.inf
            else:
                f64_gap = max(f64_gap, rel(after[k], v))
        if f64_gap > DIST_F64_RTOL:
            raise RuntimeError(f"dist scan {name} float64: the two ranks "
                               f"{f64_gap:.3e} from the whole batch (bound "
                               f"{DIST_F64_RTOL})")
        ref_loss, ref_grads, ref_after = loss, grads, after
        # f32: held to float64 by the SCAN phase's rules
        loss, grads, after = got["float32"][name]
        w_loss, w_grads, w_after = want["float32"][name]
        loss_over = over(torch.tensor(loss), torch.tensor(w_loss),
                         torch.tensor(ref_loss), SCAN_LOSS_GAP_BOUND)
        gaps = {k: over(grads[k], w_grads[k], v, SCAN_GRAD_GAP_BOUND)
                for k, v in ref_grads.items() if norm(v) > 0}
        ref_sq = sum(norm(v) ** 2 for v in ref_grads.values())
        whole, whole_w = (math.sqrt(sum(norm(g[k] - v) ** 2
                                        for k, v in ref_grads.items())
                                    / ref_sq) for g in (grads, w_grads))
        bn_over = max(over(after[k], w_after[k], v, SCAN_BN_GAP_BOUND)
                      for k, v in ref_after.items() if k.startswith("bn/"))
        state_over = 0.0
        for k, v in w_after.items():
            if not k.startswith("p/"):
                continue
            a, c = after[k].double(), v.double()
            if is_adam:
                gap, bound = float((a - c).abs().max()), 2 * lr
            else:
                g = k[2:]
                gap = norm(a - c)
                bound = (lr * (1 + 1e-3) * norm(grads[g] - w_grads[g])
                         + 1e-6 * norm(c))
            state_over = max(state_over, gap / max(bound, 1e-30))
        worst = max(gaps, key=gaps.get)
        if (max(loss_over, gaps[worst], bn_over) > 1
                or whole > max(2 * whole_w, SCAN_GRAD_GAP_BOUND)
                or state_over > 1 + 1e-9):
            raise RuntimeError(
                f"dist scan {name} f32: loss {loss_over:.3f} of its bound, "
                f"gradient {worst} {gaps[worst]:.3f} of its bound, whole "
                f"gradient {whole:.3e} from float64 (one process "
                f"{whole_w:.3e}), BN statistics {bn_over:.3f} of their "
                f"bound, states {state_over:.3f} of their bound")
        rows[name] = dict(f64_gap=f64_gap, loss=loss, whole_loss=w_loss,
                          loss_over_bound=loss_over,
                          grad_over_bound=gaps[worst],
                          whole_grad_gap=whole, whole_grad_gap_one=whole_w,
                          bn_over_bound=bn_over,
                          state_over_bound=state_over)
    return rows


def _dist_nccl_one(coord: str, work: str) -> None:
    """One nccl rank (world 1): an init, an all-reduce and one DINO step
    (bf16, the recipe's batch), then the same step with no group; writes
    both digests."""
    import torch
    import torch.distributed as dist

    from tpu_ac_torch.cli.dino import _leaves
    from tpu_ac_torch.train.dino import init_dino_state, make_dino_train_step

    dev = torch.device("cuda")
    dist.init_process_group("nccl", init_method=f"tcp://{coord}",
                            world_size=1, rank=0)
    t = torch.ones(4, device=dev)
    dist.all_reduce(t)
    vit_cfg, cfg, _ = _dino_recipe()
    state = init_dino_state(0, vit_cfg, cfg, device=dev)
    g, l = _dist_dino_inputs(torch, cfg, dev)[0]
    step = make_dino_train_step(vit_cfg, cfg, compute_dtype=torch.bfloat16)
    kw = dict(lr=DINO_LR, wd=0.04, teacher_momentum=0.996,
              teacher_temp=cfg.teacher_temp, freeze_last=False)
    in_group = _leaves(step(state, g, l, **kw)[0])
    digest_group = _digest(in_group)
    del in_group
    dist.destroy_process_group()
    alone = _digest(_leaves(step(state, g, l, **kw)[0]))
    with open(os.path.join(work, "dist_nccl.json"), "w") as f:
        json.dump({"all_reduce": t.tolist(), "group": digest_group,
                   "alone": alone, "backend": "nccl"}, f)


def _spawn(fn, nprocs: int, args: tuple, timeout_s: float) -> None:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes, joined; fatal
    if one fails or the set outlives ``timeout_s``; the spawn context's
    semaphore tracker is stopped after, so no process outlives it."""
    import torch.multiprocessing as mp
    from multiprocessing import resource_tracker
    from torch.multiprocessing.spawn import ProcessException

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > timeout_s:
                for p in ctx.processes:
                    p.kill()
                _fatal(f"dist: {fn.__name__} outlived {timeout_s} s")
    except ProcessException as e:
        _fatal(f"dist: {fn.__name__} failed:\n{e}")
    finally:
        for p in ctx.processes:
            p.join(timeout=30)
        resource_tracker._resource_tracker._stop()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist(torch, work: str) -> dict:
    """Training across processes on the one card (see the block comment
    above): two gloo ranks, then one nccl rank."""
    t_start = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()  # the ranks share the card with this process
    _spawn(_dist_rank, 2, (2, f"127.0.0.1:{_free_port()}",
                           f"127.0.0.1:{_free_port()}", work), 300)
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"dist_rank{r}.json")) as f:
            ranks.append(json.load(f))
    with open(os.path.join(work, "dist_check.json")) as f:
        check = json.load(f)
    r0, r1 = ranks
    if r0["dino"] != r1["dino"] or r0["scan"] != r1["scan"]:
        _fatal(f"dist: the ranks' states differ: DINO {r0['dino'][:12]} / "
               f"{r1['dino'][:12]}, SCAN {r0['scan']} / {r1['scan']}")
    d, s = check["dino"], check["scan"]
    # each rank's loss is its share's mean: their mean is the batch's
    losses = [(a + b) / 2 for a, b in zip(r0["dino_losses"],
                                          r1["dino_losses"])]
    d["loss_gap"] = max(abs(x - y) / abs(y)
                        for x, y in zip(losses, d["whole_losses"]))
    if d["loss_gap"] > DINO_LOSS_GAP_BOUND:
        _fatal(f"dist dino: the ranks' mean losses {losses}, one "
               f"process's {d['whole_losses']} (bound "
               f"{DINO_LOSS_GAP_BOUND} relative)")
    print(f"dist (2 gloo ranks on one card, {r0['seconds']:.1f} s to their "
          f"states): DINO ViT-S/16 "
          f"out_dim 65536, {DIST_DINO_BATCH // 2} images a rank, "
          f"{DIST_DINO_STEPS} f32 steps (TF32 off): the ranks' states "
          f"bit-equal; against one process on {DIST_DINO_BATCH}: parameters "
          f"{d['param']:.3e} apart at most (bound 2e-6), {d['swing_lr']:.3f} "
          f"lr where the first gradient is near eps (bound "
          f"{2 * DIST_DINO_STEPS} lr), moments and center at "
          f"{d['moment']:.3f} of their bound, the ranks' mean losses "
          f"{losses} against {d['whole_losses']} (gap {d['loss_gap']:.2e}); "
          f"gloo all-reduce of the "
          f"{r0['bucket_mb']:.1f} MB gradient bucket "
          f"{r0['allreduce_ms']:.1f} ms a step (rank 0), "
          f"{r1['allreduce_ms']:.1f} ms (rank 1); SCAN train_dp 2: " + "; "
          .join(f"{k} float64 {v['f64_gap']:.2e} from the whole batch; f32 "
                f"(float64 the reference) loss at "
                f"{v['loss_over_bound']:.3f} of its bound, gradient "
                f"{v['grad_over_bound']:.3f}, whole gradient "
                f"{v['whole_grad_gap']:.2e} from float64 (one process "
                f"{v['whole_grad_gap_one']:.2e}), BN "
                f"{v['bn_over_bound']:.3f}, states "
                f"{v['state_over_bound']:.3f} of their bound"
                for k, v in s.items())
          + f"; self-label rows over 0.99: {check['selflabel_confident']}",
          flush=True)
    with open(os.path.join(work, "dist_nccl.json")) as f:
        nccl = json.load(f)
    if nccl["all_reduce"] != [1.0] * 4 or nccl["group"] != nccl["alone"]:
        _fatal(f"dist nccl world 1: {nccl}")
    phase_s = time.perf_counter() - t_start
    print(f"dist nccl (world 1, rank 1's process after its gloo group): "
          f"init, all-reduce and one bf16 DINO step bit-equal to the step "
          f"with no group; dist phase {phase_s:.1f} s", flush=True)
    return dict(phase_s=phase_s, gloo_s=r0["seconds"],
                allreduce_ms=r0["allreduce_ms"], bucket_mb=r0["bucket_mb"],
                dino=d, scan=s)


# The scaling mode (``python3 chip_smoke.py --scaling N``, on a host of N
# cards): DINO at main_dino's recipe (batch 64 a card, bf16, --device_aug)
# and SCAN's SimCLR stage at the CIFAR-10 recipe (batch 512 in all), on
# one card and on N, each run a process (or N) of its own, as a user runs
# them: DINO on N cards under ``python -m torch.distributed.run
# --nproc_per_node N`` (nccl), SCAN's ``train_dp: N`` with ``cli.scan``
# starting its N ranks itself.  An ImageFolder of SCALING_DINO_STEPS x 64
# x N images, so that each rank takes SCALING_DINO_STEPS steps an epoch on
# N cards (the one-card run is capped at the same count), and a CIFAR-10
# of SCAN_TRAIN images.  Epoch 1 of each run (epoch 0 warms up) is read
# from its dino_epoch / scan_epoch lines: the step's ms by CUDA events
# (the slowest rank's) and the images a second over every rank; the
# scaling is images/s on N cards over images/s on one.
SCALING_DINO_STEPS = 6


def _run_logged(cmd: list[str], timeout: int) -> str:
    """``cmd`` as a process: its stdout; fatal if it fails."""
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=HERE))
    if run.returncode:
        print(run.stdout[-4000:], run.stderr[-4000:], sep="\n",
              file=sys.stderr)
        _fatal(f"{' '.join(cmd[:6])} ... exited {run.returncode}")
    print(f"{' '.join(cmd[:8])} ...: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return run.stdout


def _json_lines(out: str, tag: str) -> list[dict]:
    """Every ``tag {json}`` record in ``out``, wherever it starts: the
    ranks of one run share the pipe, so another rank's output may follow a
    record on its line."""
    dec, rows, at = json.JSONDecoder(), [], 0
    while (at := out.find(tag + " {", at)) >= 0:
        row, at = dec.raw_decode(out, at + len(tag) + 1)
        rows.append(row)
    return rows


def _scaling_dino(work: str, root: str, cards: int) -> dict:
    """The DINO run on ``cards`` cards: epoch 1's step ms (the slowest
    rank's) and images/s over every rank."""
    out = os.path.join(work, f"dino_out_{cards}")
    args = ["-m", "tpu_ac_torch.cli.dino", "--data_path", root,
            "--output_dir", out, "--saveckp_freq", "0", "--device_aug",
            "--data_cache", os.path.join(work, "dino_cache"),
            "--batch_size_per_gpu", str(DINO_BATCH), "--epochs", "2",
            "--max_steps_per_epoch", str(SCALING_DINO_STEPS)]
    launch = ([sys.executable] if cards == 1 else
              [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", str(cards)])
    epochs = [e for e in _json_lines(_run_logged(launch + args, 900),
                                     "dino_epoch") if e["epoch"] == 1]
    shutil.rmtree(out)
    if len(epochs) != cards:
        _fatal(f"dino on {cards} cards: {len(epochs)} epoch-1 lines")
    step_ms = max(e["step_ms"] for e in epochs)
    return dict(step_ms=step_ms,
                ranks_step_ms=[e["step_ms"] for e in epochs],
                img_s=DINO_BATCH * cards / (step_ms / 1e3),
                peak_gib=max(e["peak_gib"] for e in epochs),
                steps=epochs[0]["steps"])


def _scaling_scan(work: str, data: str, cards: int) -> dict:
    """SCAN's SimCLR stage with ``train_dp: cards`` (off for one card):
    epoch 1's step ms (the slowest rank's) and images/s."""
    from tpu_ac_torch.config import CONFIG_DIR

    out = os.path.join(work, f"scan_out_{cards}")
    env = os.path.join(work, f"scan_env_{cards}.yml")
    with open(env, "w") as f:
        f.write(f"root_dir: {out}\ndata_root: {data}\n")
    with open(os.path.join(CONFIG_DIR, "pretext",
                           "simclr_cifar-10.yml")) as f:
        text = f.read()
    exp = os.path.join(work, f"scan_simclr_{cards}.yml")
    with open(exp, "w") as f:
        f.write(text.replace("\nepochs:", "\n# recipe epochs:")
                + "epochs: 2\n" + (f"train_dp: {cards}\n" if cards > 1
                                   else ""))
    stdout = _run_logged([sys.executable, "-m", "tpu_ac_torch.cli.scan",
                          "simclr", "--config_env", env, "--config_exp", exp],
                         900)
    epochs = [e for e in _json_lines(stdout, "scan_epoch")
              if e["epoch"] == 1]
    shutil.rmtree(out)
    if len(epochs) != cards:
        _fatal(f"scan on {cards} cards: {len(epochs)} epoch-1 lines")
    step_ms = max(e["step_ms"] for e in epochs)
    return dict(step_ms=step_ms,
                ranks_step_ms=[e["step_ms"] for e in epochs],
                img_s=epochs[0]["images_per_step"] / (step_ms / 1e3),
                data_wait_ms=max(e["data_wait_ms"] for e in epochs),
                steps=epochs[0]["steps"])


def phase_scaling(torch, cards: int) -> dict:
    """The scaling mode (see the comment above)."""
    if torch.cuda.device_count() < cards:
        _fatal(f"--scaling {cards}: {torch.cuda.device_count()} cards")
    work = os.path.join(HERE, "build", "scaling")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        root = _make_imagefolder(
            work, SCALING_DINO_STEPS * DINO_BATCH * cards)
        data = _make_cifar10(work)
        runs = {"dino": {n: _scaling_dino(work, root, n)
                         for n in (1, cards)},
                "scan_simclr": {n: _scaling_scan(work, data, n)
                                for n in (1, cards)}}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name, r in runs.items():
        r["scaling"] = r[cards]["img_s"] / r[1]["img_s"]
        print(f"{name}: 1 card {r[1]['step_ms']:.2f} ms a step, "
              f"{r[1]['img_s']:.1f} images/s; {cards} cards "
              f"{r[cards]['step_ms']:.2f} ms a step, "
              f"{r[cards]['img_s']:.1f} images/s; scaling "
              f"{r['scaling']:.3f} (ideal {cards})", flush=True)
    return {k: {str(n): v for n, v in r.items()} for k, r in runs.items()}


def _round6(tree):
    """``tree`` with every float at 6 significant digits."""
    if isinstance(tree, dict):
        return {k: _round6(v) for k, v in tree.items()}
    return float(f"{tree:.6g}") if isinstance(tree, float) else tree


def _print_ptxas(name: str, log: str) -> None:
    """One line per kernel instance of nvcc's ptxas report: registers,
    shared memory, spills; and ptxas's performance warnings."""
    entry, spill = "?", ""
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            try:  # the readable name, where binutils is installed
                entry = subprocess.run(["c++filt", entry],
                                       capture_output=True, text=True,
                                       timeout=10).stdout.strip() or entry
            except (OSError, subprocess.SubprocessError):
                pass
            entry = entry.replace("(anonymous namespace)::", "")
        elif "spill" in line:
            spill = line
        elif "Used" in line and "registers" in line:
            print(f"  ptxas {name}: {entry}: {line.split(': ', 1)[-1]}; "
                  f"{spill}", flush=True)
        elif "Performance Loss" in line:
            print(f"  ptxas {name}: {line.split(' in the function')[0]}",
                  flush=True)


# flash_ab's shapes: the flash path's and the wide timing shapes
AB_SHAPES = (FLASH_SHAPE, *WIDE_TIMING_SHAPES)


def flash_ab_run(tree: str) -> None:
    """One side of flash_ab: the flash kernels of the checkout ``tree``,
    built there, checked against their plain version and timed at
    AB_SHAPES in bf16 and f32; one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from tpu_ac_torch.kernels import attention as attn
    from tpu_ac_torch.kernels import build

    if not attn.__file__.startswith(os.path.abspath(tree)):
        _fatal(f"imported {attn.__file__}, not the checkout at {tree}")
    build.build_all()
    for name, log in build.BUILD_LOG.items():
        _print_ptxas(name, log)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    row = {"tree": os.path.abspath(tree)}
    for shape in AB_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _packed_qkv(torch, gen, *shape, dtype)
            _flash_check(torch, attn, q, k, v, None, f"{list(shape)}")
            ms, _, launches = _time_launches(
                lambda: attn.flash_attention_impl(q, k, v,
                                                  shape[-1] ** -0.5),
                lambda: attn.LAUNCHES)
            name = f"{str(dtype).split('.')[-1]}_{'x'.join(map(str, shape))}"
            row[name] = {"ms": round(ms, 6), "launches_a_call": launches}
    print(json.dumps(row), flush=True)


def flash_ab(parent: str) -> None:
    """The flash kernels of this checkout against those of ``parent``
    (another checkout, e.g. ``git archive`` of the parent commit unpacked
    outside the repository) on one card, each side in a process of its
    own, in the order parent, this, this, parent."""
    print(_card_line(), flush=True)
    here = HERE
    for tree in (parent, here, here, parent):
        rc = subprocess.run([sys.executable, os.path.join(HERE,
                                                          "chip_smoke.py"),
                             "--flash_ab_run", tree], timeout=900).returncode
        if rc:
            _fatal(f"flash_ab: the run of {tree} failed ({rc})")


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scaling", type=int, metavar="N",
                    help="instead of the phases: DINO and SCAN's SimCLR on "
                         "1 card and on N (see phase_scaling)")
    ap.add_argument("--flash_ab", metavar="DIR",
                    help="instead of the phases: the flash kernels of this "
                         "checkout against those of another (see flash_ab)")
    ap.add_argument("--flash_ab_run", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.flash_ab_run:
        flash_ab_run(args.flash_ab_run)
        return
    if args.flash_ab:
        flash_ab(args.flash_ab)
        return
    if not os.path.isfile(os.path.join(HERE, "tpu_ac_torch",
                                       "kernels", "distances.py")):
        _fatal("tpu_ac_torch/ not found next to chip_smoke.py: run it "
               "from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        _fatal("torch.cuda.is_available() is false: no card, no result")
    t_start = time.perf_counter()
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    if args.scaling:
        scaling = phase_scaling(torch, args.scaling)
        _check_no_children()
        print(card)
        print(json.dumps({"scaling": {"cards": args.scaling, **scaling}}))
        return

    from tpu_ac_torch.kernels import attention as attn
    from tpu_ac_torch.kernels import build
    from tpu_ac_torch.kernels import distances as dist

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    for name, log in build.BUILD_LOG.items():
        _print_ptxas(name, log)

    # the plain versions' f32 products: full f32, as the tolerances assume
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = phase_kernels(torch, dist)
    window_err = phase_window_kernel(torch, dist)
    stress = phase_stress(torch, dist)
    for mode in errs:
        errs[mode] = max(errs[mode], stress[mode])
    window_err = max(window_err, stress["window"])
    flash_err = phase_flash_kernel(torch, attn)
    sizes = {"bottle": 84, "screw": 168}
    work = os.path.join(HERE, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        root = _make_tree(work, sizes)
        launches, run = phase_main_path(torch, dist, attn, work, root, sizes)
        flash_run = phase_flash_path(torch, dist, attn, work, root, sizes)
        mesh_run = phase_mesh_path(torch, dist, attn, work, root, sizes)
        export_run = phase_export(torch, work, root, sizes)
        # no hand-written kernel lies on this path: the counts stay 0
        dist.LAUNCHES = dist.WINDOW_LAUNCHES = attn.LAUNCHES = 0
        pc_run = phase_patchcore(torch, work)
        pc_launches = dist.LAUNCHES + dist.WINDOW_LAUNCHES + attn.LAUNCHES
        if pc_launches:
            _fatal(f"the patchcore path launched {pc_launches} kernels of "
                   "the clustering path")
        t0 = time.perf_counter()
        zoo_run = phase_zoo(torch, dist, attn, work, root)
        zoo_s = time.perf_counter() - t0
        dist.LAUNCHES = dist.WINDOW_LAUNCHES = attn.LAUNCHES = 0
        dino_run = phase_dino(torch, work)
        dino_launches = dist.LAUNCHES + dist.WINDOW_LAUNCHES + attn.LAUNCHES
        if dino_launches:
            _fatal(f"the dino path launched {dino_launches} kernels of the "
                   "clustering path")
        dist.LAUNCHES = dist.WINDOW_LAUNCHES = attn.LAUNCHES = 0
        scan_run = phase_scan(torch, work)
        scan_launches = dist.LAUNCHES + dist.WINDOW_LAUNCHES + attn.LAUNCHES
        if scan_launches:
            _fatal(f"the scan path launched {scan_launches} kernels of the "
                   "clustering path")
        dist.LAUNCHES = dist.WINDOW_LAUNCHES = attn.LAUNCHES = 0
        evals_run = phase_evals(torch, work)
        evals_launches = (dist.LAUNCHES + dist.WINDOW_LAUNCHES
                          + attn.LAUNCHES)
        if evals_launches:
            _fatal(f"the eval path launched {evals_launches} kernels of the "
                   "clustering path")
        dist.LAUNCHES = dist.WINDOW_LAUNCHES = attn.LAUNCHES = 0
        viz_run = phase_viz(torch, root, work)
        viz_launches = dist.LAUNCHES + dist.WINDOW_LAUNCHES + attn.LAUNCHES
        if viz_launches:
            _fatal(f"the viz path launched {viz_launches} kernels of the "
                   "clustering path")
        dist.LAUNCHES = dist.WINDOW_LAUNCHES = attn.LAUNCHES = 0
        dist_run = phase_dist(torch, os.path.join(work, "dist"))
        if dist.LAUNCHES + dist.WINDOW_LAUNCHES + attn.LAUNCHES:
            _fatal("the dist phase launched kernels of the clustering path "
                   "in this process")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the supervised run pads its 84 queries to the 32-image bucket (96)
    timing = phase_timing(torch, dist, n_sym=max(sizes.values()),
                          n_rect=(96, min(sizes.values())))
    window_timing = phase_window_timing(torch, dist, n=max(sizes.values()),
                                        dp=2)
    flash_timing = phase_flash_timing(torch, attn)

    print(f"main path on {kind} ({card}): embed "
          f"{run['embed_ms_per_image']:.3f} ms/image wall (ViT-B/8 + tail, "
          f"bf16, batch 8, flash under auto), alpha " + ", ".join(
              f"{c} (N={sizes[c]}) {ms:.1f} ms"
              for c, ms in run["alpha_ms"].items())
          + ", host decode " + ", ".join(
              f"{c} {ms:.1f} ms" for c, ms in run["decode_ms"].items())
          + f", sweep {run['sweep_img_s']:.1f} img/s over "
          f"{sum(sizes.values())} images (sweeps {run['sweep_s']} s), CLI "
          f"stage 1 {run['cli_s']:.1f} s incl. set-up, peak "
          f"{run['peak_gib']:.1f} GiB", flush=True)
    def entry(name, source, replaces, launches, err, t) -> dict:
        keys = ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "gemm_ms")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(err, t["max_abs_err"]),
                **{k: t[k] for k in keys if k in t}}

    kernels = [entry(f"min_dists_{mode}", SOURCE, REPLACES, launches[mode],
                     errs[mode], timing[mode])
               for mode in ("symmetric", "rectangular")]
    kernels.append(entry("min_dists_window", SOURCE, WINDOW_REPLACES,
                         mesh_run["launches"], window_err, window_timing))
    kernels.append(entry("flash_attention", FLASH_SOURCE, FLASH_REPLACES,
                         flash_run["launches"], flash_err, flash_timing))
    # head dims over 64: the wide kernels, bf16 on the ViT-H/14 path, timed
    # at its [8, 16, 785, 80]; the f32 one beside it (f32_*)
    wide = flash_timing["wide"]["x".join(map(str, WIDE_TIMING_SHAPES[0]))]
    wide_err = max(r[d]["max_abs_err"] for r in FLASH_WIDE.values()
                   for d in r)
    kernels.append(entry("flash_attention_wide", FLASH_SOURCE,
                         FLASH_REPLACES, flash_run["vith"]["launches"],
                         wide_err, wide["bfloat16"]))
    kernels[-1].update({f"f32_{k}": wide["float32"][k] for k in (
        "ms", "host_ms", "plain_ms", "bound_ms", "library_ms")})
    kernels[-1]["head_dim_checks"] = {
        str(dh): {d: _round6(r) for d, r in rows.items()}
        for dh, rows in FLASH_WIDE.items()}
    kernels[-1]["head_dim_timing"] = _round6(flash_timing["wide"])
    t = flash_timing
    print(f"mesh path: alpha " + ", ".join(
        f"{c} {ms:.1f} ms" for c, ms in mesh_run["alpha_ms"].items())
        + f" a category, window kernel {window_timing['ms']:.2f} ms a rank, "
        f"busy {mesh_run['busy_pct']:.1f}%; chip_smoke.py took "
        f"{time.perf_counter() - t_start:.0f} s", flush=True)
    # the end-to-end numbers of this run on one short line, so that they
    # stay in the last lines of the output beside the kernels line
    def r4(x: float) -> float:
        return round(x, 4)

    print(json.dumps({"summary": {
        "build_s": r4(build_s),
        "min_dists_symmetric_ms": r4(timing["symmetric"]["ms"]),
        "flash_ms": r4(t["ms"]),
        "flash_host_ms": r4(t["host_ms"]),
        "flash_gap_over_tol": {d: r4(w) for d, w in FLASH_WORST.items()},
        "flash_f32_ms": r4(t["f32_ms"]),
        "flash_f32_host_ms": r4(t["f32_host_ms"]),
        "flash_f32_bound_ms": r4(t["f32_bound_ms"]),
        "flash_f32_plain_ms": r4(t["f32_plain_ms"]),
        "flash_f32_library_ms": r4(t["f32_library_ms"]),
        "dense_attention_ms": r4(t["dense_ms"]),
        # the main path's wall time; the flash path's device busy, summed
        # operation and wall times of the same weights' embeds
        "embed_ms_per_image": {"auto_wall": r4(run["embed_ms_per_image"])},
        "embed_device_busy_ms_per_image": {
            k: r4(v) for k, v in flash_run["embed_ms"].items()},
        "embed_summed_op_ms_per_image": {
            k: r4(v) for k, v in flash_run["embed_summed_ms"].items()},
        "embed_wall_ms_per_image": {
            k: r4(v) for k, v in flash_run["embed_wall_ms"].items()},
        "vith14_flash": {
            "embed_device_busy_ms_per_image": {
                k: r4(v) for k, v in flash_run["vith"]["embed_ms"].items()},
            "embed_wall_ms_per_image": {
                k: r4(v) for k, v in
                flash_run["vith"]["embed_wall_ms"].items()},
            "kernel_ms": r4(flash_run["vith"]["kernel_ms"]),
            "kernel_share": r4(flash_run["vith"]["kernel_share"]),
            "rel_l2_flash_dense_f32": [
                float(f"{g:.4g}") for g in flash_run["vith"]["rel_gaps"]],
            "phase_s": r4(flash_run["vith"]["phase_s"])},
        "bottle_f32_flash": {
            "launches": flash_run["f32_launches"],
            "rel_l2_to_dense_f32": float(f"{flash_run['f32_gap']:.4g}")},
        "sweep_img_s": {"auto": r4(run["sweep_img_s"]),
                        "flash": r4(flash_run["sweep_img_s"])},
        "busy_pct": {"auto": r4(run["busy_pct"]),
                     "flash": r4(flash_run["busy_pct"])},
        "decode_ms": {c: r4(ms) for c, ms in run["decode_ms"].items()},
        "alpha_ms": {c: r4(ms) for c, ms in run["alpha_ms"].items()},
        "bottle_rel_l2_flash_dense_f32": [
            float(f"{g:.4g}") for g in flash_run["rel_gaps"]],
        "alpha_gap_flash_dense": float(f"{flash_run['alpha_gap']:.4g}"),
        "convert_s": r4(flash_run["convert_s"]),
        "peak_gib": r4(run["peak_gib"]),
        "patchcore": {
            "fit_img_s": r4(pc_run["fit_img_s"]),
            "predict_img_s": r4(pc_run["predict_img_s"]),
            "coreset_s": {str(sb): r4(v)
                          for sb, v in pc_run["coreset_s"].items()},
            "knn_ms": r4(pc_run["knn_ms"]),
            "busy_pct": r4(pc_run["busy_pct"]),
            "instance_auroc": r4(pc_run["metrics"]["instance_auroc"])},
        "zoo": {"phase_s": r4(zoo_s),
                "cli_s": {k: r4(v) for k, v in zoo_run["cli_s"].items()},
                **{name: {"embed_ms": r4(r["embed_ms"]),
                          "sweep_img_s": r4(r["sweep_img_s"]),
                          "gap": float(f"{r['gap']:.4g}"),
                          "launches": r["launches"],
                          "peak_gib": r4(r["peak_gib"]),
                          **({} if r["flash_gaps"] is None else {
                              "rel_l2_flash_dense_f32": [
                                  float(f"{g:.4g}")
                                  for g in r["flash_gaps"]]})}
                   for name, r in zoo_run["rows"].items()}},
        "dino": {k: (float(f"{v:.6g}") if isinstance(v, float) else v)
                 for k, v in dino_run.items()},
        "scan": _round6(scan_run),
        "evals": _round6(evals_run),
        "export": _round6(export_run["runs"]),
        "viz": _round6(viz_run),
        "dist": _round6(dist_run),
        "mesh": {"sweep_img_s": r4(mesh_run["sweep_img_s"]),
                 "window_ms": r4(window_timing["ms"]),
                 "w_gap_over_bound": float(
                     f"{mesh_run['w_gap_over_bound']:.4g}")}}}))
    _check_no_children()
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    finally:
        _stop_children()
