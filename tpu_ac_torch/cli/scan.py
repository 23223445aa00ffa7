"""SCAN pipeline CLI (port of ``tpu_ac.cli.scan``; simclr.py / moco.py /
scan.py / selflabel.py / eval.py of Unsupervised-Classification-master):

    python -m tpu_ac_torch.cli.scan {simclr,moco,scan,selflabel,eval} \\
        --config_env ENV --config_exp EXP [--device cpu]

One entry with a stage subcommand, driven by SCAN's two-file YAML config
(env + experiment, ``tpu_ac_torch.config.create_config``; the port's copy
of the experiment files is ``tpu_ac_torch/configs/``).  The config keys,
the stage artifacts and their paths are ``tpu_ac``'s: pretext -> top-k
neighbours ``.npy`` -> scan model -> selflabel model, the checkpoints in
``utils/checkpoint.py``'s npz format, the cross-stage "model" checkpoints
holding only params and BN statistics.  So a stage of either package
feeds the next stage of the other.

``--device`` defaults to ``cuda`` (which raises without a card).  Every
stage runs in f32 under ``device.precision_scope("default")``: cuBLAS and
cuDNN may use TF32, the card's analogue of the TPU's single-pass f32 at
which ``tpu_ac``'s steps run; the neighbour mining's products stay full
f32 (``ops/distances.py``).

Optional config keys, as in ``tpu_ac``:
- ``mine_dp: N``: the memory bank's mining row-sharded over an N-device
  mesh (``knn_ip_sharded``): N cards, or N x the CPU with ``--device cpu``.
- ``train_dp: N``: batches trimmed to a multiple of N, exactly as
  ``tpu_ac`` trims them; ``tpu_ac``'s sharded step equals the unsharded
  one (sync-BN).  On N cards the training stages (simclr, scan, selflabel)
  run one process a card, each on its share of every batch, the step over
  the global batch (``train.scan.dp_shard_step``): the CLI starts the N
  ranks itself (spawn, nccl) when no group exists, and joins torchrun's
  group, or a caller's, when one does.  Each rank has its own aug pool;
  rank 0 alone saves and, after the training, fills the bank, mines and
  evaluates.  On a mesh that repeats one device (``--device cpu``) the
  step runs on the whole batch in one process.

Each training epoch prints a ``scan_epoch {json}`` line (stage, steps,
the step's ms by CUDA events from the first dispatch to the last step's
end, images/s, the host's wait on the loader a step, peak GiB, device),
mining a ``scan_mining {json}`` line and each stage a closing
``scan_stage {json}`` line with its wall seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import time

import numpy as np
import torch

from tpu_ac_torch.cluster.metrics import clustering_scores, hungarian_evaluate
from tpu_ac_torch.config import create_config
from tpu_ac_torch.data.augment import (
    SimCLRAugmentation,
    StrongAugmentation,
    ValTransform,
    WeakAugmentation,
    to_normalized_array,
)
from tpu_ac_torch.data.classification import (
    ArrayDataset,
    load_cifar10,
    load_cifar20,
    load_imagenet,
    load_stl10,
    make_synthetic_classification,
    shuffled_batches,
)
from tpu_ac_torch.data.prefetch import ParallelAugPool, to_device
from tpu_ac_torch.device import precision_scope, resolve_device
from tpu_ac_torch.distributed import (
    Mesh,
    get_mesh,
    multihost_init,
    process_count,
    process_index,
)
from tpu_ac_torch.distributed.collectives import check_same_on_ranks
from tpu_ac_torch.models.resnet_cifar import (
    RESNET18_CIFAR,
    RESNET18_STL,
    RESNET50_IMAGENET,
    init_cifar_resnet,
)
from tpu_ac_torch.train.optim import adam, add_decayed_weights, chain, sgd
from tpu_ac_torch.train.scan import (
    MemoryBank,
    SCANModelConfig,
    clustering_forward,
    contrastive_forward,
    dp_shard_step,
    init_clustering_model,
    init_contrastive_model,
    init_train_state,
    make_scan_step,
    make_selflabel_step,
    make_simclr_step,
    scan_evaluate_heads,
)
from tpu_ac_torch.utils import (
    LaggedFetch,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)

STAGE_PRECISION = "default"


def _load_dataset(cfg, split: str) -> ArrayDataset:
    name = cfg.get("train_db_name", "synthetic")
    root = cfg.get("data_root", "./data")
    if name == "cifar-10":
        return load_cifar10(root, split)
    if name == "cifar-20":
        return load_cifar20(root, split)
    if name == "stl-10":
        return load_stl10(root, "train" if split == "train" else "test")
    if name.startswith("imagenet"):
        # imagenet_50/100/200 (data/imagenet.py ImageNetSubset) need a
        # subset wnid list; full "imagenet" walks every class dir
        subset = cfg.get("subset_file")
        if subset is None and "_" in name:
            subset = f"{root}/imagenet_subsets/{name}.txt"
        return load_imagenet(root, "train" if split == "train" else "val",
                             subset_file=subset,
                             size=cfg.get("image_size", 224),
                             # at _100/_200 scale the decoded split is tens
                             # of GB: cache to disk + memory-map
                             mmap_cache=cfg.get("mmap_cache"))
    return make_synthetic_classification(
        n_per_class=cfg.get("synthetic_per_class", 16),
        n_classes=cfg.get("num_classes", 4),
        size=cfg.get("image_size", 32),
        seed=0)


def _model_config(cfg) -> SCANModelConfig:
    name = cfg.get("backbone", "")
    db = cfg.get("train_db_name", "")
    if name == "resnet50" or (not name and db.startswith("imagenet")):
        backbone = RESNET50_IMAGENET
    elif db == "stl-10":
        backbone = RESNET18_STL
    else:
        backbone = RESNET18_CIFAR
    return SCANModelConfig(
        backbone=backbone,
        feature_dim=cfg.get("feature_dim", 128),
        n_clusters=cfg.get("num_classes", 10),
        n_heads=cfg.get("num_heads", 1))


def _mesh(dp: int, dev: torch.device) -> Mesh:
    """An N-device mesh for ``mine_dp``/``train_dp``: N x the CPU under
    ``--device cpu`` (a virtual mesh), else the first N cards (raises
    when there are fewer)."""
    return Mesh([dev] * dp) if dev.type == "cpu" else get_mesh(dp)


def _mining_mesh(cfg, dev: torch.device) -> Mesh | None:
    """``mine_dp: N``: the neighbour mining row-sharded over N devices
    (``knn_ip_sharded``), the reference's faiss.index_cpu_to_all_gpus
    sharded IndexFlatIP (utils/memory.py:52)."""
    dp = cfg.get("mine_dp")
    return _mesh(int(dp), dev) if dp else None


def _train_dp(cfg) -> int:
    """The ``train_dp`` mesh size as a batch-trim multiple (1 = off)."""
    return int(cfg.get("train_dp") or 1)


def _train_step(cfg, step_fn, n_batch_args: int, dev: torch.device):
    """A stage's train step, data-parallel under ``train_dp: N``
    (``train.scan.dp_shard_step``): the reference's torch.nn.DataParallel
    around the SCAN-stage models (scan.py:48, selflabel.py:45,
    simclr.py:44).  In a group of N processes each rank runs it on its
    own device."""
    dp = _train_dp(cfg)
    w = process_count()
    if w > 1 and dp != w:
        raise ValueError(f"train_dp: {dp} in a group of {w} processes: "
                         "they must be equal")
    if dp == 1:
        return step_fn
    mesh = Mesh([dev] * w) if w > 1 else _mesh(dp, dev)
    return dp_shard_step(step_fn, mesh, n_batch_args)


def _rank_share(idxs: np.ndarray, pos: int) -> tuple[np.ndarray, int]:
    """This rank's share of a global batch (trimmed to a multiple of the
    ranks): its indices and the position of the first, which keys its
    augmentation, so the ranks' crops are the one-process run's."""
    w = process_count()
    if w == 1:
        return idxs, pos
    m = len(idxs) // w
    r = process_index()
    return idxs[r * m:(r + 1) * m], pos + r * m


def _print_json(tag: str, row: dict) -> None:
    print(f"{tag} " + json.dumps(row), flush=True)


def _run_epoch(stage: str, epoch: int, batches, run_step,
               dev: torch.device) -> None:
    """``run_step(*batch)`` over the loader's batches; prints the
    ``scan_epoch`` line.  The step time runs by CUDA events from the first
    dispatch to the last step's end (the host's clock on the CPU), so it
    includes the card's waits on the loader; the loader wait is the host's
    time in the loader after the first batch."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
    steps = images = 0
    wait_s = 0.0
    wall0 = None
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        if wall0 is None:
            if process_count() > 1:
                # every rank's clock from one start: rank 0 may still be
                # writing the last checkpoint
                torch.distributed.barrier()
            wall0 = time.perf_counter()
            if cuda:
                start.record()
        else:
            wait_s += time.perf_counter() - t0
        run_step(*batch)
        steps += 1
        images += len(batch[0]) * process_count()  # every rank's share
    if wall0 is None:
        return
    if cuda:
        stop.record()
        stop.synchronize()
    wall_ms = (time.perf_counter() - wall0) * 1e3
    step_ms = (start.elapsed_time(stop) if cuda else wall_ms) / steps
    _print_json("scan_epoch", {
        "stage": stage, "epoch": epoch, "steps": steps,
        "images_per_step": images / steps, "step_ms": step_ms,
        "wall_step_ms": wall_ms / steps,
        "images_s": images / steps / (step_ms / 1e3),
        "data_wait_ms": wait_s * 1e3 / max(steps - 1, 1),
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                     if cuda else None),
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu"})


def _mine(bank: MemoryBank, topk: int, stage: str):
    t0 = time.perf_counter()
    idx, acc = bank.mine_nearest_neighbors(topk)
    _print_json("scan_mining", {
        "stage": stage, "rows": len(bank.features),
        "dim": bank.features.shape[1], "topk": topk,
        "ms": (time.perf_counter() - t0) * 1e3, "accuracy": acc})
    return idx, acc


def _stage_done(stage: str, t0: float, **results) -> None:
    _print_json("scan_stage", {"stage": stage,
                               "seconds": time.perf_counter() - t0,
                               **results})


def _fill_bank(bank: MemoryBank, embed, ds: ArrayDataset, transform,
               pool: ParallelAugPool, bs: int, put) -> None:
    """The bank's row r holds image r: a SEQUENTIAL fill (utils.
    fill_memory_bank), since run_scan reads the mined indices as dataset
    indices; one batch of lookahead."""
    def thunks():
        for i in range(0, len(ds), bs):
            idxs = np.arange(i, min(i + bs, len(ds)))
            yield (lambda idxs=idxs: (
                idxs, put(pool.stack(transform, ds.get_pil, idxs,
                                     keyed=False))))
    with torch.no_grad():
        for idxs, imgs in pool.lookahead(thunks()):
            bank.update(embed(imgs), ds.labels[idxs])


def run_simclr(cfg, device: str | torch.device = "cuda") -> None:
    """Pretext stage (simclr.py:30-149): train, fill the memory bank, mine
    and save the top-k neighbours."""
    t_stage = time.perf_counter()
    dev = resolve_device(device)
    ds = _load_dataset(cfg, "train")
    size = cfg.get("image_size", 32)
    mcfg = _model_config(cfg)
    # two independent views per image: one transform, two rng streams
    # ("i"/"j" keys below; the reference gets independence from two
    # dataloader passes through the same augmentation)
    aug = SimCLRAugmentation(size=size, seed=0)
    pool = ParallelAugPool(cfg.get("num_workers", 8), seed=cfg.get("seed", 0))
    put = to_device(dev)

    params, bn = init_contrastive_model(cfg.get("seed", 0), mcfg, dev)
    opt = chain(add_decayed_weights(cfg.get("weight_decay", 1e-4)),
                sgd(cfg.get("lr", 0.4), momentum=0.9))
    state = init_train_state(params, bn, opt)
    ckpt = latest_checkpoint(cfg.pretext_dir, "checkpoint")
    start_epoch = 0
    if ckpt:
        state, meta = restore_checkpoint(ckpt, state)
        start_epoch = meta["extra"]["epoch"] + 1
    check_same_on_ranks(state.params, "the initial SimCLR params")

    step = _train_step(cfg, make_simclr_step(
        mcfg, opt, cfg.get("temperature", 0.1)), 2, dev)
    bs = cfg.get("batch_size", 128)
    try:
        with precision_scope(STAGE_PRECISION):
            for epoch in range(start_epoch, cfg.get("epochs", 10)):
                losses = []

                def thunks(epoch=epoch):
                    pos = 0
                    for idxs in shuffled_batches(len(ds), bs, epoch,
                                               multiple_of=_train_dp(cfg)):
                        mine, start = _rank_share(idxs, pos)
                        yield (lambda idxs=mine, pos=start: (
                            put(pool.stack(aug, ds.get_pil, idxs,
                                           epoch=epoch, start=pos,
                                           stream="i")),
                            put(pool.stack(aug, ds.get_pil, idxs,
                                           epoch=epoch, start=pos,
                                           stream="j"))))
                        pos += len(idxs)

                fetch = LaggedFetch(
                    lambda host, acc=losses: acc.append(float(host["loss"])))

                def run(xi, xj, fetch=fetch):
                    nonlocal state
                    state, loss = step(state, xi, xj)
                    fetch.push({"loss": loss})

                _run_epoch("simclr", epoch, pool.lookahead(thunks()), run,
                           dev)
                fetch.flush()
                print(f"simclr epoch {epoch}: loss {np.mean(losses):.4f}",
                      flush=True)
                if process_index() == 0:
                    save_checkpoint(cfg.pretext_dir, "checkpoint", state,
                                    step=epoch, extra={"epoch": epoch},
                                    keep=1)
            if process_index() > 0:
                return  # rank 0 fills the bank and mines

            # the memory bank from the DETERMINISTIC val transform
            # (simclr.py:64,133: center crop, no random crop/flip), then
            # mining
            bank = MemoryBank(len(ds), mcfg.feature_dim,
                              num_classes=cfg.get("num_classes", 10),
                              mesh=_mining_mesh(cfg, dev), device=dev)
            _fill_bank(bank, lambda x: contrastive_forward(
                state.params, state.bn_state, x, mcfg)[0], ds,
                ValTransform(size=size), pool, bs, put)
    finally:
        pool.close()
    topk = cfg.get("num_neighbors", 20)
    idx, acc = _mine(bank, topk, "simclr")
    print(f"neighbor mining accuracy (top-{topk}): {acc:.4f}", flush=True)
    np.save(cfg.topk_neighbors_train_path, idx)
    # cross-stage "model" checkpoints carry params+bn ONLY: the consumer
    # must not need to know which pretext stage (and so which optimizer
    # state) produced them
    save_checkpoint(cfg.pretext_dir, "model",
                    {"params": state.params, "bn": state.bn_state}, step=0)
    _stage_done("simclr", t_stage, neighbor_accuracy=acc)


def run_moco(cfg, device: str | torch.device = "cuda") -> None:
    """MoCo weight-transfer stage (moco.py:64-110): load an official
    MoCo-v2 checkpoint, remap ``module.encoder_q.*`` onto backbone and
    contrastive_head names, save the pretext model, then mine top-k
    neighbours on L2-normalized BACKBONE features, before the MLP head
    (moco.py:95: contrastive_head = Identity for mining)."""
    from tpu_ac_torch.models.convert import moco_to_contrastive_params

    t_stage = time.perf_counter()
    dev = resolve_device(device)
    mcfg = _model_config(cfg)
    params, bn = init_contrastive_model(cfg.get("seed", 0), mcfg, dev)

    ckpt_path = cfg.get("moco_checkpoint")
    if ckpt_path and os.path.exists(ckpt_path):
        raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        remapped = moco_to_contrastive_params(raw.get("state_dict", raw))
        loaded_p, loaded_bn = {}, {}
        for k, v in remapped.items():
            if k.endswith("num_batches_tracked"):
                continue
            dst = (loaded_bn if k.endswith((".running_mean", ".running_var"))
                   else loaded_p)
            dst[k] = torch.from_numpy(np.array(v, np.float32)).to(dev)
        params = {**params, **{k: v for k, v in loaded_p.items()
                               if k in params}}
        bn = {**bn, **{k: v for k, v in loaded_bn.items() if k in bn}}
        print(f"Transferred MoCo weights from {ckpt_path} "
              f"({len(loaded_p)} tensors)", flush=True)
    else:
        print("No moco_checkpoint configured: using random init (place "
              "moco_v2_800ep_pretrain.pth.tar locally and set "
              "moco_checkpoint:; the reference downloads it, "
              "moco.py:64-66)", flush=True)

    save_checkpoint(cfg.pretext_dir, "model",
                    {"params": params, "bn": bn}, step=0)

    def backbone_feats(imgs):
        _, feats, _ = contrastive_forward(params, bn, imgs, mcfg)
        return feats / torch.linalg.vector_norm(feats, dim=1, keepdim=True)

    bs = cfg.get("batch_size", 64)
    pool = ParallelAugPool(cfg.get("num_workers", 8))
    accs = {}
    try:
        with precision_scope(STAGE_PRECISION):
            for split, topk, path in (
                    ("train", cfg.get("num_neighbors", 50),
                     cfg.topk_neighbors_train_path),
                    ("val", cfg.get("num_neighbors_val", 5),
                     cfg.topk_neighbors_val_path)):
                ds = _load_dataset(cfg, split)
                bank = MemoryBank(len(ds), mcfg.backbone.feature_dim,
                                  num_classes=cfg.get("num_classes", 10),
                                  mesh=_mining_mesh(cfg, dev), device=dev)
                _fill_bank(bank, backbone_feats, ds, to_normalized_array,
                           pool, bs, to_device(dev))
                idx, acc = _mine(bank, topk, f"moco_{split}")
                np.save(path, idx)
                accs[split] = acc
                print(f"moco {split}: top-{topk} neighbors, accuracy "
                      f"{acc:.4f} -> {path}", flush=True)
    finally:
        pool.close()
    _stage_done("moco", t_stage, neighbor_accuracy=accs)


def run_scan(cfg, device: str | torch.device = "cuda") -> None:
    """Clustering stage (scan.py:23-137)."""
    t_stage = time.perf_counter()
    dev = resolve_device(device)
    ds = _load_dataset(cfg, "train")
    size = cfg.get("image_size", 32)
    mcfg = _model_config(cfg)
    neighbors = np.load(cfg.topk_neighbors_train_path)
    transform = SimCLRAugmentation(size=size, seed=0)

    params, bn = init_clustering_model(cfg.get("seed", 0), mcfg, dev)
    # transfer pretext backbone weights (common_config.py:87-94)
    pre_ckpt = latest_checkpoint(cfg.pretext_dir, "model")
    if pre_ckpt:
        # optimizer-free template: works whether simclr or moco wrote it
        pre_params, pre_bn = init_contrastive_model(cfg.get("seed", 0), mcfg,
                                                    dev)
        pre, _ = restore_checkpoint(pre_ckpt,
                                    {"params": pre_params, "bn": pre_bn})
        for k, v in pre["params"].items():
            if not k.startswith("contrastive_head") and k in params:
                params[k] = v
        bn = dict(pre["bn"])

    opt = adam(cfg.get("scan_lr", 1e-4))
    state = init_train_state(params, bn, opt)
    check_same_on_ranks(state.params, "the initial SCAN params")
    step = _train_step(cfg, make_scan_step(
        mcfg, opt, cfg.get("entropy_weight", 2.0),
        update_cluster_head_only=cfg.get("update_cluster_head_only", False)),
        2, dev)

    bs = cfg.get("batch_size", 128)
    rng = np.random.default_rng(0)
    pool = ParallelAugPool(cfg.get("num_workers", 8), seed=cfg.get("seed", 0))
    put = to_device(dev)
    head_losses = None
    try:
        with precision_scope(STAGE_PRECISION):
            for epoch in range(cfg.get("epochs", 10)):
                totals = []
                # per-head losses ACCUMULATE over the epoch
                # (evaluate_utils.py scan_evaluate sums over the dataset):
                # a single final batch could rank the wrong head
                head_losses = None

                def thunks(epoch=epoch):
                    # neighbour draws stay on the (ordered) head thread,
                    # so the rng sequence is the serial loop's
                    pos = 0
                    for idxs in shuffled_batches(len(ds), bs, epoch,
                                               multiple_of=_train_dp(cfg)):
                        def t(idxs=idxs, pos=pos):
                            # drawn for the global batch on every rank
                            nbr = neighbors[idxs, :][
                                np.arange(len(idxs)),
                                rng.integers(0, neighbors.shape[1],
                                             len(idxs))]
                            mine, pos = _rank_share(idxs, pos)
                            nbr = _rank_share(nbr, 0)[0]
                            idxs = mine
                            a = pool.stack(transform, ds.get_pil, idxs,
                                           epoch=epoch, start=pos,
                                           stream="a")
                            n = pool.stack(transform, ds.get_pil, nbr,
                                           epoch=epoch, start=pos,
                                           stream="n")
                            return put(a), put(n)
                        yield t
                        pos += len(idxs)

                def consume(host, totals=totals):
                    nonlocal head_losses
                    totals.append(float(host["total"]))
                    batch_head = host["head_losses"].numpy()
                    head_losses = (batch_head if head_losses is None
                                   else head_losses + batch_head)

                fetch = LaggedFetch(consume)

                def run(anchors, nbrs, fetch=fetch):
                    nonlocal state
                    state, metrics = step(state, anchors, nbrs)
                    fetch.push(metrics)

                _run_epoch("scan", epoch, pool.lookahead(thunks()), run, dev)
                fetch.flush()
                print(f"scan epoch {epoch}: loss {np.mean(totals):.4f}",
                      flush=True)
            if process_index() > 0:
                return  # rank 0 saves and evaluates
            best = scan_evaluate_heads(head_losses)
            save_checkpoint(cfg.scan_dir, "model",
                            {"params": state.params, "bn": state.bn_state},
                            step=0, extra={"best_head": best})
            # hungarian eval on the train labels with Top-5
            # (scan.py:118-120, evaluate_utils.py:122-159)
            probs = _predict_probs(state.params, state.bn_state, ds, mcfg,
                                   size, pool, put)
    finally:
        pool.close()
    ev = hungarian_evaluate(probs[best], ds.labels)
    print(f"scan best head {best}: hungarian ACC {ev['ACC']:.4f} "
          f"Top-5 {ev['ACC Top-5']:.4f} NMI {ev['NMI']:.4f} "
          f"ARI {ev['ARI']:.4f}", flush=True)
    _stage_done("scan", t_stage, best_head=best,
                **{k: ev[k] for k in ("ACC", "ACC Top-5", "NMI", "ARI")})


def _predict_probs(params, bn_state, ds, mcfg, size,
                   pool: ParallelAugPool, put, batch_size: int = 256
                   ) -> np.ndarray:
    """[heads, N, C] softmax class probabilities under the DETERMINISTIC
    val transform (get_predictions runs on dataloaders built with
    get_val_transformations, evaluate_utils.py:34-84 + scan.py:66-71)."""
    val_t = ValTransform(size=size)

    def thunks():
        for i in range(0, len(ds), batch_size):
            yield (lambda i=i: put(pool.stack(
                val_t, ds.get_pil, range(i, min(i + batch_size, len(ds))),
                keyed=False)))

    all_probs = []
    with torch.no_grad():
        for imgs in pool.lookahead(thunks()):
            logits, _, _ = clustering_forward(params, bn_state, imgs, mcfg)
            all_probs.append(torch.softmax(logits, dim=-1).cpu().numpy())
    return np.concatenate(all_probs, axis=1)  # [heads, N, C]


def _single_head(cfg) -> SCANModelConfig:
    scan_cfg = _model_config(cfg)
    return SCANModelConfig(backbone=scan_cfg.backbone,
                           feature_dim=scan_cfg.feature_dim,
                           n_clusters=scan_cfg.n_clusters, n_heads=1)


def _checkpoint_heads(path: str, one_head: SCANModelConfig) -> int:
    """The number of cluster heads a SCAN model checkpoint holds, from its
    leaf count (2 a head beyond a one-head model's).  The selflabel
    configs do not repeat the scan config's ``num_heads`` (the reference
    reads every head of the SCAN checkpoint and keeps the best,
    common_config.py:95-106); ``tpu_ac`` builds its template from the
    selflabel config's ``num_heads`` and so cannot load a 10-head model
    under selflabel_cifar-10.yml (ROADMAP Queue 3)."""
    with open(os.path.join(path, "meta.json")) as f:
        n_leaves = json.load(f)["n_leaves"]
    p, bn = init_cifar_resnet(0, one_head.backbone)
    return 1 + (n_leaves - len(p) - len(bn) - 2) // 2


def run_selflabel(cfg, device: str | torch.device = "cuda") -> None:
    """Self-labeling stage (selflabel.py:28-110)."""
    t_stage = time.perf_counter()
    dev = resolve_device(device)
    ds = _load_dataset(cfg, "train")
    size = cfg.get("image_size", 32)
    mcfg = _single_head(cfg)

    # the best SCAN head only (common_config.py:95-106)
    scan_ckpt = latest_checkpoint(cfg.scan_dir, "model")
    if scan_ckpt is None:
        raise FileNotFoundError("no scan model; run the scan stage first")
    scan_cfg = dataclasses.replace(mcfg, n_heads=_checkpoint_heads(
        scan_ckpt, mcfg))
    params, bn = init_clustering_model(cfg.get("seed", 0), scan_cfg, dev)
    scan_pb, meta = restore_checkpoint(scan_ckpt,
                                       {"params": params, "bn": bn})
    best = meta["extra"].get("best_head", 0)
    sl_params = {k: v for k, v in scan_pb["params"].items()
                 if not k.startswith("cluster_head")}
    sl_params["cluster_head.0.weight"] = scan_pb["params"][
        f"cluster_head.{best}.weight"]
    sl_params["cluster_head.0.bias"] = scan_pb["params"][
        f"cluster_head.{best}.bias"]

    opt = sgd(cfg.get("selflabel_lr", 0.03), momentum=0.9)
    state = init_train_state(sl_params, scan_pb["bn"], opt)
    check_same_on_ranks(state.params, "the initial self-label params")
    step = _train_step(cfg, make_selflabel_step(
        mcfg, opt, threshold=cfg.get("confidence_threshold", 0.99),
        apply_class_balancing=cfg.get("apply_class_balancing", True)),
        2, dev)

    weak = WeakAugmentation(size=size, seed=0)
    strong = StrongAugmentation(size=size, seed=0)
    pool = ParallelAugPool(cfg.get("num_workers", 8), seed=cfg.get("seed", 0))
    bs = cfg.get("batch_size", 128)
    put = to_device(dev)
    try:
        with precision_scope(STAGE_PRECISION):
            for epoch in range(cfg.get("epochs", 5)):
                losses = []

                def thunks(epoch=epoch):
                    pos = 0
                    for idxs in shuffled_batches(len(ds), bs, epoch,
                                               multiple_of=_train_dp(cfg)):
                        mine, start = _rank_share(idxs, pos)
                        yield (lambda idxs=mine, pos=start: (
                            put(pool.stack(weak, ds.get_pil, idxs,
                                           epoch=epoch, start=pos,
                                           stream="w")),
                            put(pool.stack(strong, ds.get_pil, idxs,
                                           epoch=epoch, start=pos,
                                           stream="s"))))
                        pos += len(idxs)

                fetch = LaggedFetch(
                    lambda host, acc=losses: acc.append(float(host["loss"])))

                def run(w, s, fetch=fetch):
                    nonlocal state
                    state, loss = step(state, w, s)
                    fetch.push({"loss": loss})

                _run_epoch("selflabel", epoch, pool.lookahead(thunks()), run,
                           dev)
                fetch.flush()
                print(f"selflabel epoch {epoch}: loss {np.mean(losses):.4f}",
                      flush=True)
            if process_index() > 0:
                return  # rank 0 saves and evaluates
            save_checkpoint(cfg.selflabel_dir, "model",
                            {"params": state.params, "bn": state.bn_state},
                            step=0)
            probs = _predict_probs(state.params, state.bn_state, ds, mcfg,
                                   size, pool, put)
    finally:
        pool.close()
    ev = hungarian_evaluate(probs[0], ds.labels)
    print(f"selflabel hungarian ACC: {ev['ACC']:.4f} "
          f"Top-5 {ev['ACC Top-5']:.4f}", flush=True)
    _stage_done("selflabel", t_stage,
                **{k: ev[k] for k in ("ACC", "ACC Top-5", "NMI", "ARI")})


def run_eval(cfg, device: str | torch.device = "cuda") -> dict:
    """Final eval (eval.py:30-95): hungarian ACC + NMI/ARI on the val
    split."""
    t_stage = time.perf_counter()
    dev = resolve_device(device)
    ds = _load_dataset(cfg, "val")
    size = cfg.get("image_size", 32)
    mcfg = _single_head(cfg)
    params, bn = init_clustering_model(0, mcfg, dev)
    ckpt = latest_checkpoint(cfg.selflabel_dir, "model")
    if ckpt is None:
        raise FileNotFoundError("no selflabel model; run selflabel first")
    pb, _ = restore_checkpoint(ckpt, {"params": params, "bn": bn})
    pool = ParallelAugPool(cfg.get("num_workers", 8))
    try:
        with precision_scope(STAGE_PRECISION):
            probs = _predict_probs(pb["params"], pb["bn"], ds, mcfg, size,
                                   pool, to_device(dev))[0]
    finally:
        pool.close()
    scores = clustering_scores(ds.labels, probs.argmax(-1))
    ev = hungarian_evaluate(probs, ds.labels)
    scores["ACC"] = ev["ACC"]
    scores["ACC Top-5"] = ev["ACC Top-5"]
    print(f"eval: {scores}", flush=True)
    _stage_done("eval", t_stage, **scores)
    return scores


STAGES = {"simclr": run_simclr, "moco": run_moco, "scan": run_scan,
          "selflabel": run_selflabel, "eval": run_eval}
# the stages that train_dp trains across processes
TRAINED = ("simclr", "scan", "selflabel")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, stage: str, cfg, world: int, port: int) -> None:
    """One spawned rank: its card is cuda:rank, the group nccl."""
    os.environ["LOCAL_RANK"] = str(rank)
    multihost_init(f"127.0.0.1:{port}", world, rank)
    try:
        STAGES[stage](cfg, "cuda")
    finally:
        torch.distributed.destroy_process_group()


def run_stage(stage: str, cfg, device: str = "cuda"):
    """Run one stage: in torchrun's group or a caller's where there is one;
    else, for a training stage whose ``train_dp`` names N > 1 cards on
    ``cuda``, in N processes that this call starts (one a card, nccl) and
    joins before it returns; else in this process."""
    if process_count() == 1:
        multihost_init(backend="gloo" if device == "cpu" else None)
    dp = _train_dp(cfg)
    if (process_count() == 1 and dp > 1 and stage in TRAINED
            and resolve_device(device).type == "cuda"):
        import torch.multiprocessing as mp
        from multiprocessing import resource_tracker

        get_mesh(dp)  # raises unless there are N cards
        try:
            mp.start_processes(_rank_main, nprocs=dp, join=True,
                               start_method="spawn",
                               args=(stage, cfg, dp, _free_port()))
        finally:
            # the spawn context's semaphore tracker: no process outlives
            # the run
            resource_tracker._resource_tracker._stop()
        return None
    return STAGES[stage](cfg, device)


def main(argv=None):
    p = argparse.ArgumentParser("SCAN pipeline (PyTorch)")
    p.add_argument("stage", choices=list(STAGES))
    p.add_argument("--config_env", required=True)
    p.add_argument("--config_exp", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cuda without a card raises.")
    args = p.parse_args(argv)
    cfg = create_config(args.config_env, args.config_exp)
    return run_stage(args.stage, cfg, args.device)


if __name__ == "__main__":
    main()
