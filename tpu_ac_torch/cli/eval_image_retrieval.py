"""Image retrieval on revisited Oxford/Paris (port of
``tpu_ac.cli.eval_image_retrieval``; dino-main/eval_image_retrieval.py
rebuilt).

Protocol (eval_image_retrieval.py:33-201): load the gnd pickle, embed the
database ("train") and query splits with the backbone's CLS feature
(aspect-preserving thumbnail resize, optionally multiscale), L2-normalize,
rank by cosine similarity, and report Medium/Hard mAP and mP@k.  The
backbone runs under ``precision_scope("default")``; the ranking on the
host in float64.

    python -m tpu_ac_torch.cli.eval_image_retrieval --data_path DIR \
        --dataset roxford5k [--multiscale 1] [--device cpu]
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch

from tpu_ac_torch.data.mvtec import normalize_on_device
from tpu_ac_torch.data.oxford_paris import OxfordParisDataset
from tpu_ac_torch.data.prefetch import _lookahead, to_device
from tpu_ac_torch.device import precision_scope, resolve_device
from tpu_ac_torch.distributed.mesh import Mesh, shard_batch
from tpu_ac_torch.models.registry import load_backbone
from tpu_ac_torch.train.evals import (
    eval_mesh,
    module_replicas,
    multi_scale,
    revisited_retrieval_eval,
)

# images a decode chunk of the per-image path
DECODE_CHUNK = 16
# the --dp path's budget of buffered images, in full buffers
BUFFERED_BATCHES = 4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "Image Retrieval on revisited Paris and Oxford (PyTorch port)")
    p.add_argument("--data_path", required=True,
                   help="root containing <dataset>/gnd_<dataset>.pkl + jpg/")
    p.add_argument("--dataset", default="roxford5k",
                   choices=["roxford5k", "rparis6k"])
    p.add_argument("--multiscale", default=0, type=int,
                   help="1 = ensemble features over scales 1, 1/sqrt(2), 1/2")
    p.add_argument("--imsize", default=224, type=int,
                   help="thumbnail bound (aspect-preserving)")
    p.add_argument("--arch", default="dino_vitbase16",
                   help="backbone registry name")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--dp", action="store_true",
                   help="shape-bucketed data-parallel extraction over every "
                        "visible card (on the CPU, the host repeated): the "
                        "reference's DistributedSampler sharding, "
                        "eval_image_retrieval.py:112-118.")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def decoded(dataset: OxfordParisDataset, chunk: int
            ) -> Iterator[tuple[int, np.ndarray]]:
    """(index, uint8 [3, H, W]) in dataset order; the thumbnails of chunk
    c+1 decode on a thread pool (PIL releases the GIL) while the caller
    consumes chunk c."""
    with ThreadPoolExecutor(8, "tpu_ac_torch-decode") as pool, \
            ThreadPoolExecutor(1, "tpu_ac_torch-prefetch") as head:
        def chunks():
            for s in range(0, len(dataset), chunk):
                idxs = range(s, min(s + chunk, len(dataset)))
                yield lambda idxs=idxs: list(
                    pool.map(lambda i: (i, dataset.load_uint8(i)), idxs))

        for part in _lookahead(head, chunks()):
            yield from part


class ShapeBuckets:
    """Images grouped by shape into buffers of at most ``cap``, each full
    buffer handed to ``flush(shape, [(index, image), ...])``.

    Host memory is bounded across shapes: at most ``budget`` images are
    buffered in all (``peak`` records the most there were).  An image that
    would pass the budget first flushes the largest buffers, so a split of
    many distinct shapes embeds in smaller batches rather than holding
    every shape's partial buffer."""

    def __init__(self, cap: int, budget: int, flush: Callable):
        if budget < cap:
            raise ValueError(f"budget {budget} below the buffer cap {cap}")
        self.cap, self.budget, self._flush_fn = cap, budget, flush
        self.buffers: dict[tuple, list[tuple[int, np.ndarray]]] = {}
        self.n_buffered = 0
        self.peak = 0

    def _flush(self, shape: tuple) -> None:
        items = self.buffers.pop(shape)
        self.n_buffered -= len(items)
        self._flush_fn(shape, items)

    def add(self, index: int, image: np.ndarray) -> None:
        while self.n_buffered >= self.budget:
            self._flush(max(self.buffers, key=lambda s: len(self.buffers[s])))
        buf = self.buffers.setdefault(image.shape, [])
        buf.append((index, image))
        self.n_buffered += 1
        self.peak = max(self.peak, self.n_buffered)
        if len(buf) >= self.cap:
            self._flush(image.shape)

    def close(self) -> None:
        for shape in list(self.buffers):
            self._flush(shape)


def extract_split_features(embed_fn: Callable, dataset: OxfordParisDataset,
                           multiscale: bool = False, *,
                           mesh: Mesh | None = None,
                           device: str | torch.device = "cuda"
                           ) -> np.ndarray:
    """CLS features of a split, [N, D] on the host, in dataset order.

    ``embed_fn``: a normalized f32 batch on a device -> its features
    there.  Without ``mesh`` each image is embedded alone (the thumbnails
    vary in shape; the reference likewise runs batch_size=1,
    eval_image_retrieval.py:118-127).  With ``mesh`` extraction is
    shape-bucketed data parallel, the reference's DistributedSampler
    sharding (eval_image_retrieval.py:112-118): images are grouped by
    shape (``ShapeBuckets``, buffers of 8 x the mesh size, at most
    ``BUFFERED_BATCHES`` buffers' worth of images in all, besides the two
    decode chunks in flight), each flushed buffer is split over the ranks
    and its features scattered back into dataset order.  The ViT embeds
    each image on its own, so the features are those of the per-image
    path up to the summation order of a batch.
    """
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)

    def features(x: torch.Tensor) -> torch.Tensor:
        x = normalize_on_device(x)
        return multi_scale(x, embed_fn) if multiscale else embed_fn(x)

    out: list[torch.Tensor | None] = [None] * len(dataset)
    if mesh is None:
        upload = to_device(dev)
        for i, im in decoded(dataset, DECODE_CHUNK):
            out[i] = features(upload(im[None]))[0]
    else:
        cap = 8 * mesh.size

        def flush(shape, items):
            shards, n_valid = shard_batch(
                mesh, np.stack([im for _, im in items]))
            f = torch.cat([features(s).to(dev) for s in shards])[:n_valid]
            for k, (i, _) in enumerate(items):
                out[i] = f[k]

        buckets = ShapeBuckets(cap, BUFFERED_BATCHES * cap, flush)
        for i, im in decoded(dataset, cap):
            buckets.add(i, im)
        buckets.close()
    return torch.stack(out).cpu().numpy()


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    model, cfg, family = load_backbone(args.arch,
                                       checkpoint_dir=args.checkpoint_dir)
    if family != "vit":
        raise SystemExit(f"Architecture {args.arch} non supported")
    model = model.to(dev)
    mesh = eval_mesh(dev) if args.dp else None
    replicas = module_replicas(model, mesh) if mesh is not None else None

    def cls(x: torch.Tensor) -> torch.Tensor:
        # the ViT's patch grid needs H, W divisible by patch_size; the
        # reference's stride-ps conv silently floors, so cropping the
        # remainder is the same
        h = (x.shape[2] // cfg.patch_size) * cfg.patch_size
        w = (x.shape[3] // cfg.patch_size) * cfg.patch_size
        m = replicas[x.device] if replicas is not None else model
        with precision_scope("default"):
            return m.forward_cls(x[:, :, :h, :w])

    ds_train = OxfordParisDataset(args.data_path, args.dataset, "train",
                                  imsize=args.imsize)
    ds_query = OxfordParisDataset(args.data_path, args.dataset, "query",
                                  imsize=args.imsize)
    print(f"train: {len(ds_train)} imgs / query: {len(ds_query)} imgs")
    train_features, query_features = (
        extract_split_features(cls, ds, bool(args.multiscale), mesh=mesh,
                               device=dev)
        for ds in (ds_train, ds_query))

    ks = [1, 5, 10]
    res = revisited_retrieval_eval(query_features, train_features,
                                   ds_train.cfg["gnd"], kappas=ks)
    print(">> {}: mAP M: {}, H: {}".format(
        args.dataset, np.around(res["mAP_M"] * 100, decimals=2),
        np.around(res["mAP_H"] * 100, decimals=2)))
    print(">> {}: mP@k{} M: {}, H: {}".format(
        args.dataset, np.array(ks),
        np.around(res["mP@k_M"] * 100, decimals=2),
        np.around(res["mP@k_H"] * 100, decimals=2)))
    return res


if __name__ == "__main__":
    main()
