"""Category-level anomaly-clustering pipeline (port of ``tpu_ac.pipeline``).

Stage 1 embeds a category on the device, computes (alpha, X) and pickles
them; stage 2 (``cli/evaluate.py``) clusters and scores.  The artifact is
the ``tpu_ac`` one: a pickled (alpha [N, 1, P] f32, X [N, D] f32) numpy
tuple, so either package reads the other's files.

The dp-mesh branches of ``CategoryEmbedder`` and ``compute_alpha_X`` take a
``tpu_ac_torch.distributed.Mesh``: one process drives every device of it,
and a mesh that repeats one device (a virtual mesh) runs the same
multi-device path on one card or on the CPU.  ``"auto"`` engages a mesh
only with more than one card.  Not carried from ``tpu_ac``: the
``_Uploader`` thread, whose job (keeping a slow host link off the dispatch
path) is done here by pinned host buffers and ``non_blocking`` copies.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import pickle

import numpy as np
import torch

from tpu_ac_torch.cluster.alpha import (
    alpha_from_weights,
    matrix_alpha_average,
    weight_distance_supervised,
    weight_distance_unsupervised,
    weighted_embedding,
)
from tpu_ac_torch.cluster.metrics import (
    agglomerative_cluster,
    clustering_scores,
    encode_labels,
)
from tpu_ac_torch.data.mvtec import (
    DatasetSplit,
    MVTecDataset,
    load_image_uint8,
    normalize_on_device,
)
from tpu_ac_torch.device import embed_dtype, precision_scope, resolve_device
from tpu_ac_torch.distributed import (
    Mesh,
    get_mesh,
    shard_batch,
    sharded_weight_distance_supervised,
    sharded_weight_distance_unsupervised,
)
from tpu_ac_torch.features.embedding import EmbedConfig, embed_features
from tpu_ac_torch.kernels import attention as flash_attention
from tpu_ac_torch.models.registry import load_backbone
from tpu_ac_torch.utils.profiling import step_annotation

IMAGES_DECODED = 0
IMAGES_EMBEDDED = 0
# embed batches during which the hand-written flash kernel launched
# (``kernels.attention.LAUNCHES`` rose): once a batch, not a shard or block
ATTENTION_FUSED_BATCHES = 0
ATTENTION_IMPLS = ("auto", "dense", "flash")
# the device type on which "auto" takes the flash kernel
FLASH_DEVICE_TYPE = "cuda"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Hyperparameters mirroring the reference's main.py flags."""

    backbone_name: str = "dino_vitbase8"
    layers: tuple[str, ...] = ("blocks.10", "blocks.11")
    pretrain_embed_dimension: int = 2048
    target_embed_dimension: int = 4096
    patchsize: int = 3
    tau: float = 1.0
    train_ratio: float = 1.0
    supervised: str = "unsupervised"  # unsupervised | supervised | average
    resize: int = 256
    imagesize: int = 224
    batch_size: int = 32
    # "default" (f32, TF32 allowed) | "highest" (f32, TF32 off) |
    # "bfloat16" (bf16 params and activations)
    precision: str = "default"
    # distance-kernel precision: "auto" follows ``precision`` (bfloat16 ->
    # "bf16", else "f32") | "f32" | "bf16c" | "bf16"
    alpha_precision: str = "auto"

    @property
    def resolved_alpha_precision(self) -> str:
        if self.alpha_precision != "auto":
            return self.alpha_precision
        return "bf16" if self.precision == "bfloat16" else "f32"

    @property
    def embed_config(self) -> EmbedConfig:
        return EmbedConfig(
            layers=self.layers,
            pretrain_embed_dimension=self.pretrain_embed_dimension,
            target_embed_dimension=self.target_embed_dimension,
            patchsize=self.patchsize,
        )


class _StagedUpload:
    """Per-batch device tensors of an upload in flight, the pinned host
    buffer they are copied from, and the true N."""

    __slots__ = ("batches", "host", "n")

    def __init__(self, batches, host, n: int):
        self.batches = batches
        self.host = host  # kept alive until the copies have run
        self.n = n


class CategoryEmbedder:
    """Batched embedding of an image set on one device or over a dp mesh.

    ``model`` is a module of any registry family (f32, any device); it is
    moved to ``device`` and, for ``precision="bfloat16"``, cast to bf16
    (every float tensor, BN statistics included, as ``tpu_ac`` casts its
    params).  The embed
    dispatches on its ``family`` (``features.embedding.FAMILY_EMBEDDERS``).
    ``attention_impl`` (ViT only): "flash" runs every block's attention
    through the flash kernel (``kernels/attention.py``; its plain version
    on the CPU), on the true token count (no ``seq_pad``); "dense" runs
    the dense attention, as ``tpu_ac`` does by default; "auto" takes the
    flash kernel for a bfloat16 embed on a card (on a card the kernels are
    not built for, their build or launch raises, as ``min_dists`` does)
    and the dense attention otherwise: on the CPU, in f32 (3xTF32 is not
    the f32 products ``"highest"`` states) and while the embed is traced
    for export (``utils/export.py``), which exports the dense attention.

    ``mesh``: a ``Mesh`` shards each batch over its positions (one model
    replica per distinct device; ``batch_size`` must divide evenly; then
    ``device`` is not used), and the result is the [N, P, D] one device
    gives, on the mesh's first device; "auto" picks ``get_mesh()`` when
    more than one card is visible, ``device`` is CUDA and ``batch_size``
    divides over the cards; None (or "auto" otherwise) embeds on
    ``device``.
    """

    def __init__(self, model, cfg: PipelineConfig,
                 device="cuda", attention_impl: str = "auto", mesh=None):
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {attention_impl!r}; want one "
                             f"of {ATTENTION_IMPLS}")
        self._family = model.family
        if attention_impl == "flash" and self._family != "vit":
            raise ValueError(f"attention_impl 'flash' needs a ViT, not the "
                             f"{self._family} family")
        if mesh == "auto":
            count = torch.cuda.device_count()
            mesh = get_mesh() if (resolve_device(device).type == "cuda" and
                                  count > 1 and
                                  cfg.batch_size % count == 0) else None
        if mesh is not None and cfg.batch_size % mesh.size:
            raise ValueError(f"batch size {cfg.batch_size} not divisible "
                             f"over a mesh of {mesh.size}")
        self.mesh = mesh
        self._dtype = embed_dtype(cfg.precision)
        # the device of each shard of a batch: one, or the mesh's positions
        self._positions = (resolve_device(device),) if mesh is None \
            else mesh.devices
        self.device = self._positions[0]
        self._models = {}
        for d in dict.fromkeys(self._positions):
            # .to() moves a module in place: the other devices get copies
            m = model if not self._models else copy.deepcopy(model)
            self._models[d] = m.to(device=d, dtype=self._dtype)
        self._model = self._models[self.device]
        self._cfg = cfg
        self._attention = attention_impl

    def stage(self, images: np.ndarray) -> _StagedUpload:
        """Start uploading uint8 [N, 3, H, W] images, padded to a multiple of
        batch_size; over a mesh each batch is split into one shard per
        position, uploaded to its device.  On CUDA the host array is copied
        once into pinned memory and each batch is copied with
        ``non_blocking=True``, so the call returns before the transfer
        ends."""
        n = images.shape[0]
        bs = self._cfg.batch_size
        pad = (-n) % bs
        host = torch.from_numpy(np.ascontiguousarray(images))
        if pad:
            host = torch.cat([host, host.new_zeros(pad, *host.shape[1:])])
        pos = self._positions
        if any(d.type == "cuda" for d in pos):
            host = host.pin_memory()
        batches = [[x.to(d, non_blocking=True)
                    for x, d in zip(host[s:s + bs].chunk(len(pos)), pos)]
                   for s in range(0, host.shape[0], bs)]
        return _StagedUpload(batches, host, n)

    def embed_batch(self, batch: torch.Tensor, model) -> torch.Tensor:
        """One batch through ``model`` (this embedder's model or a copy of
        it): uint8 or normalized [B, 3, H, W] -> f32 [B, P, D].  No
        precision scope and no grad mode: the caller sets them
        (``utils/export.py EmbedProgram`` traces this)."""
        images = batch
        if images.dtype == torch.uint8:
            images = normalize_on_device(images)
        images = images.to(self._dtype)
        kw = {"attention_impl": self._attention_on(images.device)} \
            if self._family == "vit" else {}
        z = embed_features(self._family, model, images,
                           self._cfg.embed_config, **kw)
        return z.to(torch.float32)

    def _attention_on(self, device: torch.device) -> str | None:
        """The attention a ViT embed on ``device`` runs, ``attention_impl``
        resolved: "flash", or None (dense; any other family)."""
        if self._family != "vit":
            return None
        if self._attention == "auto":
            fused = (self._dtype == torch.bfloat16 and
                     not torch.compiler.is_compiling() and
                     device.type == FLASH_DEVICE_TYPE)
            return "flash" if fused else None
        return "flash" if self._attention == "flash" else None

    def _embed(self, batch: torch.Tensor, model) -> torch.Tensor:
        with precision_scope(self._cfg.precision), torch.inference_mode():
            return self.embed_batch(batch, model)

    def __call__(self, images) -> torch.Tensor:
        """[N, 3, H, W] host images (or a ``stage()`` token) -> [N, P, D] f32
        embeddings on ``self.device``; nothing here waits for the
        device."""
        global IMAGES_EMBEDDED, ATTENTION_FUSED_BATCHES
        staged = images if isinstance(images, _StagedUpload) \
            else self.stage(images)
        IMAGES_EMBEDDED += staged.host.shape[0]
        chunks = []
        for shards in staged.batches:
            launches = flash_attention.LAUNCHES
            chunks += [self._embed(x, self._models[d]).to(self.device)
                       for x, d in zip(shards, self._positions)]
            ATTENTION_FUSED_BATCHES += flash_attention.LAUNCHES > launches
        return torch.cat(chunks)[:staged.n]


def _pad_bucket(Z: torch.Tensor, bucket: int) -> torch.Tensor:
    pad = (-Z.shape[0]) % bucket
    if pad == 0:
        return Z
    return torch.cat([Z, Z.new_zeros(pad, *Z.shape[1:])])


def _alpha_x_mesh(Z: torch.Tensor, supervised: str, tau: float,
                  Z_train: torch.Tensor | None, precision: str,
                  mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The dp branch: W over the mesh, then alpha and X on Z's device."""
    n = Z.shape[0]
    z_sh, _ = shard_batch(mesh, Z)  # on the device, no host round trip
    if supervised == "supervised":
        if Z_train is None:
            raise ValueError("supervised mode requires Z_train")
        w_sh = sharded_weight_distance_supervised(mesh, z_sh, Z_train,
                                                  precision=precision)
    else:
        w_sh = sharded_weight_distance_unsupervised(mesh, z_sh, n_valid=n,
                                                    precision=precision)
    w = torch.cat([x.to(Z.device) for x in w_sh])[:n]
    alpha = alpha_from_weights(w, tau)
    return alpha, weighted_embedding(alpha, Z)


def alpha_x_padded(z: torch.Tensor, n_valid, supervised: str, tau: float,
                   precision: str, z_train: torch.Tensor | None = None,
                   n_train_valid=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(alpha [N_pad, P], X [N_pad, D]) f32 of a bucket-padded category on
    one device, the valid counts ints or 0-d int64 CPU tensors (as an
    exported program takes them): what ``compute_alpha_X`` computes before
    it slices the padding off, and what ``utils/export.py AlphaXProgram`` exports.  Padded
    rows get W = 0."""
    if supervised == "supervised":
        w = weight_distance_supervised(z, z_train, n_train_valid,
                                       precision, n_valid=n_valid)
    else:
        w = weight_distance_unsupervised(z, n_valid, precision)
    alpha = alpha_from_weights(w, tau)
    x = weighted_embedding(alpha, z)
    return alpha.to(torch.float32), x.to(torch.float32)


def compute_alpha_X(Z: torch.Tensor, supervised: str, tau: float,
                    Z_train: torch.Tensor | None = None, n_bucket: int = 32,
                    use_mesh: bool | None = None, precision: str = "f32",
                    mesh: Mesh | None = None, packed: bool = False):
    """(alpha [N, P], X [N, D]), or one [N, P+D] tensor when ``packed``.

    Single device: N pads to a multiple of ``n_bucket`` as in ``tpu_ac``;
    the padded rows are left out of the distance sweep and sliced off here.

    ``use_mesh`` (default: Z on CUDA, more than one card, and a mode other
    than "average") shards the weight computation over ``mesh`` (default
    ``get_mesh()``): unsupervised takes the triangle scheme of
    ``tpu_ac_torch.distributed``, whose window kernel never computes an
    image against itself, so its W leaves out the self-term floor that the
    single-device sweep sums; supervised sweeps each rank's rows against
    the replicated train bank.
    """
    n = Z.shape[0]
    if n < 2 and supervised == "unsupervised":
        # the weight is a mean over the OTHER images (divides by n-1)
        raise ValueError(
            f"unsupervised alpha needs >= 2 images per category, got {n}")
    if use_mesh is None:
        use_mesh = (Z.device.type == "cuda" and torch.cuda.device_count() > 1
                    and supervised != "average")
    if use_mesh and supervised in ("supervised", "unsupervised"):
        alpha, x = _alpha_x_mesh(Z, supervised, tau, Z_train, precision,
                                 get_mesh() if mesh is None else mesh)
    elif supervised == "supervised":
        if Z_train is None:
            raise ValueError("supervised mode requires Z_train")
        alpha, x = alpha_x_padded(
            _pad_bucket(Z, n_bucket), n, supervised, tau, precision,
            _pad_bucket(Z_train, n_bucket), Z_train.shape[0])
    elif supervised == "unsupervised":
        alpha, x = alpha_x_padded(_pad_bucket(Z, n_bucket), n, supervised,
                                  tau, precision)
    elif supervised == "average":
        alpha = matrix_alpha_average(Z)
        x = weighted_embedding(alpha, Z)
    else:
        raise ValueError(f"supervised mode {supervised!r}")
    alpha, x = alpha[:n].to(torch.float32), x[:n].to(torch.float32)
    if packed:
        return torch.cat([alpha, x], dim=1)
    return alpha, x


def artifact_dir(output_dir: str, dataset: str, backbone: str,
                 supervised: str, cfg: PipelineConfig) -> str:
    """Reference-compatible output tree."""
    return os.path.join(
        output_dir, dataset, backbone, supervised,
        "_".join(cfg.layers) + f"_{cfg.pretrain_embed_dimension}"
        f"_{cfg.target_embed_dimension}_{float(cfg.tau)}"
        f"_{float(cfg.train_ratio)}")


def save_alpha_X(path_dir: str, category: str, supervised: str,
                 alpha: np.ndarray, X: np.ndarray) -> str:
    """Pickle (alpha [N,1,P] f32, X [N,D] f32) numpy arrays."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir,
                        f"matrix_alpha_X_{category}_{supervised}.pickle")
    with open(path, "wb") as f:
        pickle.dump((np.asarray(alpha, np.float32)[:, None, :],
                     np.asarray(X, np.float32)), f)
    return path


def load_alpha_X(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load (alpha, X) written by ``save_alpha_X`` (either package) or by
    the reference's torch.save."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"PK":  # torch zipfile serialization from the reference
        alpha, X = torch.load(path, map_location="cpu", weights_only=False)
        return np.asarray(alpha), np.asarray(X)
    with open(path, "rb") as f:
        alpha, X = pickle.load(f)
    return np.asarray(alpha), np.asarray(X)


def _load_train_images(source: str, category: str, cfg: PipelineConfig,
                       n_test: int, seed: int) -> np.ndarray:
    """Decode the supervised train split (uint8), truncated like the
    reference to ``train_ratio * len(test set)`` in shuffled order."""
    from concurrent.futures import ThreadPoolExecutor

    train_ds = MVTecDataset(source, classname=category, resize=cfg.resize,
                            imagesize=cfg.imagesize, split=DatasetSplit.TRAIN)
    order = np.random.default_rng(seed).permutation(len(train_ds))
    keep = order[: int(cfg.train_ratio * n_test)]
    with ThreadPoolExecutor(min(16, os.cpu_count() or 1)) as pool:
        return np.stack(list(pool.map(
            lambda i: load_image_uint8(train_ds.items[int(i)].image_path,
                                       cfg.resize, cfg.imagesize), keep)))


def _dispatch_category(category: str, test_ds, images, cfg: PipelineConfig,
                       embedder: CategoryEmbedder, train_images=None) -> dict:
    """Queue one category's device work without waiting for it.

    The packed [N, P+D] result starts its device->host copy into pinned
    memory at once; ``_resolve_category`` waits on its event.  Nothing here
    synchronizes the host with the device.
    """
    with step_annotation("ac.dispatch"):
        with step_annotation("ac.embed"):
            Z = embedder(images)
        Z_train = None
        if cfg.supervised == "supervised":
            with step_annotation("ac.embed"):
                Z_train = embedder(train_images)
        mesh = embedder.mesh
        with step_annotation("ac.alpha"):
            packed = compute_alpha_X(
                Z, cfg.supervised, cfg.tau, Z_train,
                precision=cfg.resolved_alpha_precision,
                use_mesh=True if mesh is not None else None, mesh=mesh,
                packed=True)
        done = None
        if packed.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            packed = host
    return {"category": category, "test_ds": test_ds, "packed": packed,
            "done": done, "n_patches": int(Z.shape[1])}


def _resolve_category(pending: dict, cfg: PipelineConfig, output_dir,
                      dataset_name: str) -> dict:
    """Wait for a dispatched category's packed result and materialize it."""
    with step_annotation("ac.resolve"):
        with step_annotation("ac.resolve_wait"):
            if pending["done"] is not None:
                pending["done"].synchronize()
        arr = pending["packed"].numpy()
        p = pending["n_patches"]
        alpha_np, x_np = arr[:, :p], arr[:, p:]
        test_ds = pending["test_ds"]
        result = {"alpha": alpha_np, "X": x_np,
                  "anomaly_labels": [it.anomaly for it in test_ds.items],
                  "items": test_ds.items}
        if output_dir is not None:
            d = artifact_dir(output_dir, dataset_name, cfg.backbone_name,
                             cfg.supervised, cfg)
            result["artifact_path"] = save_alpha_X(
                d, pending["category"], cfg.supervised, alpha_np, x_np)
    return result


def _decode_and_stage(decode, embedder: CategoryEmbedder) -> _StagedUpload:
    """``decode()``'s uint8 images, counted and handed to ``stage``."""
    global IMAGES_DECODED
    with step_annotation("ac.decode"):
        images = decode()
    IMAGES_DECODED += images.shape[0]
    with step_annotation("ac.stage"):
        return embedder.stage(images)


def _load_category(source: str, category: str, cfg: PipelineConfig,
                   embedder: CategoryEmbedder, seed: int):
    with step_annotation("ac.load"):
        ds = MVTecDataset(source, classname=category, resize=cfg.resize,
                          imagesize=cfg.imagesize, split=DatasetSplit.TEST)
        staged = _decode_and_stage(ds.load_all_images, embedder)
        train = None
        if cfg.supervised == "supervised":
            train = _decode_and_stage(
                lambda: _load_train_images(source, category, cfg, len(ds),
                                           seed), embedder)
    return ds, staged, train


def run_category_sweep(source: str, categories: list[str],
                       cfg: PipelineConfig, embedder: CategoryEmbedder,
                       output_dir: str | None = None,
                       dataset_name: str = "mvtec_ad", seed: int = 2023):
    """Generator of (category, result), pipelined: category c+1 decodes on
    a host thread and starts uploading while c computes, and c+1 is
    dispatched before c's result is resolved."""
    from concurrent.futures import ThreadPoolExecutor

    if not categories:
        return
    with ThreadPoolExecutor(1) as prefetcher:
        nxt = prefetcher.submit(_load_category, source, categories[0], cfg,
                                embedder, seed)
        pending = None
        for i, category in enumerate(categories):
            with step_annotation("ac.prefetch_wait"):
                test_ds, images, train_images = nxt.result()
            if i + 1 < len(categories):
                nxt = prefetcher.submit(_load_category, source,
                                        categories[i + 1], cfg, embedder,
                                        seed)
            cur = _dispatch_category(category, test_ds, images, cfg,
                                     embedder, train_images)
            if pending is not None:
                yield pending["category"], _resolve_category(
                    pending, cfg, output_dir, dataset_name)
            pending = cur
        yield pending["category"], _resolve_category(
            pending, cfg, output_dir, dataset_name)


def category_metrics(X: np.ndarray, anomaly_labels: list[str]
                     ) -> dict[str, float]:
    """Agglomerative clustering + Hungarian-mapped NMI/ARI/F1, with the
    reference's 'combined' label drop."""
    keep = [i for i, a in enumerate(anomaly_labels) if a != "combined"]
    X = np.asarray(X)[keep]
    labels = encode_labels([anomaly_labels[i] for i in keep])
    preds = agglomerative_cluster(X, n_clusters=len(set(labels.tolist())))
    return clustering_scores(labels, preds)


def build_embedder_for_config(cfg: PipelineConfig, *, device="cuda",
                              checkpoint_dir=None, attention_impl="auto",
                              seed: int = 0, mesh="auto") -> CategoryEmbedder:
    """The registry's backbone for ``cfg`` (a checkpoint from
    ``checkpoint_dir`` or the default cache dirs, else the seeded init) in
    a ``CategoryEmbedder``; ``attention_impl`` and ``mesh`` as in
    ``CategoryEmbedder`` (``mesh="auto"``: every card, when there is more
    than one)."""
    model, _backbone_cfg, _family = load_backbone(
        cfg.backbone_name, checkpoint_dir=checkpoint_dir, seed=seed)
    return CategoryEmbedder(model, cfg, device=device,
                            attention_impl=attention_impl, mesh=mesh)
