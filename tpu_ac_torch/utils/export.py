"""Ahead-of-time export of the serving programs (port of
``tpu_ac.utils.export``: ``torch.export`` in place of ``jax.export``).

The two programs a serving host needs, batched embedding and the packed
alpha+X, are traced with ``torch.export`` and serialized into one artifact
that a process without tpu_ac_torch loads and calls
(``scripts/serving_host_torch.py``), with the pipeline's static-shape
bucketing: n_images pads to the 32-image bucket, and the valid counts are
0-d int64 CPU tensors, so one artifact serves every category size up to its
capacity.  The params stay ARGUMENTS of the embed program: the artifact
holds no weight (only two constants of the embedding tail: the channel
statistics and the fused pooling conv's averaging matrix).

The alpha program holds the min_dists kernel as a node of the
``tpu_ac_torch`` op namespace (``kernels/distances.py``), the port's
counterpart of the Pallas kernel inside ``tpu_ac``'s StableHLO.  So that a
process without tpu_ac_torch can run that node, the artifact carries the
source of the module that registers the ops, ``csrc/min_dists.cu`` (with
its shared header inlined), and,
when exported for ``cuda``, the kernel library the export built.

Platforms: one exported program per platform ("cpu", "cuda"), each traced
on that platform's device, because a traced graph names the device of the
tensors it makes (the masks' ``arange``, the +inf fills) and of its
constants.  Exporting for "cuda" needs the card.  The TF32 switches are
global state, not part of a graph: ``meta["precision"]`` says how the
serving host sets them.

The artifact is the port's own format (``FORMAT_VERSION``): each package's
loader refuses the other's.

    emb = build_embedder_for_config(cfg, mesh=None)
    blob = export_category_programs(emb, cfg, n_images=32)
    save_exported("category_serving.tpuac", blob)
    progs = load_exported("category_serving.tpuac")
    z = progs["embed"](params, images)            # [B, P, D]
    packed = progs["alpha_x"](z_padded, n_valid)  # [N_pad, P+D]
"""

from __future__ import annotations

import io
import math
import os
import pickle
from typing import Any, Mapping

import torch

from tpu_ac_torch.cluster.alpha import alpha_from_weights, weighted_embedding
from tpu_ac_torch.device import resolve_device
from tpu_ac_torch.distributed.mesh import (
    combine_partials,
    per_image_weights,
    triangle_partial,
)
from tpu_ac_torch.kernels import distances
from tpu_ac_torch.kernels.build import CSRC_DIR, build_all
from tpu_ac_torch.pipeline import alpha_x_padded

FORMAT_VERSION = "tpu_ac_torch/1"
PLATFORMS = ("cpu", "cuda")
# the Queue 1 item that ports the export of a flash-attention embedder
FLASH_EXPORT_ITEM = "ROADMAP Queue 1 item 19"


class EmbedProgram(torch.nn.Module):
    """What ``pipeline.CategoryEmbedder`` computes for one batch, with the model's
    tensors an argument: ``forward(params, images)``, ``params`` the model's
    state dict (its torch key names; in the embed dtype) and ``images``
    uint8 [B, 3, H, W] -> f32 [B, P, D].  The embedder is held outside the
    module's tensors, so an export of this holds no weight.  TF32 is a
    global switch and no part of it: the caller sets it from the
    precision."""

    def __init__(self, embedder):
        super().__init__()
        # not a submodule: torch.export would lift its tensors
        self.__dict__["_step"] = _EmbedStep(embedder)

    def forward(self, params: dict, images: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(
            self._step, {f"model.{k}": v for k, v in params.items()},
            (images,), strict=True)


class _EmbedStep(torch.nn.Module):
    def __init__(self, embedder):
        super().__init__()
        self.model = embedder._model
        self.__dict__["_embedder"] = embedder

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self._embedder.embed_batch(images, self.model)


class AlphaXProgram(torch.nn.Module):
    """The single-device alpha+X of one bucket-padded category, packed:
    ``forward(z, n_valid)`` (unsupervised) or ``forward(z, z_train,
    n_valid, n_train_valid)`` (supervised) -> [N_pad, P+D] f32; the counts
    are 0-d int64 CPU tensors (``alpha_x_padded``)."""

    def __init__(self, supervised: str, tau: float, precision: str):
        super().__init__()
        self.supervised, self.tau, self.precision = supervised, tau, precision

    def forward(self, z: torch.Tensor, *args) -> torch.Tensor:
        if self.supervised == "supervised":
            z_train, n_valid, n_train_valid = args
            alpha, x = alpha_x_padded(z, n_valid, self.supervised, self.tau,
                                      self.precision, z_train, n_train_valid)
        else:
            (n_valid,) = args
            alpha, x = alpha_x_padded(z, n_valid, self.supervised, self.tau,
                                      self.precision)
        return torch.cat([alpha, x], dim=1)


class RankProgram(torch.nn.Module):
    """One dp rank's share of the sharded weights, on the rank's device,
    by ``kind``: "triangle" ``forward(z_local, bank, offset, n_valid)`` ->
    its partial sums [N_pad, P] (``triangle_partial``, the window op);
    "min" ``forward(z_local, z_train, n_train_valid)`` (supervised) and
    "mean" ``forward(z_local, bank, n_valid)`` (unsupervised on one rank)
    -> its W rows [L, P] (the rectangular op)."""

    def __init__(self, kind: str, precision: str):
        super().__init__()
        self.kind, self.precision = kind, precision

    def forward(self, z_local: torch.Tensor, bank: torch.Tensor,
                *counts) -> torch.Tensor:
        if self.kind == "triangle":
            offset, n_valid = counts
            return triangle_partial(z_local, bank, offset, n_valid,
                                    self.precision)
        (n_valid,) = counts
        return per_image_weights(z_local, bank, self.kind, n_valid,
                                 self.precision)


class CombineProgram(torch.nn.Module):
    """The ranks' results to the packed alpha+X [N_pad, P+D] on Z's device:
    "triangle" ``forward(partials, z, n_valid)`` sums the partials in rank
    order (``combine_partials``); the other kinds ``forward(w_rows, z)``
    join the ranks' W rows."""

    def __init__(self, kind: str, tau: float):
        super().__init__()
        self.kind, self.tau = kind, tau

    def forward(self, parts: list, z: torch.Tensor, *counts) -> torch.Tensor:
        if self.kind == "triangle":
            (n_valid,) = counts
            w = combine_partials(parts, z.device, n_valid)
        else:
            w = torch.cat([x.to(z.device) for x in parts])
        alpha = alpha_from_weights(w, self.tau)
        return torch.cat([alpha, weighted_embedding(alpha, z)], dim=1)


def _bucket(n: int, bucket: int) -> int:
    return -(-n // bucket) * bucket


def _check_exportable(embedder, cfg) -> None:
    if cfg.supervised not in ("unsupervised", "supervised"):
        # "average" runs eager and unpadded in compute_alpha_X: there is no
        # bucketed program to serialize for it
        raise ValueError(f"mode {cfg.supervised!r} is not exportable; "
                         "use unsupervised or supervised")
    if embedder._attention == "flash":
        raise NotImplementedError(
            "export of a flash-attention embedder is not ported yet "
            f"({FLASH_EXPORT_ITEM}); build it with attention_impl='auto' or "
            "'dense'")


def _devices(embedder, platforms) -> dict[str, torch.device]:
    """{platform: the device its programs are traced on}: the embedder's
    own device for its platform, else that platform's default device."""
    platforms = tuple(platforms) if platforms else (embedder.device.type,)
    out = {}
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"platform {p!r}; want one of {PLATFORMS}")
        out[p] = embedder.device if embedder.device.type == p \
            else resolve_device(p)
    return out


def _export(module: torch.nn.Module, args: tuple) -> bytes:
    """The trace of ``module`` on ``args``, serialized without its example
    inputs (``torch.export.save`` would store them: the params, and a
    full-capacity Z of 1.2 GB at ViT-B/8's width)."""
    with torch.no_grad():
        ep = torch.export.export(module, args, strict=False)
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _embed_program(embedder, cfg, dev: torch.device, batch: int
                   ) -> tuple[bytes, int, int]:
    """(serialized embed program, P, D) traced on ``dev`` at ``batch``."""
    params = {k: v.to(dev) for k, v in embedder._model.state_dict().items()}
    images = torch.zeros((batch, 3, cfg.imagesize, cfg.imagesize),
                         dtype=torch.uint8, device=dev)
    prog = EmbedProgram(embedder)
    with torch.no_grad():
        # an eager call first: it fills the tail's cached constants (the
        # channel statistics, the pooling matrix) with real tensors, which
        # the trace would otherwise cache as fake ones
        _, p, d = prog(params, images).shape
    return _export(prog, (params, images)), p, d


def _carried_files(platforms) -> dict[str, Any]:
    """The op module's source, the kernel's source and, for "cuda", the
    kernel library built here."""
    with open(distances.__file__) as f:
        ops_source = f.read()
    with open(os.path.join(CSRC_DIR, "min_dists.cu")) as f:
        kernel_source = f.read()
    # one file: the shared header in place of its include
    include = '#include "hopper_common.cuh"'
    with open(os.path.join(CSRC_DIR, "hopper_common.cuh")) as f:
        kernel_source = kernel_source.replace(include, f.read())
    library = None
    if "cuda" in platforms:
        with open(build_all()["min_dists"], "rb") as f:
            library = f.read()
    return {"ops_source": ops_source, "kernel_source": kernel_source,
            "kernel_library": library}


def _meta(embedder, cfg, n_pad: int, nt_pad: int, p: int, d: int,
          platforms) -> dict[str, Any]:
    return {
        "backbone_name": cfg.backbone_name,
        "layers": list(cfg.layers),
        "batch_size": cfg.batch_size,
        "imagesize": cfg.imagesize,
        "n_images_capacity": int(n_pad),
        "n_train_capacity": int(nt_pad),
        "supervised": cfg.supervised,
        "tau": float(cfg.tau),
        "precision": cfg.precision,
        "alpha_precision": cfg.resolved_alpha_precision,
        "platforms": list(platforms),
        "image_dtype": "uint8",
        "n_patches": int(p),
        "embed_dim": int(d),
        # the embed program's params dtype (the serving host casts to it)
        "param_dtype": str(embedder._dtype).removeprefix("torch."),
        "torch_version": torch.__version__,
    }


def export_category_programs(embedder, cfg, n_images: int, *,
                             n_train_images: int | None = None,
                             platforms: tuple[str, ...] | None = None
                             ) -> dict[str, Any]:
    """Serialize the embed + alpha+X programs for one serving shape.

    Args:
        embedder: a single-device ``CategoryEmbedder``, its
            ``attention_impl`` "auto" or "dense": either exports the dense
            attention.
        cfg: the ``PipelineConfig`` (batch_size, tau, mode and precision
            are baked into the artifact).
        n_images: alpha capacity; category sizes <= n_images are served by
            padding to its 32-bucket.
        n_train_images: supervised-mode train-bank capacity, bucketed on
            its own (default ``n_images``).
        platforms: ("cpu",), ("cuda",) or both; default the embedder's.

    Returns a picklable dict (pass to ``save_exported``).
    """
    if embedder.mesh is not None:
        raise ValueError("export serializes single-device programs; "
                         "build the embedder with mesh=None")
    _check_exportable(embedder, cfg)
    devices = _devices(embedder, platforms)
    n_pad = _bucket(n_images, 32)  # the bucket compute_alpha_X uses
    nt_pad = _bucket(n_train_images or n_images, 32)
    alpha = AlphaXProgram(cfg.supervised, float(cfg.tau),
                          cfg.resolved_alpha_precision)
    programs = {}
    for platform, dev in devices.items():
        embed, p, d = _embed_program(embedder, cfg, dev, cfg.batch_size)
        z = torch.zeros((n_pad, p, d), device=dev)
        count = distances.count_tensor(n_pad, 0)
        if cfg.supervised == "supervised":
            args = (z, torch.zeros((nt_pad, p, d), device=dev), count,
                    distances.count_tensor(nt_pad, 0))
        else:
            args = (z, count)
        programs[platform] = {"embed": embed,
                              "alpha_x": _export(alpha, args)}
    return {"format_version": FORMAT_VERSION, "programs": programs,
            **_carried_files(devices),
            "meta": _meta(embedder, cfg, n_pad, nt_pad, p, d, devices)}


def export_sharded_category_programs(embedder, cfg, n_images: int, *,
                                     n_train_images: int | None = None,
                                     platforms: tuple[str, ...] | None = None
                                     ) -> dict[str, Any]:
    """Multi-device variant of :func:`export_category_programs`, for the
    embedder's dp mesh.

    The port's mesh runs in one process over listed devices, so the
    artifact holds three programs that the serving host places itself:
    ``embed`` (one shard of batch_size / dp images), ``rank`` (one rank's
    share of the weights: ``forward(z_local, bank, offset, n_valid)`` ->
    its triangle partial [N_pad, P] on the window op; supervised
    ``forward(z_local, z_train, n_train_valid)`` -> its W rows on the
    rectangular op; at dp = 1 unsupervised ``forward(z_local, bank,
    n_valid)`` -> its W rows) and ``combine`` (``forward(parts, z[,
    n_valid])`` -> the packed [N_pad, P+D], as ``_alpha_x_mesh`` and
    ``sharded_weight_distance_*`` compute it).  The capacity pads to the
    32-bucket AND the dp axis.  ``meta["n_devices"]`` records dp; the
    programs name no card of a mesh, only their platform.
    """
    if embedder.mesh is None:
        raise ValueError("sharded export needs a mesh-built embedder; "
                         "use export_category_programs for single-device")
    _check_exportable(embedder, cfg)
    dp = embedder.mesh.size
    bs = cfg.batch_size
    if bs % dp:
        raise ValueError(f"batch_size {bs} must divide over dp={dp}")
    devices = _devices(embedder, platforms)
    bucket = math.lcm(32, dp)
    n_pad = _bucket(n_images, bucket)
    nt_pad = _bucket(n_train_images or n_images, bucket)
    n_local = n_pad // dp
    prec = cfg.resolved_alpha_precision
    if cfg.supervised == "supervised":
        kind = "min"
    else:  # the triangle needs >= 2 ranks
        kind = "triangle" if dp > 1 else "mean"
    rank, combine = RankProgram(kind, prec), CombineProgram(kind,
                                                            float(cfg.tau))
    count = distances.count_tensor
    programs = {}
    for platform, dev in devices.items():
        embed, p, d = _embed_program(embedder, cfg, dev, bs // dp)
        z_local = torch.zeros((n_local, p, d), device=dev)
        z = torch.zeros((n_pad, p, d), device=dev)
        if kind == "min":
            rank_args = (z_local, torch.zeros((nt_pad, p, d), device=dev),
                         count(nt_pad, 0))
        elif kind == "triangle":
            rank_args = (z_local, z, count(0, 0), count(n_pad, 0))
        else:
            rank_args = (z_local, z, count(n_pad, 0))
        # one tensor each: inputs that alias one another are traced as one
        rows = n_pad if kind == "triangle" else n_local
        parts = [torch.zeros((rows, p), device=dev) for _ in range(dp)]
        combine_args = (parts, z, count(n_pad, 0)) if kind == "triangle" \
            else (parts, z)
        programs[platform] = {"embed": embed,
                              "rank": _export(rank, rank_args),
                              "combine": _export(combine, combine_args)}
    meta = _meta(embedder, cfg, n_pad, nt_pad, p, d, devices)
    meta.update(sharded=True, n_devices=int(dp), mesh_axis="dp",
                rank_kind=kind)
    return {"format_version": FORMAT_VERSION, "programs": programs,
            **_carried_files(devices), "meta": meta}


def save_exported(path: str, blob: Mapping[str, Any]) -> str:
    with open(path, "wb") as f:
        pickle.dump(dict(blob), f)
    return path


def load_exported(path: str, device=None) -> dict[str, Any]:
    """Load an artifact: {"embed": fn, "alpha_x": fn, "meta": {...}} (a
    sharded one: "embed", "rank", "combine"), the programs of ``device``'s
    platform (default: cuda where the artifact and the machine have it,
    else the artifact's first platform).  The ops are this package's; the
    artifact's copy of them is for processes without it."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if blob.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported export format {blob.get('format_version')!r} "
            f"(this loader reads {FORMAT_VERSION!r})")
    programs = blob["programs"]
    if device is not None:
        platform = torch.device(device).type
    elif "cuda" in programs and torch.cuda.is_available():
        platform = "cuda"
    else:
        platform = next(iter(programs))
    if platform not in programs:
        raise ValueError(f"the artifact holds programs for "
                         f"{sorted(programs)}, not {platform!r}")
    out = {name: torch.export.load(io.BytesIO(data)).module()
           for name, data in programs[platform].items()}
    out["meta"] = blob["meta"]
    return out
