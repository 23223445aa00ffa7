"""Device mesh helpers and the sharded alpha (port of
``tpu_ac.distributed.mesh``).

The alpha weights are the one stage that exchanges data across devices:
each dp rank owns N/dp test images, gathers the whole patch-embedding bank
once and computes min-distance rows for its own images.

``tpu_ac`` runs this as one program over a ``jax.sharding.Mesh``: a
``shard_map`` body whose ``all_gather`` and ``psum`` ride the chips'
interconnect.  Here one process drives every device of the mesh, as the
single JAX controller does, and the collectives run outside the kernels:
the gather is a peer copy of the shards to each distinct device, the sum of
the partials a sum of tensors.  A ``Mesh`` is an ordered list of
``torch.device``s and may hold the same device more than once, so dp >= 2
runs on one card (its ranks one after another, each at the shape it has on
a real mesh) or on the CPU.  A sharded array is a plain list of
per-position shards.  Training across processes runs on
``torch.distributed`` (``multihost_init``, ``collectives.py``); the requeue
launcher is ``distributed/launch.py``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_ac_torch.kernels.distances import (
    count_tensor,
    min_dists_all_pairs,
    min_dists_window,
)


class Mesh:
    """A 1-D data-parallel mesh: an ordered list of devices on the
    ``axis_name`` axis.  A device may recur (a virtual mesh: the ranks on
    it run one after another)."""

    def __init__(self, devices, axis_name: str = "dp"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> tuple[torch.device, ...]:
        """The devices in first-seen order, each once."""
        return tuple(dict.fromkeys(self.devices))


def get_mesh(n_devices: int | None = None, axis_name: str = "dp") -> Mesh:
    """A 1-D data-parallel mesh over the first n CUDA cards (all of them by
    default).

    Raises when fewer than ``n_devices`` are available: a silently
    truncated mesh would run a different topology than the one requested.
    """
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count or n < 1:
        raise ValueError(
            f"requested a {n}-device mesh but only {count} devices are "
            f"available (for a dry run on one card or on the CPU, build a "
            f"virtual mesh of a repeated device: Mesh(['cuda:0'] * {n}) or "
            f"Mesh(['cpu'] * {n}))")
    return Mesh([f"cuda:{i}" for i in range(n)], axis_name)


# the cluster environments a bare multihost_init call joins: torchrun's
# and SLURM's (tpu_ac reads JAX's coordinator and the TPU pod's instead)
CLUSTER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "SLURM_JOB_NUM_NODES")


def multihost_init(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None) -> None:
    """Join a ``torch.distributed`` group of processes, the reference's
    init_distributed_mode (dino-main/utils.py:467-499), with ``tpu_ac``'s
    no-op rules: ``num_processes <= 1`` does nothing, and so does a bare
    call outside a cluster environment (torchrun's RANK/WORLD_SIZE/
    MASTER_ADDR, SLURM's job).

    ``coordinator_address`` ("host:port", rank 0's) becomes a ``tcp://``
    init method; without it the group reads torchrun's MASTER_ADDR and
    MASTER_PORT.  The world size and rank come from the arguments, else
    from WORLD_SIZE/RANK (SLURM_NTASKS/SLURM_PROCID).  Where CUDA is
    present, the rank's card is cuda:LOCAL_RANK (SLURM_LOCALID; 0 when
    neither is set), made the current device.

    The backend is chosen once, before the init, and never changed after a
    failure (a failed init raises): ``nccl`` where CUDA is present (a card
    a rank), ``gloo`` without it, or ``backend`` as given.  Ranks that
    share one card pass ``backend="gloo"``, since NCCL refuses two ranks on
    one GPU; gloo reduces CUDA tensors only by all_reduce and broadcast,
    which is all ``collectives.py`` uses.
    """
    env = os.environ
    if num_processes is not None and num_processes <= 1:
        return
    if (coordinator_address is None and num_processes is None
            and process_id is None
            and not any(env.get(v) for v in CLUSTER_ENV)):
        return
    world = (num_processes if num_processes is not None
             else int(env.get("WORLD_SIZE") or env.get("SLURM_NTASKS")
                      or 1))
    if world <= 1:
        return
    rank = (process_id if process_id is not None
            else int(env.get("RANK") or env.get("SLURM_PROCID") or 0))
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        torch.cuda.set_device(int(env.get("LOCAL_RANK")
                                  or env.get("SLURM_LOCALID") or 0))
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)


def process_count() -> int:
    """The number of processes of the default group (1 without one)."""
    return (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 1)


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)


def dp_mesh(dp: int, batch_size: int | None = None,
            flag: str = "--dp") -> Mesh:
    """CLI helper: a dp-device mesh, validating batch divisibility first."""
    if batch_size is not None and batch_size % dp:
        raise ValueError(
            f"batch size {batch_size} not divisible by {flag} {dp}")
    return get_mesh(dp)


def replicate(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """``x`` on every mesh position: one copy per distinct device, the same
    tensor at the positions that share it.  (The model of the dp embed is
    replicated by ``CategoryEmbedder``.)"""
    per_device = {d: x.to(d) for d in mesh.distinct_devices}
    return [per_device[d] for d in mesh.devices]


def shard_batch(mesh: Mesh, array) -> tuple[list[torch.Tensor], int]:
    """Split the leading (batch) axis over the mesh, zero-padding it to a
    multiple of the mesh size; (shards, n_valid).  A tensor is padded and
    split on its own device and each shard copied to its position's
    device (no host round trip); a numpy array is uploaded per shard."""
    x = torch.from_numpy(np.asarray(array)) \
        if not isinstance(array, torch.Tensor) else array
    n = x.shape[0]
    pad = (-n) % mesh.size
    if pad:
        x = torch.cat([x, x.new_zeros(pad, *x.shape[1:])])
    shards = x.chunk(mesh.size)
    return [s.to(d).contiguous() for s, d in zip(shards, mesh.devices)], n


def _check_shards(mesh: Mesh, shards: list[torch.Tensor]) -> None:
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")


def _gather(mesh: Mesh, shards: list[torch.Tensor]
            ) -> dict[torch.device, torch.Tensor]:
    """all_gather: the concatenated shards on each distinct device."""
    return {d: torch.cat([s.to(d) for s in shards])
            for d in mesh.distinct_devices}


def per_image_weights(z_local: torch.Tensor, bank: torch.Tensor,
                       reduce_mode: str, n_valid,
                       precision: str = "f32") -> torch.Tensor:
    """W rows [L, P] of the local images against the whole bank: the mean
    over the n_valid bank images ("mean", divided by n_valid - 1: the
    unsupervised W, self-term included) or their min ("min").  ``n_valid``
    is an int or a 0-d int64 CPU tensor; the padded bank rows are not
    computed (+inf)."""
    nv = count_tensor(n_valid, bank.shape[0])
    mins = min_dists_all_pairs(z_local, bank, precision=precision,
                               n_bank_valid=nv)  # [L, N_bank, P]
    if reduce_mode == "mean":
        valid = (torch.arange(bank.shape[0], device=bank.device)
                 < nv)[None, :, None]
        mins = torch.where(valid, mins, 0.0)
        return mins.sum(dim=1) / (nv - 1).clamp_min(1)
    return mins.amin(dim=1)


def _roll_rows(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``torch.roll(x, shift, dims=0)`` for a 0-d CPU tensor ``shift``: a
    gather, so that an exported program takes the shift as an input."""
    n = x.shape[0]
    return x.index_select(0, (torch.arange(n, device=x.device) - shift) % n)


def triangle_partial(z_local: torch.Tensor, bank: torch.Tensor, offset,
                     n_valid, precision: str = "f32") -> torch.Tensor:
    """One rank's share of the triangle-aware unsupervised weight sweep:
    its partial sums [N_pad, P] (not yet divided by n_valid - 1).

    The unsupervised distance matrix is symmetric at the tile level
    (mins[a, b] and mins[b, a] are the row- and col-mins of the same
    [P, Q] tile), so each rank sweeps a circulant window of the gathered
    ``bank`` [N_pad, P, D]: the rank at ``offset`` owns the rows
    a = offset + r and sweeps the columns b = (offset + 1 + w) mod N_pad
    for w < L - 1 + H, H = N_pad // 2, on the tiles of pair distance
    k = w - r + 1 in [1, H]: N_pad^2/(2 dp) tiles a rank, every unordered
    pair once (the k == H pair of an even N_pad is kept from the endpoint
    a < b).  Each tile's row-min adds to W[a] and its col-min to W[b]; the
    caller sums the ranks' partials (``tpu_ac``'s psum).  Pairs with a
    padded image (index >= n_valid) are left out.  ``offset`` and
    ``n_valid`` are ints or 0-d int64 CPU tensors: one exported program
    serves every rank and category size.
    """
    n_local, p, _ = z_local.shape
    n_pad = bank.shape[0]
    dev = z_local.device
    off = count_tensor(offset, 0)
    nv = count_tensor(n_valid, n_pad)
    h = n_pad // 2
    w_win = n_local - 1 + h
    b_glob = (off + 1 + torch.arange(w_win, device=dev)) % n_pad
    bank_w = bank.index_select(0, b_glob)

    # the rows and columns of valid images, on the host for the kernel's
    # pair list (a count on the card would make the host wait for it)
    row_valid = off + torch.arange(n_local) < nv
    col_valid = (off + 1 + torch.arange(w_win)) % n_pad < nv
    row_mins, col_mins = min_dists_window(z_local, bank_w, window=h,
                                          precision=precision,
                                          row_valid=row_valid,
                                          col_valid=col_valid)
    r = torch.arange(n_local, device=dev)[:, None]
    w = torch.arange(w_win, device=dev)[None, :]
    k = w - r + 1  # pair distance (b - a) mod n_pad
    a_glob = off + torch.arange(n_local, device=dev)
    ok = (k >= 1) & (k <= h)
    if n_pad % 2 == 0:
        # the k == H pair is swept from BOTH endpoints; keep the a < b copy
        ok &= (k < h) | (a_glob[:, None] < b_glob[None, :])
    ok &= (a_glob[:, None] < nv) & (b_glob[None, :] < nv)

    row_part = torch.where(ok[:, :, None], row_mins, 0.0).sum(dim=1)
    col_part = torch.where(ok.t()[:, :, None], col_mins, 0.0).sum(dim=1)
    # row_part[r] belongs to image offset + r, col_part[w] to image
    # (offset + 1 + w) mod n_pad
    return (_roll_rows(F.pad(row_part, (0, 0, 0, n_pad - n_local)), off)
            + _roll_rows(F.pad(col_part, (0, 0, 0, n_pad - w_win)),
                         off + 1))


def triangle_weights_local(z_local: torch.Tensor, bank: torch.Tensor,
                           rank: int, n_valid: int,
                           precision: str = "f32") -> torch.Tensor:
    """:func:`triangle_partial` of dp rank ``rank`` (offset rank * L)."""
    return triangle_partial(z_local, bank, rank * z_local.shape[0], n_valid,
                            precision)


def combine_partials(partials: list[torch.Tensor], home: torch.device,
                     n_valid) -> torch.Tensor:
    """W [N_pad, P] on ``home``: the ranks' triangle partials summed in
    rank order (``tpu_ac``'s psum) and divided by n_valid - 1."""
    total = partials[0].to(home)
    for part in partials[1:]:
        total = total + part.to(home)
    return total / (count_tensor(n_valid, 0) - 1).clamp_min(1)


def sharded_weight_distance_unsupervised(mesh: Mesh,
                                         Z_sharded: list[torch.Tensor],
                                         n_valid: int,
                                         precision: str = "f32",
                                         scheme: str = "triangle"
                                         ) -> list[torch.Tensor]:
    """Weight_Distance_Unsupervised with the image set sharded over dp.

    ``Z_sharded``: the per-position shards [L, P, D] of [N_pad, P, D]
    (``shard_batch``); ``n_valid`` real images (the padding rows are left
    out of the sums, and their own W rows are garbage the caller slices
    off).  Returns the W shards [L, P], one per position, on its device.

    ``scheme``: "triangle" (default) sweeps a balanced circulant window of
    about half the tiles a rank, through the window kernel, and sums the
    partials (:func:`triangle_weights_local`); "rect" sweeps the local rows
    against the whole bank on the rectangular kernel (2x the work, no sum
    across ranks).  At dp = 1 the window would exceed the bank, so
    "triangle" runs "rect".
    """
    if scheme not in ("triangle", "rect"):
        raise ValueError(f"scheme {scheme!r}; want 'triangle' or 'rect'")
    _check_shards(mesh, Z_sharded)
    if scheme == "triangle" and mesh.size == 1:
        scheme = "rect"
    banks = _gather(mesh, Z_sharded)
    if scheme == "rect":
        return [per_image_weights(z, banks[d], "mean", n_valid, precision)
                for z, d in zip(Z_sharded, mesh.devices)]
    partials = [triangle_weights_local(z, banks[d], rank, n_valid,
                                       precision)
                for rank, (z, d) in enumerate(zip(Z_sharded, mesh.devices))]
    wdist = combine_partials(partials, mesh.devices[0], n_valid)
    n_local = Z_sharded[0].shape[0]
    return [wdist[rank * n_local:(rank + 1) * n_local].to(d)
            for rank, d in enumerate(mesh.devices)]


def sharded_weight_distance_supervised(mesh: Mesh,
                                       Z_sharded: list[torch.Tensor],
                                       Z_train: torch.Tensor,
                                       precision: str = "f32"
                                       ) -> list[torch.Tensor]:
    """Supervised variant: the test images sharded over dp, the train bank
    replicated (read-only, typically small).  Returns the W shards."""
    _check_shards(mesh, Z_sharded)
    return [per_image_weights(z, bank, "min", Z_train.shape[0], precision)
            for z, bank in zip(Z_sharded, replicate(mesh, Z_train))]
