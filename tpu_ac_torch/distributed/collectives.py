"""The collectives of the training steps across processes, on the default
``torch.distributed`` group.

``tpu_ac`` needs none: its steps are jitted over global arrays, and XLA
inserts the reductions (gradient sums, batch statistics, loss means) that
the sharding implies.  Here each process holds its shard of the batch, and
the steps call these functions where a value spans the global batch.

Every collective is built from ``all_reduce`` and ``broadcast``: on CUDA
tensors gloo supports only those two, and ranks that share one card run
over gloo (NCCL refuses two ranks on one GPU).  Without a group, or in a
group of one process, every function returns its input untouched, so a
single-process run computes what it computed before these existed.
Every rank must make the same calls in the same order.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

from tpu_ac_torch.distributed.mesh import process_count, process_index


def all_reduce_dict(tensors: Mapping[str, torch.Tensor], op: str = "mean"
                    ) -> Mapping[str, torch.Tensor]:
    """The sum or mean over ranks of each tensor of a flat dict (one
    dtype), in one flattened bucket: one ``all_reduce`` a call, not one a
    tensor.  Returns new tensors; not differentiable."""
    if op not in ("mean", "sum"):
        raise ValueError(f"op {op!r}; want 'mean' or 'sum'")
    w = process_count()
    if w == 1:
        return tensors
    names = list(tensors)
    dtypes = {tensors[k].dtype for k in names}
    if len(dtypes) != 1:
        raise TypeError("one bucket needs one dtype; got "
                        f"{sorted(map(str, dtypes))}")
    flat = torch.cat([tensors[k].detach().reshape(-1) for k in names])
    dist.all_reduce(flat)
    if op == "mean":
        flat.div_(w)
    pieces = torch.split(flat, [tensors[k].numel() for k in names])
    return {k: p.view(tensors[k].shape) for k, p in zip(names, pieces)}


class _AllReduceSum(torch.autograd.Function):
    """y = the sum over ranks of x; the gradient of x is the sum over ranks
    of y's gradients (each rank's loss depends on every rank's x)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``x``, differentiable (see ``_AllReduceSum``)."""
    return _AllReduceSum.apply(x) if process_count() > 1 else x


def global_mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The mean of ``x`` over ``dim`` of the global batch (each rank holds
    an equal share of it), differentiable: the sums all-reduced and
    divided by the global count.  ``torch.mean`` in one process."""
    w = process_count()
    if w == 1:
        return torch.mean(x, dim=dim)
    return all_reduce_sum(torch.sum(x, dim=dim)) / (x.shape[dim] * w)


class _AllGather(torch.autograd.Function):
    """[n, ...] on each rank -> [W n, ...], rank r's rows at r n: an
    all_reduce of a zero buffer that holds the rank's rows (a sum with
    zeros is exact).  The backward returns each rank its slice of the sum
    over ranks of the gathered gradients."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        w, r, n = process_count(), process_index(), x.shape[0]
        ctx.rows = (r * n, (r + 1) * n)
        buf = x.new_zeros((w * n, *x.shape[1:]))
        buf[r * n:(r + 1) * n] = x
        dist.all_reduce(buf)
        return buf

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone()
        dist.all_reduce(g)
        a, b = ctx.rows
        return g[a:b]


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) stacked along dim 0 in
    rank order, differentiable (see ``_AllGather``)."""
    return _AllGather.apply(x) if process_count() > 1 else x


def broadcast_(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``x`` overwritten, in place, by rank ``src``'s."""
    if process_count() > 1:
        dist.broadcast(x, src)
    return x


def check_same_on_ranks(tensors: Mapping[str, torch.Tensor],
                        what: str) -> None:
    """Raise on every rank unless each tensor holds rank 0's values: each
    rank's float64 sum and sum of squares per tensor against rank 0's,
    broadcast (a checksum: the state is not sent)."""
    if process_count() == 1:
        return
    names = sorted(tensors)
    sums = torch.stack([s for k in names for s in (
        tensors[k].double().sum(), tensors[k].double().square().sum())])
    ref = broadcast_(sums.clone())
    bad = (sums != ref).any().to(torch.float64).reshape(1)
    dist.all_reduce(bad)
    if float(bad) > 0:
        raise RuntimeError(
            f"{what} differs between the ranks ({int(float(bad))} of "
            f"{process_count()} differ from rank 0's checksum)")
