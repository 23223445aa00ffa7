"""Metric logging (port of ``tpu_ac.utils.logging``).

``SmoothedValue`` and ``MetricLogger`` are the reference's
(dino-main/utils.py:224-400); ``LaggedFetch`` resolves each step's device
scalars one step late, so the device-to-host copy rides under the next
step; ``StepTimer`` times host steps and reads the card's peak memory.
"""

from __future__ import annotations

import collections
import datetime
import time
from collections.abc import Iterable

import numpy as np
import torch


class SmoothedValue:
    """Windowed + global average tracker (dino-main/utils.py:224-273).

    In a ``torch.distributed`` run, ``synchronize_between_processes``
    all-reduces count and total.
    """

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.6f} ({global_avg:.6f})"):
        self.deque: collections.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self) -> None:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return
        t = torch.tensor([self.count, self.total], dtype=torch.float64)
        if dist.get_backend() == "nccl":
            t = t.cuda()
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(1, self.count)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Iteration logger (dino-main/utils.py:276-400)."""

    def __init__(self, delimiter: str = "  ", printer=print):
        self.meters: dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter
        self.printer = printer
        # seconds the consumer waited for each item of log_every
        self.data_time = SmoothedValue(fmt="{avg:.6f}")

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        # __dict__ directly: during unpickling/deepcopy this runs before
        # __init__ populated the instance
        meters = self.__dict__.get("meters")
        if meters is not None and attr in meters:
            return meters[attr]
        raise AttributeError(attr)

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = ""):
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.6f}")
        data_time = self.data_time
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                eta = ""
                if total:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                self.printer(
                    f"{header} [{i}{'/' + str(total) if total else ''}]  "
                    f"{eta}{self}  time: {iter_time}  data: {data_time}")
            i += 1
            end = time.time()
        self.printer(
            f"{header} Total time: "
            f"{datetime.timedelta(seconds=int(time.time() - start))}")


class LaggedFetch:
    """One-step-lagged resolution of per-step device scalars.

    ``float(metrics["loss"])`` right after a step's dispatch would make
    the host wait for the card to finish the step.  ``push`` starts a
    ``non_blocking`` copy of each CUDA tensor of ``tree`` (a flat dict)
    into pinned host memory and records a CUDA event, then hands the
    PREVIOUS push's values to ``consume``: its copy has long landed, so
    the host never waits for the step it just queued.  ``flush`` resolves
    the last push at loop end.
    """

    def __init__(self, consume):
        self._consume = consume
        self._pending = None

    def push(self, tree: dict) -> None:
        host, event = {}, None
        for k, v in tree.items():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                # a non_blocking copy to the CPU lands in pinned memory
                host[k] = v.detach().to("cpu", non_blocking=True)
                if event is None:
                    event = torch.cuda.Event()
            else:
                host[k] = v
        if event is not None:
            event.record()
        if self._pending is not None:
            self._resolve()
        self._pending = (host, event)

    def _resolve(self) -> None:
        host, event = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        self._consume(host)

    def flush(self) -> None:
        if self._pending is not None:
            self._resolve()


class StepTimer:
    """Host step time, and the card's peak memory."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @staticmethod
    def device_memory_mb() -> float | None:
        """Peak memory torch allocated on the current card, or None
        without one."""
        if not torch.cuda.is_available():
            return None
        return torch.cuda.max_memory_allocated() / 1e6

    @staticmethod
    def trace(log_dir: str):
        """Context manager: a torch.profiler chrome trace into
        ``log_dir``."""
        from tpu_ac_torch.utils.profiling import maybe_profile

        return maybe_profile(log_dir)
