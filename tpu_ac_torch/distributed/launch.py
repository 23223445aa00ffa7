"""Job launch / elastic-recovery utilities (port of
``tpu_ac.distributed.launch``, the run_with_submitit equivalent).

The reference submits DINO to SLURM with automatic requeue on preemption
(dino-main/run_with_submitit.py:58-126).  Jobs here get the same
durability from atomic checkpoints (``tpu_ac_torch.utils.checkpoint``),
resume-if-exists entry points, and this launcher, which supervises a
training callable and relaunches it on crash or preemption with bounded
retries.  No collective and no device: one supervisor a host.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from typing import Callable


@dataclasses.dataclass
class LaunchConfig:
    max_restarts: int = 10
    restart_delay_s: float = 10.0
    # exceptions that should NOT trigger a restart (bad config, user abort)
    fatal_exceptions: tuple = (KeyboardInterrupt, SystemExit)


def run_with_requeue(train_fn: Callable[[], object],
                     config: LaunchConfig = LaunchConfig(),
                     on_restart: Callable[[int, BaseException], None] | None
                     = None):
    """Run ``train_fn`` until success, restarting on transient failures.

    ``train_fn`` must be resume-safe: on entry it loads the latest
    checkpoint and continues (every tpu_ac_torch trainer CLI does).
    Mirrors the submitit requeue loop with the SLURM controller replaced by
    in-process supervision.
    """
    attempt = 0
    while True:
        try:
            return train_fn()
        except config.fatal_exceptions:
            raise
        except BaseException as e:  # noqa: BLE001 — supervisor boundary
            attempt += 1
            if attempt > config.max_restarts:
                raise RuntimeError(
                    f"training failed after {config.max_restarts} restarts"
                ) from e
            traceback.print_exc()
            if on_restart is not None:
                on_restart(attempt, e)
            print(f"[launch] restart {attempt}/{config.max_restarts} in "
                  f"{config.restart_delay_s}s", flush=True)
            time.sleep(config.restart_delay_s)
