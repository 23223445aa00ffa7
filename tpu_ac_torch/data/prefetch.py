"""Parallel multi-crop augmentation + batch prefetch for training loops
(port of ``tpu_ac.data.prefetch``).

The reference feeds DINO through ``DataLoader(num_workers=10,
pin_memory=True)`` (dino-main/main_dino.py:147-154); without an
equivalent, the train step would wait on single-threaded PIL multi-crop
work every batch.  ``CropBatchPrefetcher`` is the host-side equivalent:

- a thread pool augments the batch's images concurrently (PIL's C ops —
  decode, resize, blur, affine — release the GIL, so threads scale
  without the multiprocessing serialization cost the reference pays);
- one batch of lookahead: batch i+1 is assembled while the train step
  consumes batch i, so host aug rides under device compute.

Determinism is per-image, not per-stream: each image draws from
``random.Random((seed, epoch, position))``, so the augmentation a sample
receives is independent of worker scheduling — stronger than the
reference's worker-order-dependent torch RNG streams.
"""

from __future__ import annotations

import gc
import multiprocessing
import os
import random
import signal
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch
from PIL import Image


def to_device(device: str | torch.device):
    """Host-to-device hook for the prefetchers: numpy -> pinned memory ->
    a ``non_blocking`` copy to ``device`` (the counterpart of
    ``jax.device_put``).  The copy is queued on the current stream of the
    calling thread, the default stream, so the step that receives the
    tensor reads it after it has landed; torch's pinned-memory allocator
    keeps the host buffer until then.  The calling thread makes
    ``device``'s card current for the copy: a loader thread's current
    card is card 0, whose context a rank on another card would otherwise
    create to pin the buffer."""
    dev = torch.device(device)

    def transfer(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if dev.type == "cpu":
            return t
        with torch.cuda.device(dev):
            return t.pin_memory().to(dev, non_blocking=True)

    return transfer


def _lookahead(head: ThreadPoolExecutor | None,
               thunks: Iterable[Callable[[], Any]]) -> Iterator[Any]:
    """Run thunks in submission order on the single ``head`` thread with
    ONE pending result — batch i+1 assembles while the caller consumes
    batch i.  ``head=None`` degrades to a plain serial map."""
    it = iter(thunks)
    if head is None:
        for thunk in it:
            yield thunk()
        return
    try:
        pending = head.submit(next(it))
    except StopIteration:
        return
    for thunk in it:
        nxt = head.submit(thunk)
        yield pending.result()
        pending = nxt
    yield pending.result()


def parallel_decode(items: Sequence, loader: Callable,
                    num_workers: int = 8) -> np.ndarray:
    """``np.stack([loader(x) for x in items])`` with a thread pool (PIL
    decode/resize release the GIL) — the reference's ``num_workers`` on
    its eval dataloaders (dino-main/eval_knn.py:48-61).  Deterministic:
    ``loader`` must be a pure function of its item (e.g. ``load_image``)."""
    if num_workers <= 0 or len(items) <= 1:
        return np.stack([loader(x) for x in items])
    with ThreadPoolExecutor(num_workers, "tpu_ac_torch-decode") as pool:
        return np.stack(list(pool.map(loader, items)))


class CropBatchPrefetcher:
    """Assembles (global_crops, local_crops) batch arrays in background.

    Args:
        get_image: index -> PIL image (e.g. ``lambda i: dataset[i][0]``).
        aug: a multi-crop callable ``aug(img, rng=...) -> [crops]``
            returning ``2 + n_local`` CHW arrays (DINOAugmentation).
        n_local: number of local crops ``aug`` emits after the 2 globals.
        num_workers: augmentation threads (0 = fully serial, no lookahead).
        seed: determinism base for the per-image rng keys.
        transfer: optional host-to-device hook (``to_device``: a pinned,
            ``non_blocking`` upload) applied to the assembled arrays
            INSIDE the lookahead thread when ``num_workers > 0``, so the
            host-side copy into pinned memory rides under the previous
            step instead of stalling the dispatch thread.  With
            ``num_workers=0`` there is no lookahead thread and the
            transfer runs on the dispatch thread.
    """

    def __init__(self, get_image: Callable, aug: Callable, n_local: int,
                 *, num_workers: int = 8, seed: int = 0,
                 transfer: Callable | None = None):
        self.get_image = get_image
        self.aug = aug
        self.n_local = n_local
        self.num_workers = num_workers
        self.seed = seed
        self.transfer = transfer
        self._pool = (ThreadPoolExecutor(num_workers, "tpu_ac_torch-aug")
                      if num_workers > 0 else None)
        self._head = (ThreadPoolExecutor(1, "tpu_ac_torch-prefetch")
                      if num_workers > 0 else None)

    def _crops_for(self, epoch: int, position: int, index: int):
        # string keys hash via sha512 (process-stable); tuples are not a
        # supported random.Random seed type
        rng = random.Random(f"{self.seed}/{epoch}/{position}")
        return self.aug(self.get_image(index), rng=rng)

    def _assemble(self, epoch: int, start: int, idxs: Sequence[int]):
        args = [(epoch, start + k, int(j)) for k, j in enumerate(idxs)]
        if self._pool is None:
            crops = [self._crops_for(*a) for a in args]
        else:
            crops = list(self._pool.map(lambda a: self._crops_for(*a), args))
        g = np.concatenate([np.stack([c[0] for c in crops]),
                            np.stack([c[1] for c in crops])])
        l = (np.concatenate([np.stack([c[2 + k] for c in crops])
                             for k in range(self.n_local)])
             if self.n_local else None)
        if self.transfer is not None:
            g = self.transfer(g)
            l = self.transfer(l) if l is not None else None
        return g, l

    def batches(self, epoch: int, idx_batches: Iterable[Sequence[int]]
                ) -> Iterator[tuple[np.ndarray, np.ndarray | None]]:
        """Yield assembled (g, l) arrays with one batch of lookahead."""
        def thunks():
            pos = 0
            for idxs in idx_batches:
                yield (lambda idxs=idxs, pos=pos:
                       self._assemble(epoch, pos, idxs))
                pos += len(idxs)
        yield from _lookahead(self._head, thunks())

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
        if self._head is not None:
            self._head.shutdown(wait=False, cancel_futures=True)


class BaseImagePrefetcher:
    """Square uint8 base-image batches for the device-side aug path
    (``cli.dino --device_aug``): the host only decodes + square-resizes
    each image (``device_aug.load_base_image``); all crop work happens on
    the card.  Same pool + one-batch-lookahead structure as
    :class:`CropBatchPrefetcher`; yields ``[B, 3, base, base]`` uint8
    (device tensors when ``transfer`` is set)."""

    def __init__(self, get_image: Callable, base_size: int, *,
                 num_workers: int = 8, transfer: Callable | None = None):
        from tpu_ac_torch.data.device_aug import load_base_image

        self.get_image = get_image
        self.base_size = base_size
        self.transfer = transfer
        self._load = lambda i: load_base_image(get_image(int(i)),
                                               base_size)
        self._pool = (ThreadPoolExecutor(num_workers, "tpu_ac_torch-decode")
                      if num_workers > 0 else None)
        self._head = (ThreadPoolExecutor(1, "tpu_ac_torch-prefetch")
                      if num_workers > 0 else None)

    def _assemble(self, idxs: Sequence[int]):
        if self._pool is None:
            batch = np.stack([self._load(i) for i in idxs])
        else:
            batch = np.stack(list(self._pool.map(self._load, idxs)))
        return self.transfer(batch) if self.transfer is not None else batch

    def batches(self, epoch: int, idx_batches: Iterable[Sequence[int]]
                ) -> Iterator[np.ndarray]:
        del epoch  # no per-epoch rng: the aug randomness lives on device

        def thunks():
            for idxs in idx_batches:
                yield lambda idxs=idxs: self._assemble(idxs)
        yield from _lookahead(self._head, thunks())

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
        if self._head is not None:
            self._head.shutdown(wait=False, cancel_futures=True)


def _worker_context():
    """The forkserver context, its server preloaded with this module and
    the program's main module: the server is a fresh process (no threads,
    no CUDA), imports those once, and forks each worker from itself, so a
    worker starts with torch and the transforms already imported.  A
    spawned worker would import the main module anew (seconds of imports
    for ``cli.scan``, each of 8 workers at once)."""
    ctx = multiprocessing.get_context("forkserver")
    main = sys.modules.get("__main__")
    name = getattr(getattr(main, "__spec__", None), "name", None)
    if name is None:  # a script: the server imports it as __main__
        name = "__main__" if getattr(main, "__file__", None) else None
    elif name.endswith(".__main__"):  # a package's __main__ (pytest)
        name = None
    ctx.set_forkserver_preload([__name__] + ([name] if name else []))
    return ctx


# worker pools of this process that are open, and the lock over the count:
# the last one to close stops the servers that the pools share
_OPEN_POOLS = 0
_OPEN_LOCK = threading.Lock()


def _open_pool(num_workers: int):
    global _OPEN_POOLS
    pool = _worker_context().Pool(num_workers)
    with _OPEN_LOCK:
        _OPEN_POOLS += 1
    return pool


def _stop_servers() -> None:
    """End the two helper processes that the forkserver context starts
    beside the workers, so that no process outlives the last pool's
    ``close``: the forkserver, which would otherwise exit only after this
    process has, and then outlive it while it tears down the torch it
    preloaded; and the resource tracker.  The server holds no state once
    the workers have ended, so it is terminated; the tracker stops when
    its pipe closes, after the pools' semaphores have unregistered
    themselves (``gc.collect`` runs their finalizers).  The next pool
    starts both anew.  Neither has a public stop; these are the calls
    CPython's own multiprocessing tests use."""
    from multiprocessing import forkserver, resource_tracker

    gc.collect()
    server = forkserver._forkserver
    if server._forkserver_pid is not None:
        os.kill(server._forkserver_pid, signal.SIGTERM)
    server._stop()
    tracker = resource_tracker._resource_tracker
    # a spawned process holds only its parent's tracker's pipe (no pid):
    # the parent stops that tracker
    if tracker._pid is not None:
        tracker._stop()


def _augment_chunk(aug: Callable, arrays: Sequence[np.ndarray],
                   keys: Sequence) -> np.ndarray:
    """A worker's share of ``ParallelAugPool.stack``: ``aug`` over the
    images (uint8 arrays, RGB or L, back to PIL here), each with the rng of
    its key (None: a transform that takes no rng)."""
    out = []
    for a, key in zip(arrays, keys):
        img = Image.fromarray(a)
        out.append(aug(img) if key is None
                   else aug(img, rng=random.Random(key)))
    return np.stack(out)


class ParallelAugPool:
    """Deterministic parallel augmentation for single-crop transform loops
    (the reference's ``DataLoader(num_workers=8)`` role in the SCAN
    stages, Unsupervised-Classification-master/configs/env.yml +
    common_config.py get_train_dataloader).

    ``stack`` maps ``aug(img, rng=...)`` over a batch of dataset indices
    and stacks the results; each image draws from
    ``random.Random(f"{seed}/{stream}/{epoch}/{position}")``, so the
    output is independent of the workers (bit-equal to ``tpu_ac``'s pool
    and to the serial loop).  ``lookahead`` overlaps whole-batch assembly
    with the caller's consume (train step) via one background thread.
    ``num_workers=0`` degrades to the serial loop.

    The workers are processes (forked from a clean forkserver, see
    ``_worker_context``), as the reference's DataLoader's are, where
    ``tpu_ac``'s are threads: at SCAN's 32 px every PIL op is short, so a
    thread holds the interpreter lock for most of an image, and 8 threads
    run slower than one (chip_smoke.py's SCAN phase times the three).  The
    batch's images go to the workers as uint8 arrays (RGB or L: the
    classification datasets' images) in ``num_workers`` chunks, and the
    arrays come back in order.  The workers start on the lookahead thread,
    so the caller's own set-up overlaps their start.
    """

    def __init__(self, num_workers: int = 8, seed: int = 0):
        self.num_workers = num_workers
        self.seed = seed
        self._head = (ThreadPoolExecutor(1, "tpu_ac_torch-prefetch")
                      if num_workers > 0 else None)
        self._pool = (self._head.submit(_open_pool, num_workers)
                      if num_workers > 0 else None)

    def stack(self, aug: Callable, get_image: Callable,
              idxs: Sequence[int], *, epoch: int = 0, start: int = 0,
              stream: str = "", keyed: bool = True) -> np.ndarray:
        """np.stack([aug(get_image(i)) for i in idxs]), on the workers.

        ``keyed=True`` passes a per-position private rng to ``aug``;
        ``keyed=False`` is for deterministic transforms (ValTransform)
        that take no rng argument.  ``aug`` must pickle (a module-level
        function or a transform object).
        """
        # uint8 arrays pickle at a fraction of a PIL image's cost
        images = [np.asarray(get_image(int(i))) for i in idxs]
        keys = [f"{self.seed}/{stream}/{epoch}/{start + k}" if keyed
                else None for k in range(len(images))]
        if self._pool is None or len(images) < 2:
            return _augment_chunk(aug, images, keys)
        cuts = np.linspace(0, len(images),
                           min(self.num_workers, len(images)) + 1).astype(int)
        pool = self._pool.result()
        parts = [pool.apply_async(_augment_chunk,
                                  (aug, images[a:b], keys[a:b]))
                 for a, b in zip(cuts[:-1], cuts[1:])]
        return np.concatenate([r.get() for r in parts])

    def lookahead(self, thunks: Iterable[Callable[[], Any]]
                  ) -> Iterator[Any]:
        yield from _lookahead(self._head, thunks)

    def close(self) -> None:
        """Stop the workers: each process has ended when this returns, and
        after the last open pool's close, the forkserver and the resource
        tracker too (``_stop_servers``).  The workers hold no state, so
        they are terminated, not drained."""
        global _OPEN_POOLS
        if self._head is not None:
            self._head.shutdown(wait=True, cancel_futures=True)
        future, self._pool = self._pool, None
        if future is None or future.cancelled():
            return
        pool = future.result()
        del future
        pool.terminate()
        pool.join()
        del pool
        with _OPEN_LOCK:
            _OPEN_POOLS -= 1
            if _OPEN_POOLS == 0:
                _stop_servers()
