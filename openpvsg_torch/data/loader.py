"""Prefetching batch loader, the port of ``openpvsg_tpu/data/loader.py``.

Replaces the reference's fork-based mmcv dataloader workers with a thread
pool: ``make_sample`` decodes and preprocesses samples concurrently (PIL's
zlib decode and torch's CPU ops release the GIL) while the device runs the
previous batch.

An exception raised by ``make_sample`` or ``collate`` propagates to the
consuming iterator (the training loop) instead of killing the producer
thread: a corrupt PNG raises, it does not deadlock the run. Short batches
(from ``None`` samples being filtered out) are padded by cycling through the
valid samples, so every batch has the same shape, with a logged warning.
"""
from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence

logger = logging.getLogger(__name__)

_END = ("end", None)


class PrefetchLoader:
    def __init__(self, make_sample: Callable[[int], Optional[dict]],
                 order: Sequence[int], batch_size: int,
                 collate: Callable[[List[dict]], dict],
                 num_workers: int = 4, prefetch_batches: int = 2,
                 drop_last: bool = True):
        self.make_sample = make_sample
        self.order = list(order)
        self.batch_size = batch_size
        self.collate = collate
        self.num_workers = max(num_workers, 1)
        self.prefetch = max(prefetch_batches, 1)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.order) // self.batch_size
        if not self.drop_last and len(self.order) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # never block forever: the consumer may have abandoned the
            # iterator (stop set in its finally) with the queue full
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            warned_pad = False
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    step = self.batch_size
                    end = (len(self.order) - step + 1) if self.drop_last \
                        else len(self.order)
                    for lo in range(0, max(end, 0), step):
                        if stop.is_set():
                            return
                        idxs = self.order[lo:lo + step]
                        samples = [s for s in
                                   pool.map(self.make_sample, idxs)
                                   if s is not None]
                        if not samples:
                            logger.warning(
                                "PrefetchLoader: all %d samples of a batch "
                                "were None — batch skipped", len(idxs))
                            continue
                        if len(samples) < step and not warned_pad:
                            warned_pad = True
                            logger.warning(
                                "PrefetchLoader: short batch (%d/%d valid "
                                "samples) padded by repeating samples — "
                                "training distribution is skewed if this "
                                "is frequent", len(samples), step)
                        n_valid = len(samples)
                        while len(samples) < step:
                            # cycle through the valid samples rather than
                            # repeating the first one
                            samples.append(samples[len(samples) % n_valid])
                        if not put(("batch", self.collate(samples))):
                            return
                put(_END)
            except BaseException as e:  # propagate to the consumer
                put(("error", e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "error":
                    raise payload
                if kind == "end":
                    return
                yield payload
        finally:
            stop.set()
