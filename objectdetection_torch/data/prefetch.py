"""Host-side batch prefetcher: overlap data assembly with device steps.

Port of ``objectdetection_tpu.data.prefetch``: any batch-producing callable
runs on a bounded background-thread queue, so that the next batch
rasterizes while the current step runs on the card. The callable returns
host (numpy) arrays and must make no CUDA call: the training loop copies
each batch to the device on its own thread. A CUDA call from a new thread
costs several times the host time of one from a long-lived thread, and the
port's ``functional_call`` swaps tensors into a module shared per config,
which two threads must not do at once.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class Prefetcher:
    """Pulls batches from `make_batch(step)` on a worker thread.

    Usage:
        pf = Prefetcher(lambda step: ds.load_batch(ids(step), cfg), depth=2)
        for step in range(n):
            batch = pf.get()
        pf.close()
    """

    _SENTINEL = object()

    def __init__(
        self,
        make_batch: Callable[[int], object],
        num_steps: Optional[int] = None,
        depth: int = 2,
    ):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = False
        self._make = make_batch
        self._num_steps = num_steps
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = 0
        try:
            while not self._stop.is_set():
                if self._num_steps is not None and step >= self._num_steps:
                    break
                batch = self._make(step)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1
        except BaseException as e:  # surfaced on next get()
            self._error = e
        finally:
            # the sentinel must not be dropped when the queue is full — keep
            # trying until delivered or the prefetcher is closed
            while not self._stop.is_set():
                try:
                    self._q.put(self._SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self, timeout: float = 300.0):
        if self._done:  # repeated get() after exhaustion: fail fast
            if self._error is not None:
                raise self._error
            raise StopIteration
        item = self._q.get(timeout=timeout)
        if item is self._SENTINEL:
            self._done = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def __iter__(self) -> Iterator:
        while True:
            try:
                yield self.get()
            except StopIteration:
                return

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
