"""Asynchronous host input pipeline (a copy of
`racformer_tpu/data/prefetch.py`; the port imports nothing of the JAX
package).

A thread-pool prefetcher: sample loading (JPEG decode, radar rasterization,
augmentation; GIL-releasing or numpy-bound) runs in worker threads, whole
batches are assembled ahead of time into a bounded queue, and an optional
`put` callback moves batch k+1 onto the device while step k runs (the
train driver's `to_device`: pinned host memory, non-blocking copies on the
default stream, so they are ordered before the step that reads them).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence


class PrefetchLoader:
    """Iterates fixed-size batches of `dataset` in the order given by
    `index_fn(step) -> list[int]`, keeping up to `prefetch` prepared batches
    in flight.

    Args:
      dataset: object with `__getitem__` returning a dict of arrays.
      index_fn: step -> list of sample indices for that step's local batch.
      total_steps: number of batches to produce.
      num_workers: sample-loading threads (reference: 4 workers per GPU).
      prefetch: bound on prepared-but-unconsumed batches.
      put: optional callback(host_batch) -> device_batch, run in the
        assembler thread so the host-to-device copy of batch k+1 is issued
        while step k runs.
    """

    def __init__(
        self,
        dataset,
        index_fn: Callable[[int], Sequence[int]],
        total_steps: int,
        start_step: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
        put: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.index_fn = index_fn
        self.total_steps = total_steps
        self.start_step = start_step
        self.put = put
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
        self._stop = threading.Event()
        self._err = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _collate(self, samples):
        from .collate import collate

        return collate(samples)

    def _produce(self):
        try:
            for step in range(self.start_step, self.total_steps):
                if self._stop.is_set():
                    return
                idxs = list(self.index_fn(step))
                samples = list(self._pool.map(self.dataset.__getitem__, idxs))
                batch = self._collate(samples)
                if self.put is not None:
                    batch = self.put(batch)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surface worker errors to the consumer
            self._err = e
            self._q.put((None, None))
        finally:
            self._pool.shutdown(wait=False)

    def get(self, expected_step: int):
        step, batch = self._q.get()
        # only the sentinel carries the worker's error: a batch queued
        # before the failure is still returned at its own step
        if step is None:
            raise self._err
        if step != expected_step:
            raise RuntimeError(f"prefetch out of sync: got {step}, want {expected_step}")
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
