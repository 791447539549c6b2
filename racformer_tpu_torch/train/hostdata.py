"""Per-epoch batch order (a copy of `epoch_order` and `host_batch_indices`
of `racformer_tpu/train/hostdata.py`; the port imports nothing of the JAX
package, and `tests/test_torch_train_driver.py` holds the copies equal).

The train driver draws a fresh permutation of the dataset every epoch from
(seed, epoch) and takes each step's batch from it; with several processes
each loads its own rows of the global batch.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """Per-epoch dataset permutation, derived purely from (seed, epoch):
    every process computes the same order, and re-deriving epoch e's order
    after a restart yields the permutation the interrupted run used."""
    return np.random.default_rng((int(seed), int(epoch))).permutation(n)


def host_batch_indices(
    order: Sequence[int],
    step: int,
    global_batch: int,
    n_proc: int,
    proc_idx: int,
) -> list:
    """Dataset indices this process loads for `step`.

    The union over proc_idx in [0, n_proc) is exactly the contiguous window
    `order[step*global_batch : (step+1)*global_batch]` (wrapping), disjoint
    across processes and ordered so process p holds global batch rows
    [p*local, (p+1)*local).
    """
    if global_batch % n_proc:
        raise ValueError(f"global_batch {global_batch} not divisible by "
                         f"process_count {n_proc}")
    local = global_batch // n_proc
    off = proc_idx * local
    n = len(order)
    return [int(order[(step * global_batch + off + i) % n])
            for i in range(local)]
