"""Shared batch collation: stack array fields, list string metadata.

One implementation for every dataset's `batch()` and the PrefetchLoader
(previously triplicated; the copies had drifted on which keys count as
metadata — any non-array value is metadata here, so new string fields like
`scene` collate correctly everywhere).

A copy of `racformer_tpu/data/collate.py` (the port imports nothing of the
JAX package); `tests/test_torch_data.py` holds the copy equal to its
original.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def collate(samples: List[Dict]) -> Dict:
    out = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, (str, bytes)) or v0 is None:
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
    return out
