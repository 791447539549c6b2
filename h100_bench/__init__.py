"""The H100 benchmark of `racformer_tpu_torch` (see `run.py`)."""
