"""Logging and observability of the training driver (port of
`racformer_tpu/utils/`)."""

from .logging import MetricLogger, backup_code, init_logging
from .precision import pin_float32_precision
