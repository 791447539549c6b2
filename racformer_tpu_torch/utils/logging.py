"""Logging / observability: console logger with iteration timing + ETA,
TensorBoard scalars (when TensorBoard is installed), and a JSONL metrics
stream.

A copy of `racformer_tpu/utils/logging.py` (the port imports nothing of the
JAX package): one `MetricLogger` object the training loop calls per step,
the counterpart of the reference's text and TensorBoard logger hooks.
`backup_code` copies the port's own sources, its CUDA kernels included.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional


def init_logging(work_dir: Optional[str] = None, rank: int = 0) -> logging.Logger:
    """Root logger setup (console + optional file), mirroring `init_logging`
    (`utils.py:14-25`); non-zero ranks are silenced like `train.py:83-86`."""
    logger = logging.getLogger("racformer_tpu_torch")
    logger.setLevel(logging.INFO if rank == 0 else logging.ERROR)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if work_dir and rank == 0:
        os.makedirs(work_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(work_dir, "train.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp")


def backup_code(work_dir: str, src_root: Optional[str] = None) -> None:
    """Copy the port's sources (Python and the kernels' CUDA / C++) into
    work_dir/backup, so every run records the exact code it ran with."""
    import shutil

    src_root = src_root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(work_dir, "backup")
    for dirpath, _, files in os.walk(src_root):
        if "__pycache__" in dirpath:
            continue
        for fn in files:
            if fn.endswith(SOURCE_SUFFIXES):
                rel = os.path.relpath(os.path.join(dirpath, fn), src_root)
                out = os.path.join(dst, rel)
                os.makedirs(os.path.dirname(out), exist_ok=True)
                shutil.copy2(os.path.join(dirpath, fn), out)


class MetricLogger:
    def __init__(self, work_dir: Optional[str] = None, total_steps: int = 0,
                 log_interval: int = 50, tb_interval: int = 500, rank: int = 0):
        self.logger = init_logging(work_dir, rank)
        self.total_steps = total_steps
        self.log_interval = log_interval
        self.tb_interval = tb_interval
        self.rank = rank
        self._t0 = time.time()
        self._last = self._t0
        self._last_step = None
        self._tb = None
        self._jsonl = None
        if work_dir and rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(work_dir, "tb"))
            except Exception:  # tensorboard optional
                self._tb = None
            self._jsonl = open(os.path.join(work_dir, "metrics.jsonl"), "a")

    def log_step(self, step: int, metrics: Dict[str, float], lr: float = None):
        if self.rank != 0:
            return
        if step % self.log_interval == 0:
            now = time.time()
            n_steps = (step - self._last_step) if self._last_step is not None else 1
            it_time = (now - self._last) / max(n_steps, 1)
            self._last = now
            self._last_step = step
            eta = (self.total_steps - step) * it_time if self.total_steps else 0
            parts = [f"step {step}"]
            if lr is not None:
                parts.append(f"lr {lr:.2e}")
            parts.append(f"{it_time:.2f}s/it")
            parts.append(f"eta {eta/3600:.1f}h")
            for k in ("loss_total", "loss_cls", "loss_bbox", "loss_depth", "grad_norm"):
                if k in metrics:
                    parts.append(f"{k} {float(metrics[k]):.4f}")
            self.logger.info("  ".join(parts))
        if self._jsonl and step % self.log_interval == 0:
            rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb and step % self.tb_interval == 0:
            for k, v in metrics.items():
                self._tb.add_scalar(f"train/{k}", float(v), step)
            if lr is not None:
                self._tb.add_scalar("train/lr", lr, step)

    def log_eval(self, step: int, metrics: Dict[str, float]):
        if self.rank != 0:
            return
        self.logger.info("eval @ %d: %s", step,
                         "  ".join(f"{k} {v:.4f}" for k, v in metrics.items()))
        if self._jsonl:
            rec = {"step": step, "phase": "val",
                   **{k: float(v) for k, v in metrics.items()}}
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in metrics.items():
                self._tb.add_scalar(f"val/{k}", float(v), step)

    def close(self):
        """Close the metrics stream, TensorBoard and the log file."""
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb:
            self._tb.close()
            self._tb = None
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)
