"""Training checkpoints as torch files, verified on write, rotated, resumable
(the counterpart of `racformer_tpu/train/checkpoint.py`, which writes orbax
checkpoints).

Layout: `<work_dir>/checkpoints/<step>/state.pth`, one file per step, with
    {"step": int, "model": the model's state dict (parameters and BatchNorm
     statistics), "optimizer": `Optimizer.state_dict()` (AdamW's state and
     the update count), "ema": {name: f32 tensor}, present when the run
     keeps an EMA of its parameters}.

Each write goes to a temporary name and is then renamed into place. With
several ranks the train driver saves on rank 0 alone (the state is equal on
every rank) and every rank restores. With
`verify`, the file is read back (`weights_only=True`) and a SHA-256 over
every tensor's bytes, in key order, is compared with the digest of what was
written; a mismatch deletes the file and writes it again, `retries` times in
all, then raises (the reference's verify-and-retry checkpoint hook).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time
from typing import Dict, Optional

import torch

STATE_FILE = "state.pth"


def tree_digest(tree) -> str:
    """SHA-256 over a nested dict / list of tensors and scalars, in key
    order: each key, each tensor's dtype, shape and bytes, each scalar's
    repr."""
    h = hashlib.sha256()

    def walk(node):
        if isinstance(node, dict):
            for k, v in node.items():
                h.update(repr(k).encode())
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif torch.is_tensor(node):
            t = node.detach().cpu().contiguous().reshape(-1)
            h.update(f"{t.dtype}{tuple(node.shape)}".encode())
            h.update(t.view(torch.uint8).numpy())
        else:
            h.update(repr(node).encode())

    walk(tree)
    return h.hexdigest()


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


def snapshot(step: int, model: torch.nn.Module, optimizer=None,
             ema: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """The checkpoint's content, on the host."""
    state = {"step": int(step), "model": _cpu(model.state_dict())}
    if optimizer is not None:
        state["optimizer"] = _cpu(optimizer.state_dict())
    if ema is not None:
        state["ema"] = _cpu(dict(ema))
    return state


def _write(state: Dict, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def _read(path: str, map_location="cpu") -> Dict:
    return torch.load(path, map_location=map_location, weights_only=True)


def checkpoint_steps(work_dir: str) -> list:
    """The steps with a checkpoint file under `work_dir`, oldest first."""
    root = os.path.join(work_dir, "checkpoints")
    if not os.path.isdir(root):
        return []
    return sorted(int(d) for d in os.listdir(root)
                  if d.isdigit() and os.path.isfile(
                      os.path.join(root, d, STATE_FILE)))


class CheckpointManager:
    def __init__(self, work_dir: str, max_keep: int = 4, verify: bool = True,
                 retries: int = 3):
        self.work_dir = os.path.abspath(work_dir)
        self.dir = os.path.join(self.work_dir, "checkpoints")
        os.makedirs(self.dir, exist_ok=True)
        self.max_keep = max_keep
        self.verify = verify
        self.retries = retries
        self.last_save: Optional[Dict] = None  # what the last save did
        self.restored_digest: Optional[str] = None

    def path(self, step: int) -> str:
        return os.path.join(self.dir, str(step), STATE_FILE)

    def latest_step(self) -> Optional[int]:
        steps = checkpoint_steps(self.work_dir)
        return steps[-1] if steps else None

    def save(self, step: int, model: torch.nn.Module, optimizer=None,
             ema: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        """Write step's checkpoint (verified when `verify`), then drop all
        but the newest `max_keep`. Returns {step, digest, bytes, seconds,
        attempts, verified}."""
        t0 = time.perf_counter()
        state = snapshot(step, model, optimizer, ema)
        digest = tree_digest(state)
        path = self.path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        verified = False
        for attempt in range(1, self.retries + 1):
            _write(state, path)
            if not self.verify:
                break
            try:
                verified = tree_digest(_read(path)) == digest
            except Exception:
                verified = False
            if verified:
                break
            os.remove(path)
            if attempt == self.retries:
                raise RuntimeError(
                    f"checkpoint save verification failed @ step {step}")
        self._rotate()
        self.last_save = {"step": int(step), "digest": digest,
                          "bytes": os.path.getsize(path),
                          "seconds": time.perf_counter() - t0,
                          "attempts": attempt, "verified": verified}
        return self.last_save

    def _rotate(self) -> None:
        steps = checkpoint_steps(self.work_dir)
        for old in steps[:max(0, len(steps) - self.max_keep)]:
            shutil.rmtree(os.path.join(self.dir, str(old)))

    def restore_latest(self, model: torch.nn.Module, optimizer,
                       ema: Optional[Dict[str, torch.Tensor]] = None,
                       map_location="cpu") -> Optional[int]:
        """Restore the newest checkpoint into `model` and `optimizer` (onto
        their device) and, given `ema`, into it; returns the step, or None
        when there is none. Either layout restores either way: a checkpoint
        saved without an EMA seeds `ema` from the restored parameters, and
        one saved with an EMA restores without one when `ema` is None.
        `restored_digest` is then the digest of the restored state, equal
        to the saved one when every tensor came back bit for bit. The file
        is read onto `map_location` (a rank's own device)."""
        step = self.latest_step()
        if step is None:
            return None
        state = _read(self.path(step), map_location)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        if ema is not None:
            src = state.get("ema")
            if src is None:
                src = {n: p.detach() for n, p in model.named_parameters()}
            with torch.no_grad():
                for n, e in ema.items():
                    e.copy_(src[n])
        self.restored_digest = tree_digest(snapshot(step, model, optimizer,
                                                    ema))
        return step

    def restore_latest_eval(self, model: torch.nn.Module,
                            use_ema: bool = False) -> Optional[int]:
        """Restore the model's weights and BatchNorm statistics only (no
        optimizer); with `use_ema`, the EMA in place of the parameters.
        Returns the step, or None when there is no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        state = _read(self.path(step))
        model.load_state_dict(state["model"])
        if use_ema:
            if "ema" not in state:
                raise ValueError("checkpoint has no EMA parameters (saved "
                                 "without --ema)")
            params = dict(model.named_parameters())
            with torch.no_grad():
                for n, e in state["ema"].items():
                    params[n].copy_(e)
        return step
