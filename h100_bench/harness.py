"""One run of one cell: set-up, the measured window, the optional traced
stretch, the check against the plain reference, and the result line.

Everything a cell is made of is found by name: its entry in
`BENCHMARK.json`, its configuration's file (`configs/<name>.json`), its
traffic mix (`traffic/<name>.json`, whose `kind` picks `FrameDriver` or
`TrainDriver`), its limits (`limits/<cell>.json`) and each metric's
reader (`metrics/<metric>.py`). A new cell, configuration, mix or metric is new
files and entries; no file here changes.

The program under test is `racformer_tpu_torch`, imported inside the
drivers. The reference (`reference/`) is built only after the window has
closed, the peak memory read and the program's state freed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import check, profiling, weights
from .traffic import generator

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPAN = "h100_bench.stretch"


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metric_module(name: str):
    """`metrics/<name>.py`, loaded by path (metric names hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: its end-to-end metrics untraced,
    its per-layer metrics traced."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def model_kwargs(cfg: dict, config_kwargs) -> dict:
    """`RaCFormer`'s arguments from the configuration's file through a
    side's own `config_kwargs`."""
    return config_kwargs({k: cfg[k] for k in ("model", "decoder", "class_names")
                          if k in cfg})


def seed_of(seed: int) -> int:
    """A 63-bit seed for torch from any integer."""
    return int(np.random.SeedSequence(int(seed) % 2**64).generate_state(
        2, np.uint32).astype(np.uint64) @ np.array([1 << 31, 1], np.uint64)) % 2**63


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of the values do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def stage(t0, what):
    print(f"h100_bench: {what} done at {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# --- frames: one stream through `step`, B streams through `step_batch` ---


def build_program(cfg, state, device, overrides=None):
    from racformer_tpu_torch.eval import StreamingEvaluator
    from racformer_tpu_torch.model import RaCFormer, config_kwargs

    kw = model_kwargs(cfg, config_kwargs)
    kw.update(overrides or {})
    with torch.device(device):
        model = RaCFormer(**kw)
    weights.load(model, state)
    model.eval()
    return model, StreamingEvaluator(model, cfg.get("eval_cfg"))


def build_reference(cfg, state, device):
    from .reference.model import RaCFormer, config_kwargs

    with torch.device(device):
        model = RaCFormer(**model_kwargs(cfg, config_kwargs))
    weights.load(model, state)
    return model.eval()


def reference_state(cfg, seed, device):
    """The seed's weights, named and shaped by the reference's module tree
    built on the meta device."""
    from .reference.model import RaCFormer, config_kwargs

    with torch.device("meta"):
        skeleton = RaCFormer(**model_kwargs(cfg, config_kwargs))
    return weights.make_state_dict(skeleton, seed_of(seed), device)


def frame_at(pool, entry):
    k, _, ts = entry
    return dict(pool[k], timestamp=ts)


class FrameDriver:
    """Closed loop: the next frame (or B frames, one a stream) is handed to
    the evaluator when the last one's boxes are numpy arrays on the host."""

    def __init__(self, ctx):
        self.ctx = ctx
        cfg, mix = ctx.cfg, ctx.mix
        self.B = mix["streams"]
        self.pool = generator.frame_pool(cfg, mix, ctx.seed)
        self.model, self.ev = build_program(cfg, ctx.state, ctx.device,
                                            ctx.overrides)
        self.tapes = None

    def step(self, i):
        if self.B == 1:
            entry = self.tapes[0][i]
            if entry[1]:
                self.ev.reset()
            out = self.ev.step(frame_at(self.pool, entry), blocking=True)
        else:
            entries = [t[i] for t in self.tapes]
            out = self.ev.step_batch([frame_at(self.pool, e) for e in entries],
                                     [e[1] for e in entries], blocking=True)
        return out

    def warm_up(self):
        """Every shape of the window: a scene's first frame (the window
        filled from it) and the frames after (the window shifted)."""
        n = self.ctx.mix["warmup_frames"]
        self.tapes = [generator.tape(self.ctx.mix, self.ctx.seed + 1, b, n)
                      for b in range(self.B)]
        for i in range(n):
            self.step(i)
        sync(self.ctx.device)
        self.ev.reset()

    def window(self, seconds, trace):
        """The measured window. Returns the records of its steps; with
        `trace`, the first `profile_frames` steps run under the profiler."""
        mix = self.ctx.mix
        horizon = int(seconds * mix["max_rate_hz"]) + mix["profile_frames"] + 1
        self.tapes = [generator.tape(mix, self.ctx.seed, b, horizon)
                      for b in range(self.B)]
        recs, outs = [], []
        prof = start_profile() if trace else None
        self.ctx.profiling = bool(trace)
        t_start = time.perf_counter()
        i = 0
        while True:
            if prof is not None and i == mix["profile_frames"]:
                stop_profile(prof)
                self.ctx.profiling = False
                t_after = time.perf_counter()
            if i >= mix["profile_frames"] * trace and \
                    time.perf_counter() - t_start >= seconds:
                break
            if i >= horizon:
                raise RuntimeError("the window outran its tape: raise max_rate_hz")
            t0 = time.perf_counter()
            out = self.step(i)
            t1 = time.perf_counter()
            recs.append((t0, t1))
            outs.append(out)
            i += 1
        self.ctx.records = recs
        self.ctx.window_s = recs[-1][1] - t_start
        self.ctx.untraced = recs[mix["profile_frames"]:] if trace else recs
        self.ctx.outputs = outs
        self.ctx.frames_per_step = self.B
        if trace:
            self.ctx.untraced_s = recs[-1][1] - t_after
            self.ctx.trace = profiling.Trace(prof, SPAN, mix["profile_frames"])
        self.ctx.attempted = len(recs) * self.B
        # a served frame fails when any of its scores or boxes is not finite
        self.ctx.failed = sum(int(((~np.isfinite(o["scores"])).any(-1)
                                   | (~np.isfinite(o["bboxes"])).any((-1, -2))).sum())
                              for o in outs)

    def release(self):
        self.model = self.ev = None
        free()

    def compare(self):
        """The served frames of a sample drawn from the seed (the window's
        last step always in it) against the reference's windows."""
        ctx, mix = self.ctx, self.ctx.mix
        n = len(ctx.outputs)
        rng = generator.rng_for(ctx.seed, 4)
        steps = sorted(set(rng.choice(n - 1, size=min(n - 1, mix["check_frames"] - 1),
                                      replace=False).tolist()) | {n - 1})
        ref = build_reference(ctx.cfg, ctx.state, ctx.device)
        from .reference.eval.decode import decode_config
        from .reference.streaming import WindowReference

        wref = WindowReference(ref, self.pool, self.tapes,
                               decode_config(ctx.cfg.get("eval_cfg")), ctx.device)
        gaps = check.FrameGaps()
        for i in steps:
            cls, boxes, _ = wref.window(i)
            for b in range(self.B):
                one = ref_boxes(boxes[b], wref.decode_cfg)
                served = {k: v[b] for k, v in ctx.outputs[i].items()}
                gaps.add(check.matched_gaps(served, cls[b], one))
        ctx.checked = len(steps) * self.B
        return gaps.numbers


def ref_boxes(boxes, decode_cfg):
    """The reference's decoded box of every query, [Q, 9], in query order:
    one class whose scores fall with the query's index, so the decode's
    top-k keeps that order."""
    from .reference.eval.decode import decode_boxes

    Q = boxes.shape[0]
    cfg = dict(decode_cfg, max_num=Q, score_threshold=-1.0)
    order = -torch.arange(Q, device=boxes.device, dtype=torch.float32) / Q
    return decode_boxes(order[None, :, None], boxes[None], **cfg)["bboxes"][0]


# --- training: the port's train step with AdamW ---------------------------

BETA1 = 0.9  # AdamW's first-moment rate, as both optimizers set it
CHECKED_STEPS = 3  # the reference follows the first three steps
WINDOW_STEPS = 3  # and the window's first three, from the program's state


def optimizer_kwargs(cfg, mix):
    opt = dict(cfg.get("optimizer", {}))
    return dict(base_lr=opt.get("base_lr", 4e-4),
                weight_decay=opt.get("weight_decay", 0.01),
                total_steps=int(mix["total_steps"]),
                warmup_steps=opt.get("warmup_steps", 500),
                clip_norm=opt.get("clip_norm", 35.0))


def to_device(batch, device):
    """A train batch on the device, its column-form radar maps smeared down
    the image rows as the rasterizer's dense maps are."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    H = out["imgs"].shape[-3]
    for k in ("radar_depth", "radar_rcs"):
        m = out[k]
        out[k] = m.unsqueeze(-2).expand(*m.shape[:-1], H, m.shape[-1]).contiguous()
    return out


def draws_seed(seed, step):
    return seed_of(seed * 1000 + step)


class TrainSnapshot:
    """What the checked steps leave to compare: each step's total loss, the
    first gradient each leaf's optimizer got (from AdamW's first moment
    after one step), and each leaf's change over the three steps."""

    def __init__(self):
        self.losses, self.grad_norms, self.change_norms = [], {}, {}

    def after_step(self, k, metrics, params, adamw, start):
        self.losses.append(float(metrics["loss_total"]))
        if k == 0:
            for n, p in params.items():
                st = adamw.state.get(p)
                if st and "exp_avg" in st:
                    self.grad_norms[n] = float(st["exp_avg"].double().norm()) / (1 - BETA1)
        if k == CHECKED_STEPS - 1:
            for n, p in params.items():
                if n in start:
                    self.change_norms[n] = float((p.detach().double()
                                                  - start[n].double()).norm())


def train_gaps(prog: TrainSnapshot, ref: TrainSnapshot) -> dict:
    """The compared numbers: the largest relative gap of a step's loss, and
    by the worst leaf the gap between the program's and the reference's
    norms of the first gradient and of the change over the three steps,
    against the reference leaf's norm or the median leaf's, whichever is
    larger. Leaves whose reference gradient is under a thousandth of the
    median leaf's move under AdamW by round-off alone: they are left out of
    the change."""
    loss = max(abs(a - b) / max(abs(b), 1e-12)
               for a, b in zip(prog.losses, ref.losses))
    gmed = float(np.median(list(ref.grad_norms.values())))
    grad = max(abs(prog.grad_norms.get(n, 0.0) - g) / max(g, gmed)
               for n, g in ref.grad_norms.items())
    keep = moved_leaves(ref)
    moved = {n: c for n, c in ref.change_norms.items() if n in keep}
    cmed = float(np.median(list(moved.values())))
    change = max(abs(prog.change_norms.get(n, 0.0) - c) / max(c, cmed)
                 for n, c in moved.items())
    rel = lambda p, r, med: [abs(p.get(n, 0.0) - v) / max(v, med) for n, v in r.items()]
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "loss_gap_first": abs(prog.losses[0] - ref.losses[0]) / abs(ref.losses[0]),
            "grad_gap_median": float(np.median(rel(prog.grad_norms, ref.grad_norms, gmed))),
            "change_gap_median": float(np.median(rel(prog.change_norms, moved, cmed)))}


def moved_leaves(ref: TrainSnapshot) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under AdamW by round-off alone."""
    gmed = float(np.median(list(ref.grad_norms.values())))
    return {n for n, g in ref.grad_norms.items() if g >= 1e-3 * gmed}


def window_gaps(prog_losses, ref_losses, before, prog_after, ref_after,
                moved) -> dict:
    """The window's first steps, which the reference follows from the
    program's own state at the window's start (`before`): the relative gap
    of the first step's loss, of the worst step's, and by the worst moved
    leaf and the median one the gap of the norms of each leaf's change over
    those steps, against the reference leaf's or the median leaf's,
    whichever is larger."""
    def change(after):
        return {n: float((after[n].detach().double() - before[n].double()).norm())
                for n in moved if n in after}

    ref_c, prog_c = change(ref_after), change(prog_after)
    cmed = float(np.median(list(ref_c.values())))
    rel = [abs(prog_c.get(n, 0.0) - c) / max(c, cmed) for n, c in ref_c.items()]
    loss = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog_losses, ref_losses)]
    return {"loss_gap_window": loss[0], "loss_gap_window_steps": max(loss),
            "change_gap_window": max(rel),
            "change_gap_window_median": float(np.median(rel))}


def program_state(model, opt) -> dict:
    """A copy of the train step's state: the model's leaves (parameters and
    buffers), AdamW's state by parameter name, and the updates made."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {"model": {n: t.detach().clone() for n, t in model.state_dict().items()},
            "adamw": {names[id(p)]: {k: v.detach().clone() if torch.is_tensor(v) else v
                                     for k, v in st.items()}
                      for p, st in opt.adamw.state.items()},
            "count": opt.count}


def load_program_state(model, opt, state) -> None:
    """`program_state`'s copy into the reference's model and optimizer."""
    weights.load(model, state["model"])
    opt.adamw.state.clear()
    for n, p in model.named_parameters():
        st = state["adamw"].get(n)
        if st is not None:
            opt.adamw.state[p] = {k: v.to(p.dtype) if torch.is_tensor(v) and k != "step"
                                  else v.clone() if torch.is_tensor(v) else v
                                  for k, v in st.items()}
    opt.count = int(state["count"])


class TrainDriver:
    """Closed loop of train steps: the port's `make_train_step` as its
    train driver wires it (AdamW, the recipe's groups, the batch in
    microbatches), on batches staged on the device in set-up."""

    def __init__(self, ctx):
        from racformer_tpu_torch.model import RaCFormer, config_kwargs
        from racformer_tpu_torch.train import Optimizer, make_train_step

        self.ctx = ctx
        cfg, mix = ctx.cfg, ctx.mix
        self.host = generator.train_pool(cfg, mix, ctx.seed)
        self.pool = [to_device(b, ctx.device) for b in self.host]
        kw = model_kwargs(cfg, config_kwargs)
        kw.update(ctx.overrides or {})
        with torch.device(ctx.device):
            self.model = RaCFormer(**kw)
        weights.load(self.model, ctx.state)
        self.model.train()
        self.opt = Optimizer(self.model.named_parameters(),
                             **optimizer_kwargs(cfg, mix))
        self.step_fn = make_train_step(self.model, self.opt,
                                       dict(cfg.get("depth", {})),
                                       int(mix["microbatches"]))
        self.snap = TrainSnapshot()
        self.n = 0

    def step(self):
        k = self.n
        gen = torch.Generator().manual_seed(draws_seed(self.ctx.seed, k))
        metrics = self.step_fn(self.pool[k % len(self.pool)], generator=gen)
        self.n += 1
        return metrics

    def warm_up(self):
        """The checked steps: the window's own call and feed on the pool's
        first batches, each distinct."""
        params = dict(self.model.named_parameters())
        start = {n: self.ctx.state[n] for n in params if n in self.ctx.state}
        for k in range(CHECKED_STEPS):
            metrics = self.step()
            self.snap.after_step(k, metrics, params, self.opt.adamw, start)
        self.before = program_state(self.model, self.opt)
        sync(self.ctx.device)

    def window(self, seconds, trace):
        mix, ctx = self.ctx.mix, self.ctx
        recs, losses = [], []
        prof = start_profile() if trace else None
        ctx.profiling = bool(trace)
        t_start = time.perf_counter()
        i = 0
        while True:
            if prof is not None and i == mix["profile_steps"]:
                stop_profile(prof)
                ctx.profiling = False
                t_after = time.perf_counter()
            if i >= max(mix["profile_steps"] * trace, WINDOW_STEPS) and \
                    time.perf_counter() - t_start >= seconds:
                break
            t0 = time.perf_counter()
            losses.append(float(self.step()["loss_total"]))
            recs.append((t0, time.perf_counter()))
            i += 1
            if i == WINDOW_STEPS:
                self.after = {n: p.detach().clone()
                              for n, p in self.model.named_parameters()}
        B = self.host[0]["imgs"].shape[0]
        ctx.records, ctx.frames_per_step = recs, B
        ctx.window_s = recs[-1][1] - t_start
        ctx.untraced = recs[mix["profile_steps"]:] if trace else recs
        if trace:
            ctx.untraced_s = recs[-1][1] - t_after
            ctx.trace = profiling.Trace(prof, SPAN, mix["profile_steps"])
        ctx.attempted = len(recs) * B
        ctx.failed = sum(B for v in losses if not math.isfinite(v))
        self.window_losses = losses[:WINDOW_STEPS]

    def release(self):
        self.model = self.opt = self.step_fn = self.pool = None
        free()

    def compare(self):
        """The reference follows the first three steps from the seed, then
        the window's first three from the program's state at its start."""
        from .reference.model import RaCFormer, config_kwargs
        from .reference.train.optim import Optimizer
        from .reference.train.step import make_train_step

        ctx, cfg, mix = self.ctx, self.ctx.cfg, self.ctx.mix
        with torch.device(ctx.device):
            model = RaCFormer(**model_kwargs(cfg, config_kwargs))
        weights.load(model, ctx.state)
        model.train()
        opt = Optimizer(model.named_parameters(), **optimizer_kwargs(cfg, mix))
        step_fn = make_train_step(model, opt, dict(cfg.get("depth", {})),
                                  int(mix["microbatches"]))
        params = dict(model.named_parameters())
        start = {n: ctx.state[n] for n in params if n in ctx.state}

        def step(k):
            batch = to_device(self.host[k % len(self.host)], ctx.device)
            gen = torch.Generator().manual_seed(draws_seed(ctx.seed, k))
            return step_fn(batch, generator=gen)

        ref = TrainSnapshot()
        for k in range(CHECKED_STEPS):
            ref.after_step(k, step(k), params, opt.adamw, start)
        gaps = train_gaps(self.snap, ref)
        load_program_state(model, opt, self.before)
        losses = [float(step(CHECKED_STEPS + j)["loss_total"])
                  for j in range(WINDOW_STEPS)]
        gaps.update(window_gaps(self.window_losses, losses,
                                self.before["model"], self.after, params,
                                moved_leaves(ref)))
        ctx.checked = CHECKED_STEPS + WINDOW_STEPS
        return gaps


# --- the profiler -------------------------------------------------------


def start_profile():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    prof.span = torch.profiler.record_function(SPAN)
    prof.span.__enter__()
    return prof


def stop_profile(prof):
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.span.__exit__(None, None, None)
    prof.__exit__(None, None, None)


DRIVERS = {"stream": FrameDriver, "lockstep": FrameDriver, "train": TrainDriver}


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_process: float, bench: dict = None, cfg: dict = None,
             overrides: dict = None, limits: dict = None, fault=None) -> dict:
    """One run of `cell`. Returns the result line's object. `cfg` and
    `limits` stand in for the cell's files in tests; `overrides` are
    program-side model arguments (the control); `fault(driver)` breaks the
    timed path (`faults`; planted before the warm-up, which
    holds a train cell's checked steps). A metric's `prepare(ctx)` and a
    fault may return a function that takes them out again; each is called
    once the window has closed."""
    bench = bench or load_benchmark()
    w = find_cell(bench, cell)
    cfg = cfg or load_config(bench, w["config"])
    mix = generator.load_mix(w["traffic"])
    ctx = SimpleNamespace(cell=cell, cfg=cfg, mix=mix, seed=seed, device=device,
                          overrides=overrides, trace=None, profiling=False, flops=cfg.get("flops", {}))
    metrics = [(m, metric_module(m["name"])) for m in cell_metrics(bench, cell, trace)]
    stage(t_process, "imports")
    ctx.state = reference_state(cfg, seed, device)
    stage(t_process, "weights")
    driver = DRIVERS[mix["kind"]](ctx)
    stage(t_process, "inputs and the program's model")
    undo = [getattr(mod, "prepare", lambda ctx: None)(ctx) for _, mod in metrics]
    undo.append(fault(driver) if fault is not None else None)
    try:
        driver.warm_up()
        ctx.setup_s = time.perf_counter() - t_process
        stage(t_process, "warm-up")
        driver.window(seconds, trace)
    finally:
        for f in undo:
            if f is not None:
                f()
    values = {}
    for m, mod in metrics:
        v = mod.read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(w["chips"]),
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
        if dev.type == "cuda" else 0,
    }
    if trace:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
    driver.release()
    t_ref = time.perf_counter()
    numbers = driver.compare()
    stage(t_ref, "the reference's check")
    ok, checks, readings = check.verdict(numbers, limits or check.load_limits(cell))
    result = {"correct": ok and ctx.failed == 0, "attempted": ctx.attempted,
              "failed": ctx.failed, "metrics": values, "device": device_info}
    if trace:
        result["breakdown"] = ctx.trace.breakdown()
        for cat, sec in sorted(ctx.trace.by_category().items(), key=lambda kv: -kv[1]):
            print(f"h100_bench: device ms a step, {cat}: {1e3 * sec / ctx.trace.units:.3f}",
                  file=sys.stderr)
    result["readings"] = dict(readings, checked=ctx.checked)
    result["checks"] = checks
    return result
