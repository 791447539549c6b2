"""The streaming evaluator's decoder replayed as CUDA graphs.

The decoder of a streaming step (`RaCFormer.decode_window` over the
T-frame window) has the same shapes in every frame of a stream, and its
host work is launching thousands of small kernels. So `DecodeGraphs`
decodes the first window of a shape eagerly, captures the second, and
replays the captures from then on:

- the capture runs the decode once with the samplers' K1 calls and the
  spans inside it as cuts: each stretch of torch work between two cuts is
  one CUDA graph;
- a replay walks the same sequence: it replays each graph in turn, calls
  K1 eagerly where the decode called it (through the attribute its call
  site reads, `ops.msmv.patch_sample_fold` or
  `ops.deform_attn.patch_sample_fold`, on the tensors the graph before it
  wrote) and copies K1's output to where the next graph reads it, and it
  opens each span around what ran inside it. So K1's launches, its
  counter (`gather_kernel.LAUNCHES`), `force_reference()` and anything
  that wraps a call site see the calls they saw before;
- the graphs read the window from the tensors of the window they
  captured, and each replay copies the window it is given into them (the
  evaluator's next shift makes a window of its own). A replay's outputs
  are overwritten by the next replay.

A decode replays only where it is the same work each time: on CUDA
tensors, with gradients off, the model in eval mode, its decoder folding
(`RaCFormer.folds`: the unfolded samplers of `fused_gather=False` launch
K2, whose launches would go uncounted in a graph) and the kernels
themselves (not their plain versions under `force_reference()`), keyed on
the window's shapes and dtypes, the head's dtype and the device. The
evaluator owns the graphs and their memory pool; they are freed with it.

`GRAPH_REPLAYS` counts the graphs replayed; with the span recorder on, the
open span (`eval.decode_window`) counts them as `graph_replays`, and an
eager decode as `eager_decodes`.
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, Optional, Tuple

import torch

from ..ops import deform_attn, gather_kernel, msmv
from ..utils import tracing

GRAPH_REPLAYS = 0  # CUDA graphs replayed by `DecodeGraphs`
# the modules whose `patch_sample_fold` attribute the samplers call K1 by
K1_SITES = (msmv, deform_attn)
# torch's warning at the end of a capture that captured no work (the CUDA
# tests hold torch to it)
EMPTY = "The CUDA Graph is empty"
_ONCE = "once"  # a key decoded eagerly once, captured at its next decode


def decode_window(model, window):
    """`model.decode_window` over the evaluator's window (feat_cat, lss,
    radar, lidar2img, timestamps), each [B, T, ...]."""
    cat_w, lss_w, radar_w, l2i_w, ts_w = window
    return model.decode_window(cat_w, lss_w, radar_w, l2i_w, ts_w[:, :1] - ts_w)


def replay_key(model, window) -> Optional[Tuple]:
    """What a captured decode of `window` is kept under, or None where the
    decode runs eagerly (the module docstring)."""
    if (model.training or torch.is_grad_enabled() or not model.folds
            or gather_kernel.use_reference(window[0])):
        return None
    return (tuple((tuple(t.shape), t.dtype) for t in window), model.head_dtype,
            window[0].device)


class _Graph:
    def __init__(self, graph):
        self.graph = graph

    def run(self):
        self.graph.replay()

    def graphs(self) -> int:
        return 1


class _K1:
    """One K1 call between two graphs: its call site, arguments and the
    tensor the next graph reads its output from."""

    def __init__(self, site, args, out):
        self.site, self.args, self.out = site, args, out

    def run(self):
        self.out.copy_(self.site.patch_sample_fold(*self.args))

    def graphs(self) -> int:
        return 0


class _Span:
    """A span of the captured decode and the steps that ran inside it."""

    def __init__(self, name):
        self.name, self.steps = name, []

    def run(self):
        with tracing.span(self.name):
            for step in self.steps:
                step.run()

    def graphs(self) -> int:
        return sum(step.graphs() for step in self.steps)


class _Capture:
    """Captures a function into graphs cut at its K1 calls and spans."""

    def __init__(self, pool):
        self.pool = pool
        self.open = [_Span(None)]  # the root, then the spans open now
        self.graph = None

    def _begin(self):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")

    def _end(self):
        graph, self.graph = self.graph, None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            graph.capture_end()
        empty = False
        for w in caught:
            if EMPTY in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        if not empty:
            self.open[-1].steps.append(_Graph(graph))

    def span(self, name, entering):
        self._end()
        if entering:
            inner = _Span(name)
            self.open[-1].steps.append(inner)
            self.open.append(inner)
        else:
            self.open.pop()
        self._begin()

    def k1(self, site, fused, row, x0p, wx, wy, wl, fold):
        self._end()
        # made outside the capture: a captured allocation could be
        # captured with a fill (deterministic algorithms) that the next
        # graph would run over K1's output
        out = gather_kernel.fold_output(fused, row, fold)
        self.open[-1].steps.append(
            _K1(site, (fused, row, x0p, wx, wy, wl, fold), out))
        self._begin()
        return out

    def run(self, fn):
        """(the root span of the captured steps, fn's result)."""
        sites = {m: m.patch_sample_fold for m in K1_SITES}
        for m in K1_SITES:
            m.patch_sample_fold = functools.partial(self.k1, m)
        tracing.listen(self.span)
        try:
            self._begin()
            result = fn()
            self._end()
        except BaseException:
            if self.graph is not None:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass  # the capture the error broke
            raise
        finally:
            tracing.listen(None)
            for m, f in sites.items():
                m.patch_sample_fold = f
        return self.open[0], result


class _Plan:
    """A captured decode: its window inputs, steps and outputs."""

    def __init__(self, inputs, root, outs):
        self.inputs, self.root, self.outs = inputs, root, outs
        self.graphs = root.graphs()

    def replay(self, window):
        """The head's outputs for `window`, copied into the inputs (the
        outputs are overwritten by the next replay)."""
        for dst, src in zip(self.inputs, window):
            dst.copy_(src)
        for step in self.root.steps:
            step.run()
        return self.outs


def capture(model, window) -> _Plan:
    """The decode of `window` captured on a side stream."""
    dev = window[0].device
    main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        root, outs = _Capture(torch.cuda.graph_pool_handle()).run(
            lambda: decode_window(model, window))
    main.wait_stream(side)
    return _Plan(tuple(window), root, outs)


class DecodeGraphs:
    """A streaming evaluator's captured decodes, one plan per key."""

    def __init__(self):
        self.plans: Dict[Tuple, object] = {}

    def decode(self, model, window):
        """The head's outputs for `window`."""
        global GRAPH_REPLAYS
        key = replay_key(model, window)
        plan = self.plans.get(key)
        if plan is _ONCE:
            plan = self.plans[key] = capture(model, window)
        if plan is None:
            outs = decode_window(model, window)
            if key is not None:
                self.plans[key] = _ONCE
            if tracing.recording():
                tracing.count("eager_decodes", 1)
            return outs
        outs = plan.replay(window)
        GRAPH_REPLAYS += plan.graphs
        if tracing.recording():
            tracing.count("graph_replays", plan.graphs)
        return outs
