"""The streaming evaluator's encoder and decoder replayed as CUDA graphs.

A streaming step encodes the newest frame (`encode_frame`: the images
normalized, column radar maps smeared down their columns,
`RaCFormer.encode_frame`) and decodes the T-frame window
(`RaCFormer.decode_window`). Both have the same shapes in every frame of a
stream, and their host work is launching thousands of small kernels. So
`EncodeGraphs` and `DecodeGraphs` run the first call of a key eagerly,
capture the second, and replay the captures from then on:

- the capture runs the call once with the samplers' K1 calls and the
  spans inside it as cuts: each stretch of torch work between two cuts is
  one CUDA graph (the encoder calls no K1, so its cuts are its spans,
  `model.trunk` and `model.bev`);
- a replay walks the same sequence: it replays each graph in turn, calls
  K1 eagerly where the decode called it (through the attribute its call
  site reads, `ops.msmv.patch_sample_fold` or
  `ops.deform_attn.patch_sample_fold`, on the tensors the graph before it
  wrote) and copies K1's output to where the next graph reads it, and it
  opens each span around what ran inside it. So K1's launches, its
  counter (`gather_kernel.LAUNCHES`), `force_reference()` and anything
  that wraps a call site see the calls they saw before;
- the graphs read their inputs from the tensors of the call they
  captured (the frame's uploaded tensors, the window), and each replay
  copies the inputs it is given into them. A replay's outputs are
  overwritten by the next replay: the evaluator's shift copies a new
  frame into a window of its own, and `decode_boxes` makes tensors of its
  own.

A call replays only where it is the same work each time, as one function
of each kind decides: `encode_key` for an encode, `replay_key` for a
decode. Both want CUDA tensors, gradients off and the model in eval mode,
and key on the inputs' shapes and dtypes, the compute dtype and the
device. An encode keys on deterministic algorithms besides (they pick
another `index_add_` for the LSS splat and the pillar sums). A decode
replays only where its decoder folds (`RaCFormer.folds`: the unfolded
samplers of `fused_gather=False` launch K2, whose launches would go
uncounted in a graph) and with the kernels themselves (not their plain
versions under `force_reference()`). The evaluator owns the graphs and
their memory pools, one a plan; they are freed with it.

`GRAPH_REPLAYS` counts the graphs replayed; with the span recorder on, the
open span (`eval.encode_frame`, `eval.decode_window`) counts them as
`graph_replays`, and an eager call as `eager_encodes` or `eager_decodes`.
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, Optional, Tuple

import torch

from ..model.racformer import preprocess_images
from ..ops import deform_attn, gather_kernel, msmv
from ..utils import tracing

GRAPH_REPLAYS = 0  # CUDA graphs replayed by `EncodeGraphs` and `DecodeGraphs`
# the modules whose `patch_sample_fold` attribute the samplers call K1 by
K1_SITES = (msmv, deform_attn)
# torch's warning at the end of a capture that captured no work (the CUDA
# tests hold torch to it)
EMPTY = "The CUDA Graph is empty"
_ONCE = "once"  # a key called eagerly once, captured at its next call
# the evaluator's uploaded fields an encode reads, in `encode_frame`'s order
ENCODED = ("imgs", "radar_points", "radar_mask", "radar_depth", "radar_rcs",
           "img2lidar")
DEVICES = ("cuda",)  # the device types whose work a CUDA graph captures


def encode_frame(model, frame):
    """`model.encode_frame` of the newest frames (`ENCODED` as uploaded,
    each [B, ...]: raw images, the radar maps dense [B, N, H, W] or in
    column form [B, N, W]). Returns (feat_cat, lss_bev, radar_bev)."""
    imgs, points, mask, depth, rcs, img2lidar = frame
    imgs = preprocess_images(imgs)
    H = imgs.shape[2]
    radar = []
    for m in (depth.float(), rcs.float()):
        if m.dim() == 3:  # column form [B, N, W]: the rasterizer smears columns
            m = m[:, :, None, :].expand(m.shape[0], m.shape[1], H, m.shape[2])
        radar.append(m)
    feat_cat, lss, rbev, _ = model.encode_frame(
        imgs, points.float(), mask.bool(), radar[0], radar[1], img2lidar.float())
    return feat_cat, lss, rbev


def decode_window(model, window):
    """`model.decode_window` over the evaluator's window (feat_cat, lss,
    radar, lidar2img, timestamps), each [B, T, ...]."""
    cat_w, lss_w, radar_w, l2i_w, ts_w = window
    return model.decode_window(cat_w, lss_w, radar_w, l2i_w, ts_w[:, :1] - ts_w)


def _shapes(inputs):
    return tuple((tuple(t.shape), t.dtype) for t in inputs)


def encode_key(model, frame) -> Optional[Tuple]:
    """What a captured encode of `frame` is kept under, or None where the
    encode runs eagerly (the module docstring)."""
    if (model.training or torch.is_grad_enabled()
            or frame[0].device.type not in DEVICES):
        return None
    return (_shapes(frame), model.trunk_dtype,
            torch.are_deterministic_algorithms_enabled(), frame[0].device)


def replay_key(model, window) -> Optional[Tuple]:
    """What a captured decode of `window` is kept under, or None where the
    decode runs eagerly (the module docstring)."""
    if (model.training or torch.is_grad_enabled() or not model.folds
            or gather_kernel.use_reference(window[0])):
        return None
    return _shapes(window), model.head_dtype, window[0].device


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
    """A span of the captured call and the steps that ran inside it."""

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
    """A captured call: its inputs, steps and outputs."""

    def __init__(self, inputs, root, outs):
        self.inputs, self.root, self.outs = inputs, root, outs
        self.graphs = root.graphs()

    def replay(self, inputs):
        """The call's outputs for `inputs`, copied into the plan's inputs
        (the outputs are overwritten by the next replay)."""
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        for step in self.root.steps:
            step.run()
        return self.outs


def capture(fn, model, inputs) -> _Plan:
    """`fn(model, inputs)` captured on a side stream, into a graph pool of
    its own."""
    dev = inputs[0].device
    main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        root, outs = _Capture(torch.cuda.graph_pool_handle()).run(
            lambda: fn(model, inputs))
    main.wait_stream(side)
    return _Plan(tuple(inputs), root, outs)


class _Graphs:
    """A streaming evaluator's captured calls of one function, one plan per
    key: `fn` eagerly at a key's first call, captured at its second,
    replayed from then on. `key` gives None where a call runs eagerly;
    `EAGER` is what the open span counts an eager call as."""

    def __init__(self):
        self.plans: Dict[Tuple, object] = {}

    def __call__(self, model, inputs):
        """`fn(model, inputs)`, eagerly or replayed."""
        global GRAPH_REPLAYS
        key = self.key(model, inputs)
        plan = self.plans.get(key)
        if plan is _ONCE:
            plan = self.plans[key] = capture(self.fn, model, inputs)
        if plan is None:
            outs = self.fn(model, inputs)
            if key is not None:
                self.plans[key] = _ONCE
            if tracing.recording():
                tracing.count(self.EAGER, 1)
            return outs
        outs = plan.replay(inputs)
        GRAPH_REPLAYS += plan.graphs
        if tracing.recording():
            tracing.count("graph_replays", plan.graphs)
        return outs


class EncodeGraphs(_Graphs):
    """The newest frames' encodes (`encode_frame`, keyed by `encode_key`;
    both looked up at each call, so a caller may patch the module's)."""

    EAGER = "eager_encodes"

    @staticmethod
    def fn(model, frame):
        return encode_frame(model, frame)

    @staticmethod
    def key(model, frame):
        return encode_key(model, frame)


class DecodeGraphs(_Graphs):
    """The windows' decodes (`decode_window`, keyed by `replay_key`; both
    looked up at each call, so a caller may patch the module's)."""

    EAGER = "eager_decodes"

    @staticmethod
    def fn(model, window):
        return decode_window(model, window)

    @staticmethod
    def key(model, window):
        return replay_key(model, window)
