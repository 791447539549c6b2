"""Reading a `torch.profiler` trace: device time by kernel name, the device's
busy union and idle gaps, and the breakdown the result line carries.

`CATEGORIES`, `categorize` and `kernel_times` are copies of the port's
`tools/profile_gpu.py` (a test holds them equal), kept here so that a change
to the program cannot move the yardstick.
"""

from __future__ import annotations

import collections
import re
from typing import Dict

# (category, pattern on the lower-cased kernel name), first match wins.
CATEGORIES = (
    ("collectives", r"nccl"),
    ("hand kernels (K1-K4)",
     r"gather_fold_kernel|patch_gather_kernel|corner_grads_kernel"
     r"|count_chunks|scan_chunks|fill_chunks|accumulate_tiles|finish_rows"),
    ("copy/layout", r"memcpy|memset|copy|transpose|nchwtonhwc|nhwctonchw"
                    r"|catarray|fillfunctor"),
    ("matmul/conv", r"gemm|gemv|xmma|cutlass|cublas|conv|fprop|wgrad|dgrad"
                    r"|winograd|(^|::)(mm|bmm|addmm|baddbmm|matmul)$"),
    ("reduce/sort", r"reduce|sort|topk|softmax|norm|welford|bn_fw|bn_bw"
                    r"|scan|cumsum"),
    ("gather/scatter", r"index|gather|scatter|embedding"),
    ("elementwise", r"elementwise|pointwise|vectorized|unrolled|apply"),
)
# the kernels of each hand kernel, by the names their CUDA sources give them
KERNEL_PATTERNS = {
    "K1": r"gather_fold_kernel",
    "K2": r"patch_gather_kernel",
    "K3": r"count_chunks|scan_chunks|fill_chunks|accumulate_tiles|finish_rows",
    "K4": r"corner_grads_kernel",
}


def categorize(by_name: Dict[str, float]) -> Dict[str, float]:
    """{category: summed value} of {kernel name: value}."""
    cat: Dict[str, float] = collections.Counter()
    for name, value in by_name.items():
        n = name.lower()
        for label, pat in CATEGORIES:
            if re.search(pat, n):
                cat[label] += value
                break
        else:
            cat["other"] += value
    return dict(cat)


def kernel_times(events, n_steps: int = 1):
    """({name: ms per step}, 'device' or 'host') from a profile's
    `key_averages()`: each CUDA kernel's (and copy's) self device time, or,
    where the profile holds no device activity, each `aten::` op's self
    host time."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    if dev:
        pairs, kind = ((e.key, e.self_device_time_total) for e in dev), "device"
    else:
        pairs = ((e.key, e.self_cpu_time_total) for e in events
                 if e.key.startswith("aten::"))
        kind = "host"
    by_name: Dict[str, float] = collections.Counter()
    for key, us in pairs:
        by_name[key] += us / 1e3 / n_steps
    return dict(by_name), kind


def union_length(intervals, lo, hi) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total, reach = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


def gaps(intervals, lo, hi):
    """The idle [start, end) stretches of [lo, hi) that no interval covers."""
    out, reach = [], lo
    for s, e in sorted(intervals):
        if s > reach:
            out.append((reach, min(s, hi)))
        reach = max(reach, e)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(s, e) for s, e in out if e > s]


def innermost(cpu_events, times):
    """For each time in `times`, the name of the shortest host event (name,
    start, end) that covers it, or 'host idle'."""
    import numpy as np

    names = [n for n, _, _ in cpu_events]
    s = np.array([a for _, a, _ in cpu_events], dtype=np.float64)
    e = np.array([b for _, _, b in cpu_events], dtype=np.float64)
    out = []
    for t in times:
        hit = np.flatnonzero((s <= t) & (t < e))
        out.append(names[hit[np.argmin(e[hit] - s[hit])]] if hit.size
                   else "host idle")
    return out


NAMED_GAPS = 500


class Trace:
    """One profiled stretch: its wall span, its device kernels and host ops
    (both in microseconds on the profiler's clock) and its key averages."""

    def __init__(self, prof, span_name: str, units: int):
        from torch.autograd import DeviceType

        self.units = units  # frames or steps in the stretch
        events = prof.events()
        spans = [e for e in events if e.name == span_name
                 and e.device_type == DeviceType.CPU]
        if not spans:
            raise RuntimeError(f"no span named {span_name} in the trace")
        span = max(spans, key=lambda e: e.time_range.end - e.time_range.start)
        self.lo, self.hi = span.time_range.start, span.time_range.end
        self.kernels = [(e.name, e.time_range.start, e.time_range.end)
                        for e in events if e.device_type == DeviceType.CUDA
                        and not e.is_user_annotation]
        self.host = [(e.name, e.time_range.start, e.time_range.end)
                     for e in events if e.device_type == DeviceType.CPU
                     and e.name != span_name]
        self.averages = prof.key_averages()

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.kernels],
                            self.lo, self.hi) / 1e6

    def device_s(self, pattern: str) -> float:
        """Summed device seconds of the kernels whose name matches."""
        return sum(min(e, self.hi) - max(s, self.lo)
                   for n, s, e in self.kernels
                   if re.search(pattern, n) and e > self.lo and s < self.hi) / 1e6

    def by_category(self) -> Dict[str, float]:
        """Device seconds of the stretch by `CATEGORIES`."""
        by_name: Dict[str, float] = collections.Counter()
        for n, s, e in self.kernels:
            s, e = max(s, self.lo), min(e, self.hi)
            if e > s:
                by_name[n] += (e - s) / 1e6
        return categorize(by_name)

    def aten_ops(self) -> int:
        return sum(e.count for e in self.averages if e.key.startswith("aten::"))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time of
        the longest `NAMED_GAPS` gaps summed by the innermost host op
        running at each gap's middle."""
        ops: Dict[str, float] = collections.Counter()
        for n, s, e in self.kernels:
            s, e = max(s, self.lo), min(e, self.hi)
            if e > s:
                ops[n] += (e - s) / 1e6
        # the longest gaps, named by what the host was doing (naming every
        # gap of a long stretch would cost seconds)
        idle: Dict[str, float] = collections.Counter()
        kern = [(s, e) for _, s, e in self.kernels]
        longest = sorted(gaps(kern, self.lo, self.hi),
                         key=lambda g: g[0] - g[1])[:NAMED_GAPS]
        names = innermost(self.host, [(s + e) / 2 for s, e in longest])
        for name, (s, e) in zip(names, longest):
            idle[name] += (e - s) / 1e6
        first = lambda d: [[k[:200], v] for k, v in
                           sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": first(ops), "idle_gaps": first(idle)}
