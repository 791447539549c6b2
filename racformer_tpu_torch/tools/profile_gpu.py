"""Per-kernel device-time profiling on the card (the counterpart of
`racformer_tpu/tools/profile_tpu.py`): run a step under `torch.profiler`
with CUDA activity, sum the device time of every kernel by name, and split
it by category. The same per-category split as the TPU tool, with CUDA's
kernel names in place of XLA's op codes.

Library use:
    from racformer_tpu_torch.tools.profile_gpu import trace_and_summarize
    summary = trace_and_summarize(step_fn, n_steps=4)

CLI (profiles the flagship streaming step on the card, seeded random
weights and synthetic frames):
    python -m racformer_tpu_torch.tools.profile_gpu [outdir] [n_steps]

Without a CUDA device (a step on the CPU, as the tests run one) there are
no kernels: the summary then sums the host's self time of each `aten::` op
and says so, so that no host number reads as a device one.
"""

from __future__ import annotations

import collections
import os
import re
import sys
from typing import Callable, Dict, Optional

# (category, pattern on the lower-cased kernel name), first match wins.
# NCCL first (an all-reduce must not land in reduce/sort); the port's hand
# kernels K1-K4 (csrc/*.cu: K3 is its five kernels) in place of the TPU's
# pallas custom calls; layout copies before the GEMMs, since cuDNN names its
# layout transforms under its own namespace; top-k before gather/scatter
# (`gatherTopK`), indexing before elementwise (`index_elementwise_kernel`,
# `scatter_gather_elementwise_kernel`); cuDNN's batch-norm kernels
# (`bn_fw_*`, `bn_bw_*`) are reductions.
_CATEGORIES = (
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


def categorize(by_name: Dict[str, float]) -> Dict[str, float]:
    """{category: summed value} of {kernel name: value}."""
    cat: Dict[str, float] = collections.Counter()
    for name, value in by_name.items():
        n = name.lower()
        for label, pat in _CATEGORIES:
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


def trace_and_summarize(
    step: Callable[[int], object],
    n_steps: int = 4,
    outdir: Optional[str] = None,
    top: int = 15,
    printer: Callable[[str], None] = print,
) -> Dict[str, Dict[str, float]]:
    """Run `step(i)` n_steps times under `torch.profiler` and summarize.

    `step` should enqueue device work without synchronizing; the device is
    synchronized after the loop, inside the profile. Returns {"by_op":
    {kernel: ms per step}, "by_category": {category: ms per step}}; with
    `outdir`, the Chrome trace goes to `outdir/trace.json`. The categories
    partition the kernels (unlike the TPU tool's, where a loop op counts
    its body), so they sum to the device time of the steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities) as prof:
        for i in range(n_steps):
            step(i)
        if cuda:
            torch.cuda.synchronize()
    by_op, kind = kernel_times(prof.key_averages(), n_steps)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(outdir, "trace.json"))
    cat = categorize(by_op)
    what = ("device kernel time" if kind == "device" else
            "host time of aten ops (no CUDA device: not a device time)")
    printer(f"{what}: {sum(by_op.values()):.3f} ms/step over {n_steps} steps")
    for k, v in sorted(cat.items(), key=lambda kv: -kv[1]):
        printer(f"  {k:24s} {v:9.3f} ms/step")
    printer("top kernels:" if kind == "device" else "top ops:")
    for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]:
        printer(f"  {v:9.3f} ms/step  {k[:100]}")
    return {"by_op": by_op, "by_category": cat}


CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "racformer_r50_nuimg_704x256_f8.py")


def _main(argv):
    import torch

    from ..config import Config
    from ..data import SyntheticDataset
    from ..eval import StreamingEvaluator
    from ..eval.streaming import prepare_frame
    from ..model import RaCFormer, config_kwargs, random_init_

    outdir = argv[0] if argv else None
    n_steps = int(argv[1]) if len(argv) > 1 else 4
    if not torch.cuda.is_available():
        raise SystemExit("profile_gpu profiles the streaming step on a CUDA "
                         "device; none is available")
    cfg = Config.fromfile(CONFIG)
    with torch.device("cuda"):
        model = RaCFormer(**config_kwargs(cfg))
    random_init_(model, torch.Generator().manual_seed(0)).eval()
    data = SyntheticDataset(
        num_samples=3 + n_steps, num_cams=model.num_cams,
        num_frames=model.num_frames, hw=model.image_hw,
        max_radar_points=cfg["radar"]["max_points"], max_gt=model.max_gt)
    frames = [prepare_frame(data[i], 0.5 * i, False)
              for i in range(len(data))]
    ev = StreamingEvaluator(model)
    with torch.no_grad():
        for t in range(3):  # the first steps fill the temporal cache
            ev.step(frames[t], blocking=False)
        torch.cuda.synchronize()
        trace_and_summarize(
            lambda i: ev.step(frames[3 + i], blocking=False),
            n_steps=n_steps, outdir=outdir)


if __name__ == "__main__":
    _main(sys.argv[1:])
