"""The metric arithmetic on hand-made inputs, and the copies of the
program's yardsticks held equal to their originals."""

import math
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import harness, profiling, roofline


def test_p95_over_all_values_by_nearest_rank():
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95([5.0]) == 5.0
    assert harness.p95([3, 1, 2] * 7) == 3
    assert harness.p95(list(range(1, 21))) == 19  # ceil(0.95 * 20) = 19th


def test_union_and_gaps_of_kernel_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (8, 12)]
    assert profiling.union_length(iv, 0, 10) == 3 + 1 + 2
    assert profiling.gaps(iv, 0, 10) == [(3, 5), (6, 8)]
    assert profiling.gaps([], 0, 4) == [(0, 4)]
    assert profiling.innermost([("a", 0, 10), ("b", 2, 4)], [3, 5, 11]) == [
        "b", "a", "host idle"]


def trace(kernels, lo=0.0, hi=1e6, host=(), units=2):
    t = object.__new__(profiling.Trace)
    t.lo, t.hi, t.kernels, t.host, t.units = lo, hi, kernels, list(host), units
    return t


def test_device_idle_and_device_seconds():
    # 0.5 s busy over 2 traced steps; the steps after it take 1 s each
    t = trace([("gather_fold_kernel<bf16>", 0, 2e5), ("sgemm", 1e5, 5e5)])
    ctx = SimpleNamespace(trace=t, untraced=[None] * 3, untraced_s=3.0)
    idle = harness.metric_module("device_idle.eval").read(ctx)
    assert idle == pytest.approx(75.0)
    assert t.busy_s == pytest.approx(0.5) and t.window_s == pytest.approx(1.0)
    assert t.device_s(profiling.KERNEL_PATTERNS["K1"]) == pytest.approx(0.2)
    assert t.by_category() == {"hand kernels (K1-K4)": pytest.approx(0.2),
                               "matmul/conv": pytest.approx(0.4)}
    b = t.breakdown()
    assert b["device_ops"][0] == ["sgemm", pytest.approx(0.4)]
    assert b["idle_gaps"] == [["host idle", pytest.approx(0.5)]]


def test_bound_bytes_by_hand():
    # 2 slabs, 3 rows, 6 columns, C = 4 (2C = 8), bf16; 4 points, fold 2:
    # two share their columns, so 3 distinct pairs -> 5 distinct columns
    shape = (2, 3, 6, 8)
    row = torch.tensor([[0, 0], [1, 2]], dtype=torch.int32)
    x0p = torch.tensor([[1, 1], [3, 4]], dtype=torch.int32)
    w = torch.zeros(2, 2)
    assert roofline.unique_columns(shape, row, x0p) == 2 + 2 + 2
    pts = (row, x0p, w, w, w)
    want_bytes = 6 * 8 * 2 + 4 * 4 * 5 + 4 // 2 * 4 * 2
    ms, kind = roofline.bound_ms("gather_fold", shape, pts, 2, fold=2)
    assert kind == "bytes" and ms == pytest.approx(want_bytes / roofline.HBM_BYTES_PER_MS)


def test_flop_count_and_step_mfu():
    lin = torch.nn.Linear(64, 32)
    x = torch.randn(8, 64)
    with FlopCounterMode(display=False) as c:
        lin(x)
    assert c.get_total_flops() == 2 * 8 * 64 * 32
    ctx = SimpleNamespace(flops={"eval_frame": 989e9}, untraced=[None] * 10,
                          untraced_s=2.0, frames_per_step=1)
    # 10 frames of 989 GFLOP in 2 s: 4.945 TFLOP/s of 989: 0.5%
    assert harness.metric_module("step_mfu.eval").read(ctx) == pytest.approx(0.5)
    assert harness.metric_module("step_mfu.eval").read(
        SimpleNamespace(flops={}, untraced=[])) is None


def test_rates_over_the_window():
    ctx = SimpleNamespace(records=[(0, 0.1)] * 30, frames_per_step=4, window_s=6.0)
    assert harness.metric_module("frames_per_s").read(ctx) == 20.0
    assert harness.metric_module("train_samples_per_s").read(ctx) == 20.0
    ctx = SimpleNamespace(records=[(0.0, 0.001 * (i + 1)) for i in range(100)])
    assert harness.metric_module("frame_ms_p95").read(ctx) == pytest.approx(95.0)


def test_profiling_copies_equal_the_ports():
    from racformer_tpu_torch.tools import profile_gpu

    assert profiling.CATEGORIES == profile_gpu._CATEGORIES
    names = {"void gather_fold_kernel<__nv_bfloat16>(...)": 1.0,
             "ncclDevKernel_AllReduce": 2.0, "sm90_xmma_gemm_bf16": 3.0,
             "at::native::vectorized_elementwise_kernel": 4.0,
             "Memcpy HtoD": 5.0, "cub::DeviceRadixSort": 6.0, "foo": 7.0}
    assert profiling.categorize(names) == profile_gpu.categorize(names)
    events = [SimpleNamespace(key="aten::mm", self_cpu_time_total=3000.0,
                              device_type=None, is_user_annotation=False)]
    assert profiling.kernel_times(events, 2) == profile_gpu.kernel_times(events, 2)


def test_roofline_copies_equal_chip_smokes():
    import chip_smoke

    g = torch.Generator().manual_seed(0)
    shape = (3, 40, 30, 16)
    row = torch.randint(0, 40, (3, 200), generator=g, dtype=torch.int32)
    x0p = torch.randint(0, 29, (3, 200), generator=g, dtype=torch.int32)
    w = torch.rand(3, 200, generator=g)
    for kernel, pts, fold in (("gather_fold", (row, x0p, w, w, w), 4),
                              ("patch_gather", (row, x0p, w, w), 1),
                              ("patch_scatter", (row, x0p, w, w), 1),
                              ("patch_corner_grads", (row, x0p, w, w), 1)):
        for es in (2, 4):
            for reread in (False, True):
                assert roofline.bound_ms(kernel, shape, pts, es, fold, reread) == \
                    chip_smoke.bound_ms(kernel, shape, pts, es, fold, reread)
    assert roofline.unique_columns(shape, row, x0p) == chip_smoke.unique_columns(
        shape, row, x0p)
    assert roofline.OPS_PER_POINT_CHANNEL == chip_smoke.OPS_PER_POINT_CHANNEL
    assert roofline.HBM_BYTES_PER_MS == chip_smoke.HBM_BYTES_PER_MS
    assert roofline.F32_OPS_PER_MS == chip_smoke.F32_OPS_PER_MS
    assert math.isclose(roofline.PEAK_BF16_FLOPS, 989e12)
