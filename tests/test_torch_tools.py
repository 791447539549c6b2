"""The port's copies of the JAX package's tools against their originals, on
the CPU, and their command lines:

* `tools/gen_sweep_info.py`: the infos pickle of both `main`s key for key on
  the fabricated nuScenes tables of `tests/test_gen_sweep_info.py` (radar
  aggregation, camera sweeps, GT with velocity and attributes, a bike rack
  with a bicycle inside it and one outside), the port's run from its CLI;
* `tools/eval_plots.py`: `render_all`'s file set and its `.tex` table byte
  for byte, and the CLI on a `--dump-eval` pickle;
* `tools/visualize.py`: the numeric helpers bit for bit, the PNGs of
  `render_sample` and the GIF of `create_video`, both CLI modes;
* `tools/profile_gpu.py` (no original: its category table is the
  counterpart of `tools/profile_tpu.py`'s): `categorize` on a fixed table
  of CUDA kernel names, `trace_and_summarize` on a tiny CPU step;
* `tools/vod_smoke.py`: its fixture equal to the original's, and its CLI
  on the CPU for one epoch, writing `VOD_SMOKE.json` with the original's
  fields, its summary over every step.
"""

import json
import os
import pathlib
import pickle
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch

from racformer_tpu.eval.metrics import nuscenes_metrics as jax_metrics
from racformer_tpu.tools import eval_plots as jax_plots
from racformer_tpu.tools import gen_sweep_info as jax_gen
from racformer_tpu.tools import visualize as jax_vis

from racformer_tpu_torch.eval.metrics import nuscenes_metrics
from racformer_tpu_torch.tools import eval_plots, gen_sweep_info, profile_gpu
from racformer_tpu_torch.tools import visualize
from tests.test_gen_sweep_info import _add_annotations, _fabricate_tables
from tests.test_metrics import make_perfect_case

REPO = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def _cli(module, *args):
    proc = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def assert_same(a, b, path="infos"):
    """a and b equal key for key: dicts with the same keys, sequences of
    the same length, arrays of the same dtype and bits, equal scalars."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _bike_rack(tmp_path, version="v1.0-test"):
    """A bike rack at lidar (6, -2, 0) with a bicycle inside it and one
    outside, so that `in_bikerack` and `bikeracks` carry something."""
    base = tmp_path / version
    anns = json.loads((base / "sample_annotation.json").read_text())
    for tok, inst, xyz, size in (
            ("rack", "inst_rack", [16.0, -2.0, 0.0], [1.5, 3.0, 1.0]),
            ("bike_in", "inst_bike", [16.3, -2.4, 0.1], [0.6, 1.7, 1.2]),
            ("bike_out", "inst_bike2", [20.0, 4.0, 0.1], [0.6, 1.7, 1.2])):
        anns.append(dict(token=tok, sample_token="samp0", instance_token=inst,
                         translation=xyz, size=size,
                         rotation=[np.cos(0.2), 0, 0, np.sin(0.2)], prev="",
                         next="", attribute_tokens=[], num_lidar_pts=4,
                         num_radar_pts=1))
    (base / "sample_annotation.json").write_text(json.dumps(anns))
    inst = json.loads((base / "instance.json").read_text())
    inst += [dict(token="inst_rack", category_token="cat_rack"),
             dict(token="inst_bike", category_token="cat_bike"),
             dict(token="inst_bike2", category_token="cat_bike")]
    (base / "instance.json").write_text(json.dumps(inst))
    cats = json.loads((base / "category.json").read_text())
    cats += [dict(token="cat_rack", name="static_object.bicycle_rack"),
             dict(token="cat_bike", name="vehicle.bicycle")]
    (base / "category.json").write_text(json.dumps(cats))


@pytest.fixture
def tables_dir(tmp_path, rng):
    _fabricate_tables(tmp_path, rng)
    _add_annotations(tmp_path)
    _bike_rack(tmp_path)
    infos = tmp_path / "infos.pkl"
    with open(infos, "wb") as f:
        pickle.dump({"infos": [dict(token="samp0", timestamp=1_000_000)]}, f)
    return tmp_path


def test_gen_sweep_info_infos_equal_the_original(tables_dir, monkeypatch):
    """Both `main`s on the same tables and info pickle write the same infos
    key for key; the port's from its command line."""
    args = ["--dataroot", str(tables_dir), "--version", "v1.0-test",
            "--infos", str(tables_dir / "infos.pkl"), "--nsweeps", "2"]
    monkeypatch.setattr(sys, "argv", ["gen_sweep_info", *args, "--out",
                                      str(tables_dir / "jax.pkl")])
    jax_gen.main()
    out = _cli("racformer_tpu_torch.tools.gen_sweep_info", *args, "--out",
               tables_dir / "port.pkl")
    assert "wrote 1 infos" in out
    with open(tables_dir / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tables_dir / "port.pkl", "rb") as f:
        got = pickle.load(f)
    assert_same(got, want)
    info = got["infos"][0]
    assert info["radar_points"].shape == (4, 7)
    assert len(info["sweeps_cam"]) == 2
    gt = {g["category"]: g for g in info["gt_anno"]}
    assert gt["vehicle.car"]["attribute"] == "vehicle.moving"
    assert [g["in_bikerack"] for g in info["gt_anno"]
            if g["category"] == "vehicle.bicycle"] == [True, False]
    assert info["bikeracks"].shape == (1, 7)


def test_gen_sweep_info_functions_equal_the_original(tables_dir, rng):
    tables = gen_sweep_info.Tables(str(tables_dir), "v1.0-test")
    jtables = jax_gen.Tables(str(tables_dir), "v1.0-test")
    for q in ([1, 0, 0, 0], [np.cos(0.3), 0.1, -0.2, np.sin(0.3)]):
        np.testing.assert_array_equal(gen_sweep_info.quat_to_rot(q),
                                      jax_gen.quat_to_rot(q))
        for inv in (False, True):
            np.testing.assert_array_equal(
                gen_sweep_info.transform_matrix([1, -2, 0.5], q, inv),
                jax_gen.transform_matrix([1, -2, 0.5], q, inv))
    path = str(tables_dir / "sweeps" / "r0.pcd")
    np.testing.assert_array_equal(gen_sweep_info.read_pcd(path),
                                  jax_gen.read_pcd(path))
    np.testing.assert_array_equal(
        gen_sweep_info.aggregate_radar(tables, "samp0", 2),
        jax_gen.aggregate_radar(jtables, "samp0", 2))
    assert_same(gen_sweep_info.collect_camera_sweeps(tables, "samp0"),
                jax_gen.collect_camera_sweeps(jtables, "samp0"))
    gt = gen_sweep_info.collect_gt(tables, "samp0")
    assert_same(gt, jax_gen.collect_gt(jtables, "samp0"))
    np.testing.assert_array_equal(gen_sweep_info.bikerack_boxes(gt),
                                  jax_gen.bikerack_boxes(gt))
    for p in rng.normal(size=(8, 3)) * 3 + [6, -2, 0]:
        assert (gen_sweep_info.point_in_any_box(p, gt)
                == jax_gen.point_in_any_box(p, gt))
    assert gen_sweep_info.ATTRIBUTES == jax_gen.ATTRIBUTES
    assert gen_sweep_info.RADAR_USE_DIMS == jax_gen.RADAR_USE_DIMS
    assert (gen_sweep_info.CAMERA_CHANNELS, gen_sweep_info.RADAR_CHANNELS) == (
        jax_gen.CAMERA_CHANNELS, jax_gen.RADAR_CHANNELS)


def _degraded_case():
    """`tests/test_eval_plots.py`'s case: perfect predictions moved and
    rescored so that the curves are not trivial."""
    preds, gts = make_perfect_case(n_samples=3, n_per=8)
    rng = np.random.default_rng(1)
    for p in preds:
        p["bboxes"][:, 0] += rng.normal(scale=0.8, size=len(p["bboxes"]))
        p["scores"] = rng.uniform(0.1, 1.0, size=len(p["scores"]))
    return preds, gts


PLOT_SET = {"summary.png", "metrics_table.tex"}


def test_eval_plots_write_the_original_set(tmp_path):
    preds, gts = _degraded_case()
    got = tmp_path / "port"
    want = tmp_path / "jax"
    eval_plots.render_all(nuscenes_metrics(preds, gts, return_curves=True),
                          str(got))
    jax_plots.render_all(jax_metrics(preds, gts, return_curves=True),
                         str(want))
    files = sorted(os.listdir(got))
    assert files == sorted(os.listdir(want))
    assert PLOT_SET <= set(files)
    assert any(f.endswith("_pr.png") for f in files)
    assert any(f.endswith("_tp.png") for f in files)
    assert sum(f.startswith("dist_pr_") for f in files) == 4
    assert ((got / "metrics_table.tex").read_bytes()
            == (want / "metrics_table.tex").read_bytes())


def test_eval_plots_cli_on_a_dump(tmp_path):
    preds, gts = _degraded_case()
    dump = tmp_path / "dump.pkl"
    with open(dump, "wb") as f:
        pickle.dump((preds, gts), f)
    out = _cli("racformer_tpu_torch.tools.eval_plots", dump, tmp_path / "cli")
    jax_plots.render_all(jax_metrics(preds, gts, return_curves=True),
                         str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "cli")) == sorted(
        os.listdir(tmp_path / "jax"))
    assert ((tmp_path / "cli" / "metrics_table.tex").read_bytes()
            == (tmp_path / "jax" / "metrics_table.tex").read_bytes())
    assert "'mAP'" in out and "'NDS'" in out


def _results(rng, n=3):
    """(sample, pred) pairs in the layout `render_sample` reads: one camera
    looking along +x, a few boxes ahead of it, radar points."""
    K = np.array([[60, 0, 64], [0, 60, 32], [0, 0, 1]], np.float64)
    R = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float64)
    l2i = np.eye(4)
    l2i[:3, :3] = K @ R
    out = []
    for _ in range(n):
        boxes = np.zeros((5, 9), np.float32)
        boxes[:, 0] = rng.uniform(5, 30, 5)
        boxes[:, 1] = rng.uniform(-8, 8, 5)
        boxes[:, 3:6] = rng.uniform(0.5, 4, (5, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, 5)
        sample = dict(imgs=rng.integers(0, 255, (1, 64, 128, 3)).astype(
                          np.float32),
                      lidar2img=l2i[None].astype(np.float32),
                      gt_bboxes=boxes[:3],
                      radar_points=rng.normal(size=(40, 7)).astype(np.float32)
                      * 10)
        pred = dict(bboxes=boxes, labels=rng.integers(0, 10, 5),
                    scores=rng.uniform(0.2, 1.0, 5), valid=np.ones(5, bool))
        out.append((sample, pred))
    return out


def test_visualize_helpers_bit_for_bit(rng):
    boxes = rng.normal(size=(12, 9)) * [10, 10, 1, 2, 4, 2, 3, 1, 1]
    boxes[:, 3:6] = np.abs(boxes[:, 3:6])
    for b in boxes:
        np.testing.assert_array_equal(visualize.box_corners_bev(b),
                                      jax_vis.box_corners_bev(b))
    (sample, _), = _results(rng, 1)
    l2i = sample["lidar2img"][0]
    behind = boxes.copy()
    behind[:4, 0] = -20  # behind the camera: None on both sides
    got = visualize.project_boxes_to_image(behind, l2i, (64, 128))
    want = jax_vis.project_boxes_to_image(behind, l2i, (64, 128))
    assert [g is None for g in got] == [w is None for w in want]
    assert any(g is None for g in got) and any(g is not None for g in got)
    for g, w in zip(got, want):
        if g is not None:
            np.testing.assert_array_equal(g, w)
    assert visualize.CLASS_COLORS == jax_vis.CLASS_COLORS


def test_visualize_writes_png_and_gif(tmp_path, rng):
    from PIL import Image

    paths = []
    for i, (sample, pred) in enumerate(_results(rng)):
        paths.append(str(tmp_path / f"{i}.png"))
        visualize.render_sample(sample, pred, paths[-1])
        assert Image.open(paths[-1]).format == "PNG"
    visualize.create_video(paths, str(tmp_path / "scene.gif"), fps=2)
    gif = Image.open(tmp_path / "scene.gif")
    assert gif.format == "GIF" and gif.n_frames == 3
    # an .mp4 without ffmpeg falls back to a GIF, as in the original
    if not __import__("shutil").which("ffmpeg"):
        visualize.create_video(paths, str(tmp_path / "scene2.mp4"))
        assert (tmp_path / "scene2.gif").is_file()


def test_visualize_cli_modes(tmp_path, rng):
    results = tmp_path / "results.pkl"
    with open(results, "wb") as f:
        pickle.dump(_results(rng), f)
    _cli("racformer_tpu_torch.tools.visualize", "bev", "--results", results,
         "--out", tmp_path / "bev")
    assert sorted(os.listdir(tmp_path / "bev")) == [
        "00000.png", "00001.png", "00002.png"]
    _cli("racformer_tpu_torch.tools.visualize", "video", "--results",
         results, "--out", tmp_path / "scene.gif", "--fps", "2")
    from PIL import Image

    assert Image.open(tmp_path / "scene.gif").n_frames == 3


# a fixed table of kernel names as torch.profiler gives them on the card
KERNELS = {
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*, unsigned long, "
    "ncclWork*)": "collectives",
    "void gather_fold_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int const*, "
    "int const*, float const*, float const*, float const*, float*, int, int, "
    "int, int, int, int)": "hand kernels (K1-K4)",
    "void patch_gather_kernel<float>(float const*, int const*)":
        "hand kernels (K1-K4)",
    "void corner_grads_kernel<__nv_bfloat16>(__nv_bfloat16 const*)":
        "hand kernels (K1-K4)",
    "void accumulate_tiles<__nv_bfloat16>(__nv_bfloat16 const*, int4 const*)":
        "hand kernels (K1-K4)",
    "count_chunks(int const*, int*, int, int)": "hand kernels (K1-K4)",
    "finish_rows(int const*, float const*)": "hand kernels (K1-K4)",
    "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x16_warpgroupsize1x"
    "1x1_execute_segment_k_off_kernel__5x_cublas": "matmul/conv",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>"
    "(cutlass_80_simt_sgemm_128x64_8x5_nn_align1::Params)": "matmul/conv",
    "sm90_xmma_fprop_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nchw":
        "matmul/conv",
    "void conv2d_grouped_direct_kernel<float, float, float, float, float, "
    "true, false, 0, 0, 0>(cudnn::kernel_params)": "matmul/conv",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float, "
    "false, true, (cudnnKernelDataType_t)2>(cudnn::engines_precompiled::"
    "nchw2nhwc_params_t<float>, float const*, float*)": "copy/layout",
    "Memcpy HtoD (Pageable -> Device)": "copy/layout",
    "Memset (Device)": "copy/layout",
    "void at::native::unrolled_elementwise_kernel<at::native::"
    "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::"
    "operator()() const::{lambda()#7}::operator()() const::{lambda(float)#1}"
    ">": "copy/layout",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, "
    "unsigned int, 4, 64, 64>": "copy/layout",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "FillFunctor<float>, at::detail::Array<char*, 1> >": "copy/layout",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, float, "
    "float>::operator()>, unsigned int, float, 4> >": "reduce/sort",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>":
        "reduce/sort",
    "void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>":
        "reduce/sort",
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>":
        "reduce/sort",
    "void at::native::batch_norm_collect_statistics_kernel<float, float, "
    "float, int>": "reduce/sort",
    "void at::native::index_elementwise_kernel<128, 4, at::native::"
    "gpu_index_kernel<...> >": "gather/scatter",
    "void at::native::_scatter_gather_elementwise_kernel<128, 4>":
        "gather/scatter",
    "void at::native::indexFuncLargeIndex<float, long, unsigned int, 2, 2, "
    "-2, true>": "gather/scatter",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, at::detail::Array<char*, 3> >": "elementwise",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_"
    "nocast<at::native::BinaryFunctor<float, float, float, at::native::"
    "binary_internal::MulFunctor<float> > >": "elementwise",
    "void foo_kernel(int)": "other",
}


def test_profile_gpu_categorizes_kernel_names():
    table = {name: float(i + 1) for i, name in enumerate(KERNELS)}
    want = {}
    for name, cat in KERNELS.items():
        want[cat] = want.get(cat, 0.0) + table[name]
        assert profile_gpu.categorize({name: 1.0}) == {cat: 1.0}, name
    assert profile_gpu.categorize(table) == want
    # every category of the table, and "other", is reached
    assert set(want) == {c for c, _ in profile_gpu._CATEGORIES} | {"other"}


def test_profile_gpu_trace_and_summarize_on_a_cpu_step(tmp_path):
    """No CUDA device here: the summary is of the aten ops' host time, says
    so, partitions by_op into by_category, and writes the Chrome trace."""
    lin = torch.nn.Linear(32, 16)
    x = torch.randn(8, 32)
    lines, calls = [], []

    def step(i):
        calls.append(i)
        return torch.relu(lin(x)).sum()

    out = profile_gpu.trace_and_summarize(step, n_steps=3, outdir=str(tmp_path),
                                          top=5, printer=lines.append)
    assert calls == [0, 1, 2]
    assert set(out) == {"by_op", "by_category"}
    assert "aten::addmm" in out["by_op"] and all(
        v >= 0 for v in out["by_op"].values())
    assert out["by_category"].get("matmul/conv", 0) >= out["by_op"]["aten::addmm"]
    assert sum(out["by_category"].values()) == pytest.approx(
        sum(out["by_op"].values()))
    assert "not a device time" in lines[0]
    assert (tmp_path / "trace.json").is_file()


def test_vod_smoke_fixture_equals_the_original(tmp_path):
    import importlib.util

    from racformer_tpu_torch.tools import vod_smoke

    spec = importlib.util.spec_from_file_location(
        "vod_smoke_original", REPO / "docs" / "experiments" / "vod_smoke.py")
    original = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(original)
    with open(vod_smoke.build_fixture(str(tmp_path / "port")), "rb") as f:
        got = pickle.load(f)
    with open(original.build_fixture(str(tmp_path / "jax")), "rb") as f:
        want = pickle.load(f)
    assert len(got) == len(want) == 48
    for g, w in zip(got, want):
        for key in ("image_path",):
            g["image"][key] = os.path.basename(g["image"][key])
            w["image"][key] = os.path.basename(w["image"][key])
        g["radar_path"] = os.path.basename(g["radar_path"])
        w["radar_path"] = os.path.basename(w["radar_path"])
        assert_same(g, w)
    for name in ("r5.bin", "i5.png"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    overrides = vod_smoke.tiny_overrides("x")
    assert "batch_size_per_chip=8" in overrides  # the original's 8 devices
    assert {"total_epochs=40", "optimizer.warmup_steps=20",
            "optimizer.base_lr=4e-4", "accumulate_steps=1"} <= set(overrides)


def test_vod_smoke_cli_on_the_cpu(tmp_path):
    """One epoch (6 steps of the global batch 8) through the port's
    drivers on the CPU: VOD_SMOKE.json with the original's fields (its
    losses from the log's lines, every 50th step), the summary over every
    step. `--plain` is accepted (on the CPU the plain versions run
    anyway)."""
    out = _cli("racformer_tpu_torch.tools.vod_smoke", tmp_path, "--device",
               "cpu", "--epochs", "1", "--plain")
    res = json.loads((tmp_path / "VOD_SMOKE.json").read_text())
    assert set(res) == {"losses_first5", "losses_last5", "n_loss_lines",
                        "in_training_eval", "untrained", "trained"}
    assert res["n_loss_lines"] == 1 and np.isfinite(res["losses_first5"]).all()
    assert [r["step"] for r in res["in_training_eval"]] == [6]
    for k in ("untrained", "trained"):
        assert set(res[k]) == {"mAP3D_all", "mAP3D_corridor"}
        assert all(0.0 <= v <= 1.0 for v in res[k].values())
    assert "loss first-fifth mean" in out
    assert "6 steps, largest finite grad_norm" in out
    # the in-training KITTI eval keeps the best by mAP3D_all (the VoD
    # config's inherited save_best="NDS" would never save one)
    best = json.loads((tmp_path / "wd1" / "best" / "metrics.json").read_text())
    assert best["step"] == 6 and "mAP3D_all" in best
