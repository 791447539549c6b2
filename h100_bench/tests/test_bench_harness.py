"""The harness finds every piece of a cell by name, a new cell takes only
new files, the import check compares whole top-level names, and a machine
without a card gets no result."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from h100_bench import harness
from h100_bench.run import forbidden_modules
from h100_bench.traffic import generator

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100_bench"


def test_every_piece_of_every_cell_is_found_by_name():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        cfg = harness.load_config(bench, w["config"])
        assert cfg["name"] == w["config"]
        assert generator.load_mix(w["traffic"])["kind"] in harness.DRIVERS
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v > 0 for v in limits.values())
        for trace in (False, True):
            names = [m["name"] for m in harness.cell_metrics(bench, w["name"], trace)]
            assert names, (w["name"], trace)
            for name in names:
                assert callable(harness.metric_module(name).read)
        assert "setup_s" in [m["name"] for m in harness.cell_metrics(bench, w["name"], False)]
    for c in bench["configs"]:
        assert c["file"].startswith("h100_bench/configs/")


def test_configs_are_the_ports_config_files():
    """Each configuration's file holds the port's config as it is run: the
    model, decoder, radar, depth, optimizer and eval blocks equal to those
    the port reads from its own file, only `reduced` keys changed."""
    from racformer_tpu_torch.config import Config

    bench = harness.load_benchmark()
    for c in bench["configs"]:
        cfg = harness.load_config(bench, c["name"])
        port = json.loads(json.dumps(dict(Config.fromfile(str(ROOT / cfg["port_config"]))),
                                     default=list))
        for key, value in port.items():
            if key in c["reduced"] or key == "_base_":
                continue
            assert cfg[key] == value, key
        assert cfg["reduced"] == c["reduced"]
        assert len(cfg["rig"]["camera_yaw_deg"]) == cfg["model"]["num_cams"]


def test_import_check_compares_whole_top_level_names():
    assert forbidden_modules(["racformer_tpu_torch", "racformer_tpu_torch.ops"]) == []
    assert forbidden_modules(["racformer_tpu.config"]) == ["racformer_tpu"]
    assert forbidden_modules(["jaxlib.xla", "jax", "flax.linen", "jaxtyping"]) == [
        "flax", "jax", "jaxlib"]


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "flagship.stream", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's folder
    (no program) exits non-zero with no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                        "flagship.stream", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


ADD_CELL = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])
from h100_bench import harness
from h100_bench.tests import tiny
from h100_bench.traffic import generator
load = generator.load_mix
generator.load_mix = lambda n: dict(load(n), **tiny.TINY_MIX)
cfg = json.loads(open(sys.argv[1] + "/h100_bench/configs/flagship_b.json").read())
r = harness.run_cell("flagship_b.stream2", 7, 0.5, False, "cpu", time.perf_counter(),
                     bench=harness.load_benchmark(), cfg=None)
print(json.dumps(r))
"""


def test_a_new_cell_config_mix_and_metric_are_new_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a metric and a
    cell as new files and new entries in BENCHMARK.json, and runs it."""
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "h100_bench"
    cfg = json.loads((BENCH / "configs" / "flagship.json").read_text())
    from h100_bench.tests.tiny import tiny_cfg

    cfg.update({k: v for k, v in tiny_cfg().items() if k in ("model", "decoder", "radar", "rig", "depth")})
    cfg["name"] = "flagship_b"
    (b / "configs" / "flagship_b.json").write_text(json.dumps(cfg))
    (b / "traffic" / "stream2.json").write_text(json.dumps(
        dict(generator.load_mix("stream"), radar_column_share=0.5)))
    (b / "metrics" / "frames_total.py").write_text(
        "def read(ctx):\n    return len(ctx.records) * ctx.frames_per_step\n")
    (b / "limits" / "flagship_b.stream2.json").write_text(
        json.dumps({"score_gap": 1e-4, "box_gap": 1e-4}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "flagship_b", "source": "test",
                             "file": "h100_bench/configs/flagship_b.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "flagship_b.stream2", "config": "flagship_b",
                               "traffic": "stream2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "frames_total", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "streaming step", "moves": "frames_per_s",
                               "workloads": ["flagship_b.stream2"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "frames_per_s":
            m["workloads"].append("flagship_b.stream2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in BENCH.rglob("*.py")}
    p = subprocess.run([sys.executable, "-c", ADD_CELL, str(tmp_path), str(ROOT)],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    for q, text in before.items():
        rel = q.relative_to(BENCH)
        assert (b / rel).read_bytes() == text  # no file of the benchmark edited
