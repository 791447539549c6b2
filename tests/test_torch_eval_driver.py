"""The port's eval driver, `python -m racformer_tpu_torch.eval`, on the CPU
(`--device cpu`: every kernel's plain version) at the tiny overrides of
`tests/test_drivers.py`: the three protocols end to end, and the checkpoint
forms it reads and refuses."""

import os
import pathlib
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from racformer_tpu.model import RaCFormer as JaxRaCFormer
from racformer_tpu.tools.convert_weights import convert_state_dict

from racformer_tpu_torch.eval import __main__ as driver
from racformer_tpu_torch.eval import offline
from racformer_tpu_torch.model import RaCFormer, config_kwargs, random_init_
from racformer_tpu_torch.config import Config
from tests.test_drivers import TINY

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = "racformer_tpu_torch/configs/racformer_r50_nuimg_704x256_f8.py"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny runs: the test runner's
    workers share the cores, and spinning thread pools there cost ~50x."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_model():
    cfg = Config.fromfile(str(REPO / CONFIG)).merge_override(TINY)
    return RaCFormer(**config_kwargs(cfg))


@pytest.mark.parametrize("protocol", [[], ["--streaming"],
                                      ["--streaming", "--streams", "2"]])
def test_driver_runs_each_protocol(protocol):
    proc = subprocess.run(
        [sys.executable, "-m", "racformer_tpu_torch.eval", "--config", CONFIG,
         "--device", "cpu", "--synthetic", "--max-samples", "3", *protocol,
         "--override", *TINY],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "eval: 3 samples" in proc.stdout
    assert '"NDS"' in proc.stdout and '"mAP"' in proc.stdout


def test_pth_checkpoint_loads_and_sets_legacy_version(tmp_path, monkeypatch,
                                                      capsys):
    """A .pth state dict of a seeded port model, with a `version` field:
    its weights load as they were saved, and the version reaches the box
    decode's `legacy_version`."""
    model = tiny_model()
    random_init_(model, torch.Generator().manual_seed(7))
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": model.state_dict(), "version": "v0.17.1"}, path)

    fresh = tiny_model()
    assert driver.load_checkpoint(fresh, str(path), "v1.0.0") == "v0.17.1"
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

    seen, decode_config = [], offline.decode_config

    def spy(eval_cfg=None):
        seen.append(dict(eval_cfg))
        return decode_config(eval_cfg)

    monkeypatch.setattr(offline, "decode_config", spy)
    preds, m = driver.main(["--config", str(REPO / CONFIG), "--device", "cpu",
                            "--synthetic", "--max-samples", "2",
                            "--checkpoint", str(path), "--override", *TINY])
    assert [c["legacy_version"] for c in seen] == ["v0.17.1"]
    assert len(preds) == 2 and "NDS" in m
    assert "eval: 2 samples" in capsys.readouterr().out


def test_numpy_variables_pickle_loads(tmp_path):
    """A pickled {'params', 'batch_stats', 'version'} file with numpy
    leaves (the JAX package's layout) loads through state_dict_from_jax."""
    model = tiny_model()
    random_init_(model, torch.Generator().manual_seed(8))
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    cfg = config_kwargs(Config.fromfile(str(REPO / CONFIG)).merge_override(TINY))
    jmodel = JaxRaCFormer(**{k: v for k, v in cfg.items() if k != "decoder"},
                          decoder=cfg["decoder"], trunk_dtype=jnp.float32,
                          train_mode=False)
    B, T, N, H, W, P = 1, 2, 2, 64, 128, 8
    args = (jnp.zeros((B, T, N, H, W, 3)), jnp.zeros((B, T, P, 7)),
            jnp.ones((B, T, P), bool), jnp.zeros((B, T, N, H, W)),
            jnp.zeros((B, T, N, H, W)), jnp.tile(jnp.eye(4), (B, T, N, 1, 1)),
            jnp.tile(jnp.eye(4), (B, T, N, 1, 1)), jnp.zeros((B, T)))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
    variables, unmatched = convert_state_dict(sd, template, strict=True)
    assert unmatched == []
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    variables["version"] = "v0.17.1"
    path = tmp_path / "variables.pkl"
    with open(path, "wb") as f:
        pickle.dump(variables, f)

    fresh = tiny_model()
    assert driver.load_checkpoint(fresh, str(path), "v1.0.0") == "v0.17.1"
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_plot_dir_writes_the_val_py_plot_set(tmp_path):
    """--plot-dir renders the nuScenes curves and table, as `val.py
    --plot-dir` does: the same file set and the same `.tex` table, byte
    for byte, as the JAX package's metrics and `render_all` give on the
    predictions the driver dumped."""
    import matplotlib

    matplotlib.use("Agg")
    from racformer_tpu.eval.offline import detection_metrics
    from racformer_tpu.tools.eval_plots import render_all

    plots, dump = tmp_path / "plots", tmp_path / "dump.pkl"
    preds, metrics = driver.main([
        "--config", str(REPO / CONFIG), "--device", "cpu", "--synthetic",
        "--max-samples", "3", "--plot-dir", str(plots), "--dump-eval",
        str(dump), "--override", *TINY])
    assert len(preds) == 3 and "curves" in metrics
    with open(dump, "rb") as f:
        preds, gts = pickle.load(f)
    cfg = Config.fromfile(str(REPO / CONFIG))
    want = detection_metrics(preds, gts, class_names=list(cfg["class_names"]),
                             return_curves=True)
    render_all(want, str(tmp_path / "val_py"))
    files = sorted(os.listdir(plots))
    assert files == sorted(os.listdir(tmp_path / "val_py"))
    assert {"summary.png", "metrics_table.tex", "dist_pr_2.0.png"} <= set(files)
    assert any(f.endswith("_pr.png") for f in files)
    assert ((plots / "metrics_table.tex").read_bytes()
            == (tmp_path / "val_py" / "metrics_table.tex").read_bytes())


def test_refusals(tmp_path, monkeypatch):
    """A pickle of JAX arrays or an orbax work_dir is refused with a pointer
    to the converter script (reading them needs JAX); the default device
    needs CUDA."""
    path = tmp_path / "jax.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": {"w": jnp.ones(3)}}, f)
    with pytest.raises(SystemExit, match="scripts/jax_checkpoint_to_torch.py"):
        driver.load_checkpoint(tiny_model(), str(path), "v1.0.0")
    with pytest.raises(SystemExit, match="scripts/jax_checkpoint_to_torch.py"):
        driver.load_checkpoint(tiny_model(), str(tmp_path), "v1.0.0")
    base = ["--config", CONFIG, "--synthetic"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        driver.main(base)
