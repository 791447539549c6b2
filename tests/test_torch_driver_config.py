"""What the port's drivers take from the process and the config on the CPU:

* the float32 precision: both drivers' `main` turns TF32 off for matmuls
  and cuDNN convolutions (`utils/precision.py`) and prints both flags,
  whatever they were before (PyTorch leaves cuDNN's TF32 on by default);
* the nuScenes cameras: both drivers read a split with the config's
  `camera_types` (the front-only 3cam_3rad config names three), the
  reader's six by default, and refuse a count that is not `model.num_cams`.
  The JAX drivers pass no `camera_types`, so the JAX package reads six
  cameras whatever the config names: a fault the port does not copy;
* the front-only _mini config: the eval driver caps the val set at its
  `max_samples` (50) and passes `eval_front_only` on to the metrics.
"""

import pathlib
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from racformer_tpu_torch.config import Config
from racformer_tpu_torch.data import nuscenes as port_nuscenes
from racformer_tpu_torch.eval import __main__ as eval_driver
from racformer_tpu_torch.train import __main__ as train_driver
from tests.test_drivers import TINY
from tests.test_torch_train_driver import six_camera_split

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = REPO / "racformer_tpu_torch" / "configs"
FLAGSHIP = CONFIGS / "racformer_r50_nuimg_704x256_f8.py"
THREE_CAMS = CONFIGS / "racformer_r50_nuimg_704x256_f8_3cam_3rad.py"
THREE_CAMS_MINI = CONFIGS / "racformer_r50_nuimg_704x256_f8_3cam_3rad_mini.py"
FLAGS = ("torch.backends.cuda.matmul.allow_tf32=False",
         "torch.backends.cudnn.allow_tf32=False")


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags on before the driver runs, restored afterwards."""
    for mod in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(mod, "allow_tf32", True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_eval_driver_pins_float32_precision(tf32_on, capsys):
    preds, _ = eval_driver.main(["--config", str(FLAGSHIP), "--device", "cpu",
                                 "--synthetic", "--max-samples", "1",
                                 "--override", *TINY, "decoder.num_layers=1"])
    assert len(preds) == 1
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    out = capsys.readouterr().out
    assert all(flag in out for flag in FLAGS), out[:2000]


def test_train_driver_pins_float32_precision(tf32_on, capsys, monkeypatch,
                                             tmp_path):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    result = train_driver.main([
        "--config", str(FLAGSHIP), "--device", "cpu", "--synthetic",
        "--max-steps", "1", "--work-dir", str(tmp_path / "wd"), "--override",
        *TINY, "decoder.num_layers=1", "evaluation.interval=0"])
    assert result["last_step"] == 1
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    out = capsys.readouterr().out
    assert all(flag in out for flag in FLAGS), out[:2000]


def _split_config(path, pkl, hw, *extra):
    """The config at `path` reading the fabricated split `pkl` (images of
    `hw`) as its val and train sets, at 2 frames of 64x128."""
    h, w = hw
    return Config.fromfile(str(path)).merge_override([
        f"data.val.ann_file={pkl}", f"data.train.ann_file={pkl}",
        f"ida_aug.src_dim=({h},{w})", "ida_aug.final_dim=(64,128)",
        "model.num_frames=2", "model.image_hw=(64,128)", "model.max_gt=8",
        "radar.max_points=64", *extra])


def _model(cfg):
    """What the dataset builders read of the model."""
    m = cfg["model"]
    return types.SimpleNamespace(num_cams=m["num_cams"], num_frames=2,
                                 image_hw=(64, 128), max_gt=8)


@pytest.mark.parametrize("config,cams", [
    (THREE_CAMS, ("CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT")),
    (FLAGSHIP, port_nuscenes.DEFAULT_CAMERAS)])
def test_drivers_read_the_config_cameras(tmp_path, config, cams):
    """On a nuScenes-layout split the 3cam_3rad config yields 3 images per
    frame, the flagship 6, through the eval driver's val set and the train
    driver's training set alike."""
    pkl, hw = six_camera_split(tmp_path)
    cfg = _split_config(config, pkl, hw)
    model = _model(cfg)
    assert eval_driver.camera_types(cfg, model) == tuple(cams)
    val = eval_driver.build_dataset(cfg, model, synthetic=False)
    train = train_driver.train_dataset(cfg, model, 1, synthetic=False, seed=0)
    for ds in (val, train):
        assert isinstance(ds, port_nuscenes.NuScenesRadarDataset)
        assert ds.camera_types == list(cams)
        assert ds[0]["imgs"].shape[:2] == (2, len(cams))


@pytest.mark.parametrize("config,extra", [
    (THREE_CAMS, ["model.num_cams=6"]),
    (FLAGSHIP, ["camera_types=['CAM_FRONT','CAM_BACK']"])])
def test_drivers_refuse_cameras_the_model_does_not_take(tmp_path, config,
                                                        extra):
    pkl, hw = six_camera_split(tmp_path)
    cfg = _split_config(config, pkl, hw, *extra)
    model = _model(cfg)
    with pytest.raises(ValueError, match="num_cams"):
        eval_driver.build_dataset(cfg, model, synthetic=False)
    with pytest.raises(ValueError, match="num_cams"):
        train_driver.train_dataset(cfg, model, 1, synthetic=False, seed=0)


def test_mini_config_caps_the_val_set_without_reading_images(tmp_path,
                                                            monkeypatch):
    """60 keyframes in the nuScenes info layout whose images do not exist:
    the _mini config's val set holds 50 of them, the first by time, and
    building it reads no image."""
    infos = [dict(token=f"k{i}", scene_token=f"scene-{i // 20}",
                  timestamp=1_533_151_603_547_590 + 500_000 * (59 - i),
                  cams={name: dict(data_path=str(tmp_path / f"k{i}_{name}.jpg"))
                        for name in port_nuscenes.DEFAULT_CAMERAS},
                  radar_points=np.zeros((0, 7), np.float32),
                  gt_boxes=np.zeros((0, 9), np.float32),
                  gt_labels=np.zeros(0, np.int64), sweeps_cam=[])
             for i in range(60)]
    pkl = tmp_path / "nuscenes_infos_val_sweep.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"infos": infos}, f)
    def no_image(self, path):
        raise AssertionError(f"read {path}")

    monkeypatch.setattr(port_nuscenes.NuScenesRadarDataset, "_load_image",
                        no_image)
    cfg = Config.fromfile(str(THREE_CAMS_MINI)).merge_override(
        [f"data.val.ann_file={pkl}"])
    assert cfg["max_samples"] == 50 and cfg["eval_front_only"] is True
    model = _model(cfg)
    ds = eval_driver.build_dataset(cfg, model, synthetic=False,
                                   max_samples=cfg.get("max_samples"))
    assert isinstance(ds, port_nuscenes.NuScenesRadarDataset)
    assert len(ds) == 50
    assert [info["token"] for info in ds.infos] == [f"k{i}" for i in
                                                    range(59, 9, -1)]
    assert ds.camera_types == ["CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT"]


def test_eval_driver_passes_front_only_to_the_metrics(monkeypatch, tf32_on):
    from racformer_tpu_torch.eval import metrics

    seen = []
    real = metrics.nuscenes_metrics

    def spy(preds, gts, **kw):
        seen.append(kw["front_only"])
        return real(preds, gts, **kw)

    monkeypatch.setattr(metrics, "nuscenes_metrics", spy)
    preds, m = eval_driver.main([
        "--config", str(THREE_CAMS_MINI), "--device", "cpu", "--synthetic",
        "--max-samples", "1", "--override", *TINY, "model.num_cams=3",
        "decoder.num_layers=1"])
    assert len(preds) == 1 and m is not None
    assert seen == [True]
