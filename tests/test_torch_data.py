"""The port's data layer (`racformer_tpu_torch/data/`) against the JAX
package's: the nuScenes and VoD readers on fabricated fixtures (every key,
dtype and value of every sample equal), collation, the depth / RCS
rasterizers, the augmentation, and the port's native library, built from
its own source, against the numpy and PIL paths."""

import io
import pickle

import numpy as np
import pytest
from PIL import Image

from racformer_tpu.data import collate as jcollate
from racformer_tpu.data import depth_maps as jdepth
from racformer_tpu.data import native as jnative
from racformer_tpu.data import transforms as jtransforms
from racformer_tpu.data.nuscenes import NuScenesRadarDataset as JaxNuScenes
from racformer_tpu.data.vod import VoDDataset as JaxVoD

from racformer_tpu_torch.data import collate, depth_maps, native, transforms
from racformer_tpu_torch.data.nuscenes import NuScenesRadarDataset
from racformer_tpu_torch.data.vod import VoDDataset


def assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (str, bytes)):
            assert g == w, k
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


def pinhole(f=100.0, cx=50.0, cy=50.0):
    M = np.eye(4, dtype=np.float32)
    M[0, 0], M[1, 1] = f, f
    M[0, 2], M[1, 2] = cx, cy
    return M


def nuscenes_fixture(tmp_path, rng):
    """Four samples in two scenes: JPEG and PNG images on disk at 128x256,
    cameras given by lidar2img or by sensor2lidar extrinsics and
    intrinsics, history sweeps with radar points, 9-dim boxes and 7-dim
    boxes whose velocity comes from the annotation records (attributes,
    point counts, bike-rack flags), bike racks, lidar points for the depth
    target and the ego origin."""
    srcH, srcW = 128, 256
    R = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
    y, x = np.mgrid[0:srcH, 0:srcW]

    def image(name, shift, fmt):
        img = np.stack([(x + shift) % 256, (y * 2) % 256, (x + y) % 256],
                       -1).astype(np.uint8)
        p = tmp_path / f"{name}.{fmt}"
        Image.fromarray(img).save(p, quality=95) if fmt == "jpg" else \
            Image.fromarray(img).save(p)
        return str(p)

    def cam(ts, name, shift, fmt, extrinsic):
        c = dict(timestamp=ts, data_path=image(name, shift, fmt))
        if extrinsic:
            c.update(sensor2lidar_rotation=R,
                     sensor2lidar_translation=np.array([0.0, 0.2, 1.6]),
                     cam_intrinsic=np.array([[100.0, 0, srcW / 2],
                                             [0, 100.0, srcH / 2], [0, 0, 1]]))
        else:
            c["lidar2img"] = pinhole(100, srcW / 2, srcH / 2)
        return c

    base = 1_600_000_000_000_000
    infos = []
    for i in range(4):
        ts = base + 500_000 * i
        gt = rng.normal(size=(5, 9 if i % 2 else 7)).astype(np.float32) * 8
        gt[:, 3:6] = np.abs(gt[:, 3:6]) + 0.5
        anno = [dict(center=list(gt[j, :3] + [0.01, -0.02, 0.3]),
                     attribute=("vehicle.moving", "", "pedestrian.standing",
                                "bogus", "cycle.with_rider")[j],
                     num_lidar_pts=int(j), num_radar_pts=int(j % 2),
                     in_bikerack=bool(j == 4),
                     velocity=[0.5 * j, -0.25 * j]) for j in range(5)]
        infos.append(dict(
            token=f"tok{i}", scene_token=f"scene-{i // 2}", timestamp=ts,
            cams={"CAM_FRONT": cam(ts, f"f{i}", 10 * i, "jpg", True),
                  "CAM_BACK": cam(ts, f"b{i}", 7 * i, "png", False)},
            sweeps_cam=[dict(
                cams={"CAM_FRONT": cam(ts - 500_000 * (j + 1), f"f{i}s{j}",
                                       3 * j, "jpg", True),
                      "CAM_BACK": cam(ts - 500_000 * (j + 1), f"b{i}s{j}",
                                      5 * j, "png", False)},
                timestamp=ts - 500_000 * (j + 1),
                radar_points=rng.normal(size=(30, 7)).astype(np.float32) * 6)
                for j in range(3)],
            radar_points=rng.normal(size=(50, 7)).astype(np.float32) * 6,
            gt_boxes=gt, gt_labels=rng.integers(0, 10, size=(5,)),
            gt_anno=anno if i != 2 else None,
            bikeracks=rng.normal(size=(2, 7)).astype(np.float32),
            lidar_points=(rng.normal(size=(400, 3)) * [10, 10, 1]).astype(
                np.float32),
            ego2lidar_xy=(0.9, -0.1)))
    pkl = tmp_path / "infos.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"infos": infos}, f)
    return str(pkl), (srcH, srcW)


@pytest.fixture(params=["numpy", "native"])
def image_path(request, monkeypatch):
    """Both readers on the numpy / PIL path, or both on their native
    libraries (skipped where g++ or libjpeg is missing)."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    elif not (native.available() and jnative.available()):
        pytest.skip("native loader not built (g++ or libjpeg missing)")
    return request.param


@pytest.mark.parametrize("training", [False, True])
def test_nuscenes_reader_equals_original(tmp_path, image_path, training):
    pkl, src = nuscenes_fixture(tmp_path, np.random.default_rng(3))
    kw = dict(num_frames=3, frame_interval=(1, 2) if training else 2,
              camera_types=("CAM_FRONT", "CAM_BACK"), image_hw=(64, 128),
              ida_cfg=dict(resize_lim=(0.45, 0.55), final_dim=(64, 128),
                           src_dim=src, rand_flip=True),
              bev_aug_cfg=(dict(rot_range=(-0.3, 0.3),
                                scale_ratio_range=(0.95, 1.05))
                           if training else None),
              max_radar_points=64, max_gt=8, training=training, seed=5)
    got, want = NuScenesRadarDataset(pkl, **kw), JaxNuScenes(pkl, **kw)
    assert len(got) == len(want) == 4
    for i in range(4):
        assert_samples_equal(got[i], want[i])
    assert got[1]["imgs"].any() and got[1]["gt_attrs"].max() > 0
    assert ("gt_depth" in got[1]) == training
    batch, jbatch = got.batch([3, 0, 1]), want.batch([3, 0, 1])
    assert_samples_equal(batch, jbatch)


def vod_fixture(tmp_path, rng):
    radar = np.zeros((5, 7), np.float32)
    radar[:, 0:3] = [[0.0, 1.5, 10.0], [2.0, 1.5, 8.0], [-1.0, 0.0, 20.0],
                     [0.5, 0.2, 0.5], [40.0, 0.0, 9.0]]
    radar[:, 3] = [5.0, 7.5, 1.0, 2.0, 3.0]
    radar.tofile(tmp_path / "r.bin")
    img = rng.integers(0, 256, size=(90, 160, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "img.png")
    calib = dict(P2=np.array([[50, 0, 64, 0], [0, 50, 32, 0], [0, 0, 1, 0]],
                             float),
                 Tr_velo_to_cam=np.eye(4)[:3], R0_rect=np.eye(3))
    infos = [
        dict(image=dict(image_idx=0, image_path="missing.jpg"), calib=calib,
             radar_path=None, annos=dict(
                 name=np.array(["Car", "Pedestrian", "DontCare"]),
                 location=np.array([[1.0, 1.5, 10.0], [-2.0, 1.5, 8.0],
                                    [0, 0, 0]], np.float32),
                 dimensions=np.array([[4.0, 1.5, 2.0], [0.8, 1.8, 0.8],
                                      [0, 0, 0]], np.float32),
                 rotation_y=np.array([0.1, 0.0, 0.0], np.float32))),
        dict(image=dict(image_idx=1, image_path="img.png"), calib=calib,
             radar_path="r.bin"),
    ]
    p = tmp_path / "vod_infos.pkl"
    with open(p, "wb") as f:
        pickle.dump(infos, f)
    return str(p)


def test_vod_reader_equals_original(tmp_path):
    p = vod_fixture(tmp_path, np.random.default_rng(4))
    kw = dict(data_root=str(tmp_path), image_hw=(64, 128),
              max_radar_points=8, max_gt=4)
    got, want = VoDDataset(p, **kw), JaxVoD(p, **kw)
    for i in range(2):
        assert_samples_equal(got[i], want[i])
    assert got[1]["imgs"].any() and got[1]["radar_mask"].sum() == 5
    assert_samples_equal(got.batch([1, 1]), want.batch([1, 1]))


def test_collate_equals_original():
    samples = [dict(a=np.arange(3) + i, b=np.float32(i), token=f"t{i}",
                    scene=None, raw=b"x") for i in range(3)]
    assert_samples_equal(collate.collate(samples), jcollate.collate(samples))


def test_depth_maps_equal_original():
    rng = np.random.default_rng(8)
    l2i = pinhole(120.0, 60.0, 30.0)
    pts = np.concatenate([rng.uniform(-5, 5, size=(300, 2)),
                          rng.uniform(-2, 70, size=(300, 1)),
                          rng.uniform(-10, 10, size=(300, 4))], 1).astype(
                              np.float32)
    hw = (60, 120)
    pairs = [
        ((depth_maps.points_to_depth_map(pts[:, :3], l2i, hw),),
         (jdepth.points_to_depth_map(pts[:, :3], l2i, hw),)),
        (depth_maps.radar_to_depth_rcs_maps(pts, l2i, hw),
         jdepth.radar_to_depth_rcs_maps(pts, l2i, hw)),
        (depth_maps.radar_to_depth_rcs_maps(pts[:0], l2i, hw),
         jdepth.radar_to_depth_rcs_maps(pts[:0], l2i, hw)),
        (depth_maps.project_to_image(pts[:, :3], l2i),
         jdepth.project_to_image(pts[:, :3], l2i)),
    ]
    for got, want in pairs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert pairs[0][0][0].any() and pairs[1][0][0].any()


@pytest.mark.parametrize("training", [False, True])
def test_transforms_equal_original(training):
    cfg = dict(resize_lim=(0.38, 0.55), final_dim=(64, 128),
               src_dim=(90, 160), bot_pct_lim=(0.0, 0.1), rand_flip=True)
    img = np.random.default_rng(9).integers(0, 256, size=(90, 160, 3),
                                            dtype=np.uint8)
    for seed in range(6):
        got = transforms.ImageAug.sample(np.random.default_rng(seed), cfg,
                                         training)
        want = jtransforms.ImageAug.sample(np.random.default_rng(seed), cfg,
                                           training)
        assert (got.resize, got.crop, got.flip, got.final_dim) == (
            want.resize, want.crop, want.flip, want.final_dim)
        np.testing.assert_array_equal(got.matrix(), want.matrix())
        np.testing.assert_array_equal(transforms.apply_image_aug(img, got),
                                      jtransforms.apply_image_aug(img, want))
    T, ang, scale = transforms.bev_rot_scale_aug(np.random.default_rng(1))
    jT, jang, jscale = jtransforms.bev_rot_scale_aug(np.random.default_rng(1))
    np.testing.assert_array_equal(T, jT)
    assert (ang, scale) == (jang, jscale)
    boxes = np.random.default_rng(2).normal(size=(5, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        transforms.transform_boxes_bev(boxes, T, ang, scale),
        jtransforms.transform_boxes_bev(boxes, jT, jang, jscale))


@pytest.fixture
def port_native():
    """The port's native library; skipped where g++ or libjpeg is
    missing, as tests/test_native_loader.py is."""
    if not native.available():
        pytest.skip("native loader not built (g++ or libjpeg missing)")
    return native


def smooth(h, w):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([x / w * 255, y / h * 255, (x + y) / (h + w) * 255],
                    -1).astype(np.uint8)


def test_native_library_is_the_ports_own(port_native):
    path = port_native.library_path()
    assert path.parts[-3:] == ("build", "racformer_tpu_torch",
                               "libracloader.so")
    assert path.exists() and path != jnative._SO
    assert "racformer_tpu/csrc" not in str(path)


def test_native_decode_and_resize_match_pil(port_native):
    img = smooth(96, 128)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    out = port_native.decode_jpeg(buf.getvalue())
    pil = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    assert out.shape == img.shape
    assert np.abs(out.astype(float) - pil.astype(float)).mean() < 1.0
    assert port_native.decode_jpeg(b"not a jpeg") is None

    img = smooth(100, 160)
    got = port_native.resize_crop_flip(img, 0.5, (5, 3), False, (40, 60),
                                       to_bgr=False)
    want = np.asarray(Image.fromarray(img).resize((80, 50), Image.BILINEAR)
                      .crop((5, 3, 65, 43))).astype(np.float32)
    assert np.abs(got - want).mean() < 12.0
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.95
    rnd = np.random.default_rng(0).integers(0, 256, size=(32, 32, 3),
                                            dtype=np.uint8)
    a = port_native.resize_crop_flip(rnd, 1.0, (0, 0), False, (32, 32), False)
    b = port_native.resize_crop_flip(rnd, 1.0, (0, 0), True, (32, 32), False)
    c = port_native.resize_crop_flip(rnd, 1.0, (0, 0), False, (32, 32), True)
    np.testing.assert_allclose(a, b[:, ::-1], atol=1e-4)
    np.testing.assert_allclose(a, c[..., ::-1], atol=1e-4)


def test_native_radar_columns_match_numpy(port_native):
    rng = np.random.default_rng(0)
    l2i = pinhole(120.0, 60.0, 30.0)
    pts = np.concatenate([rng.uniform(-5, 5, size=(200, 2)),
                          rng.uniform(1, 50, size=(200, 1)),
                          rng.uniform(-10, 10, size=(200, 1))], 1).astype(
                              np.float32)
    want_d, want_r = depth_maps.radar_to_depth_rcs_maps(pts, l2i, (60, 120))
    u, v, d = depth_maps.project_to_image(pts[:, :3], l2i)
    uvdr = np.stack([u, v, d, pts[:, 3]], 1).astype(np.float32)
    got_d, got_r = port_native.radar_columns(uvdr, (60, 120))
    np.testing.assert_allclose(got_d, want_d, atol=1e-4)
    np.testing.assert_allclose(got_r, want_r, atol=1e-4)
