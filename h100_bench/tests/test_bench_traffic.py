"""The traffic generator: deterministic in the seed, the same sizes for
every seed, scene resets and staggered streams as the mixes say."""

import numpy as np

from h100_bench.tests.tiny import tiny_cfg
from h100_bench.traffic import generator

MIX = dict(generator.load_mix("stream"), pool_frames=5, radar_points=[16, 64])


def test_frame_pool_is_deterministic_in_the_seed():
    cfg = tiny_cfg()
    a, b = generator.frame_pool(cfg, MIX, 2**40 + 7), generator.frame_pool(cfg, MIX, 2**40 + 7)
    c = generator.frame_pool(cfg, MIX, 2**40 + 8)
    for fa, fb in zip(a, b):
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])
    assert any(not np.array_equal(fa["imgs"], fc["imgs"]) for fa, fc in zip(a, c))


def test_every_seed_gets_the_same_sizes():
    cfg = tiny_cfg()
    counts = [sorted(int(f["radar_mask"].sum()) for f in generator.frame_pool(cfg, MIX, s))
              for s in (1, 2**31 + 5, -3)]
    assert counts[0] == counts[1] == counts[2] == generator.spaced(16, 64, 5).tolist()
    lengths = [sorted(generator.scene_lengths(MIX, s, 0)) for s in (1, 99)]
    assert lengths[0] == lengths[1] == list(range(35, 42))


def test_frames_follow_the_field_contract():
    cfg = tiny_cfg()
    f = generator.frame_pool(cfg, MIX, 3)[0]
    N, (H, W) = 2, cfg["model"]["image_hw"]
    assert f["imgs"].dtype == np.uint8 and f["imgs"].shape == (N, H, W, 3)
    assert f["radar_depth"].shape == (N, W) and f["radar_rcs"].shape == (N, W)
    assert f["radar_points"].shape == (cfg["radar"]["max_points"], 7)
    np.testing.assert_allclose(f["lidar2img"] @ f["img2lidar"],
                               np.broadcast_to(np.eye(4), (N, 4, 4)), atol=1e-4)


def test_tape_resets_at_scene_boundaries_and_staggers_streams():
    mix = dict(MIX, streams=4, scene_frames=[3, 4])
    tapes = [generator.tape(mix, 11, b, 30) for b in range(4)]
    for b, tape in enumerate(tapes):
        assert tape[0][1] and tape[0][2] == 0.0
        starts = [i for i, (_, reset, _) in enumerate(tape) if reset]
        lengths = np.diff(starts)
        assert set(lengths[1:].tolist()) <= {3, 4}
        for i, (_, reset, ts) in enumerate(tape):
            s = max(j for j in starts if j <= i)
            assert ts == 0.5 * (i - s)
    firsts = [[i for i, e in enumerate(t) if e[1]][1] for t in tapes]
    assert len(set(firsts)) > 1  # boundaries are staggered
    assert generator.tape(mix, 11, 2, 30) == tapes[2]


def test_train_pool_counts_and_determinism():
    cfg = tiny_cfg()
    mix = dict(generator.load_mix("train"), pool_batches=2, radar_points=[16, 64])
    a, b = generator.train_pool(cfg, mix, 5), generator.train_pool(cfg, mix, 5)
    for ba, bb in zip(a, b):
        for k in ba:
            np.testing.assert_array_equal(ba[k], bb[k])
    G = cfg["model"]["max_gt"]
    counts = sorted(int(x) for bt in a for x in bt["gt_mask"].sum(1))
    assert counts == generator.spaced(1, G + 1, 4).tolist()
    assert a[0]["imgs"].shape[:2] == (mix["batch"], cfg["model"]["num_frames"])


def test_train_boxes_clear_of_the_ego():
    """Every GT box of a train pool lies clear of the mix's ego circle, and
    a radius of 0 redraws nothing."""
    cfg = tiny_cfg()
    mix = dict(generator.load_mix("train"), pool_batches=2, radar_points=[16, 64])
    assert mix["ego_radius_m"] > 0
    for seed in (5, 1066068642):
        for bt in generator.train_pool(cfg, mix, seed):
            gt = bt["gt_bboxes"][bt["gt_mask"]]
            reach = mix["ego_radius_m"] + 0.5 * np.hypot(gt[:, 3], gt[:, 4])
            assert (np.hypot(gt[:, 0], gt[:, 1]) >= reach).all()
    rng_a, rng_b = generator.rng_for(7, 0), generator.rng_for(7, 0)
    gt = np.zeros((4, 9), np.float32)
    gt[:, 3:5] = 2.0
    generator.clear_of_ego(rng_a, gt, 0.0)
    assert (gt[:, 0:2] == 0).all()
    assert rng_a.random() == rng_b.random()
