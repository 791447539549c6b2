# RaCFormer R50 nuImages-pretrained, 704x256, 8 frames — the canonical recipe.
# Hyperparameters mirror the reference config
# (/root/reference/configs/racformer_r50_nuimg_704x256_f8.py) expressed in the
# racformer_tpu schema.

dataset_type = "nuscenes_radar"
dataset_root = "./data/nuscenes/"

class_names = [
    "car", "truck", "trailer", "bus", "construction_vehicle", "bicycle",
    "motorcycle", "pedestrian", "traffic_cone", "barrier",
]

point_cloud_range = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]

model = dict(
    num_cams=6,
    num_frames=8,
    embed_dims=256,
    num_query=900,
    num_clusters=6,
    num_levels=4,
    num_groups=4,
    image_hw=(256, 704),
    pc_range=tuple(point_cloud_range),
    depth_bins=96,
    bev_size=(128, 128),
    query_denoising=True,
    max_gt=64,
)

decoder = dict(
    num_layers=6,
    d_region_list=[0.08, 0.07, 0.06, 0.05, 0.04, 0.03],
    num_points=4,
    num_points_bev=4,
    img_depth_num=3,
    bev_depth_num=5,
    num_ray=150,
)

depth = dict(d_lo=1.0, d_hi=65.0, num_bins=96, downsample=16, weight=2.0)

radar = dict(
    num_sweeps=5,
    max_points=1536,  # static padded radar point capacity per frame
    point_dims=7,  # x, y, z, rcs, vx_comp, vy_comp, time_lag
)

data = dict(
    train=dict(
        ann_file=dataset_root + "nuscenes_infos_train_sweep.pkl",
        num_frames=8,
        frame_interval=(4, 8),  # train: random sweep interval
    ),
    val=dict(
        ann_file=dataset_root + "nuscenes_infos_val_sweep.pkl",
        num_frames=8,
        frame_interval=6,  # test: fixed interval
    ),
)

ida_aug = dict(
    resize_lim=(0.38, 0.55),
    final_dim=(256, 704),
    src_dim=(900, 1600),
    rand_flip=True,
)

bev_aug = dict(rot_range=(-0.3925, 0.3925), scale_ratio_range=(0.95, 1.05))

optimizer = dict(
    base_lr=4e-4,
    weight_decay=0.01,
    clip_norm=35.0,
    warmup_steps=500,
    backbone_lr_mult=0.1,
    sampling_offset_lr_mult=0.1,
)

total_epochs = 36
batch_size_per_chip = 2
# The fused B=2 step OOMs on a 16 GB v5e (BASELINE.md round-3 table); run the
# reference's 2 samples/device as 2 x B=1 gradient-accumulation microbatches.
accumulate_steps = 2
num_chips = 8

eval_cfg = dict(
    max_num=300,
    score_threshold=0.05,
    post_center_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
)

# in-training periodic eval on the val split, every 2 epochs
# (`/root/reference/configs/racformer_r50_nuimg_704x256_f8.py:334`
# `evaluation = dict(interval=2)`); `max_samples` caps the in-training val
# sweep (None = full split), `save_best` picks the best-checkpoint metric.
# Wall-time math (v5e, round-5 numbers): the OFFLINE path recomputes all 8
# frames per sample (~1.6 s/sample/chip), so the full 6019-sample val split
# would cost ~2.7 h per eval on one chip (~20 min on 8) — longer than an
# epoch on small runs. max_samples=512 keeps it at ~14 min/chip (~2 min on
# 8). mode="streaming" instead encodes 1 frame/sample through the streaming
# evaluator (~0.2 s/sample, ~8x cheaper; windows come from scene history,
# an internally consistent training signal rather than the reference's
# offline protocol). The `best` checkpoint selection only needs a
# consistent metric, so capped offline is the parity-safe default.
evaluation = dict(interval=2, max_samples=512, mode="offline",
                  save_best="NDS")

load_from = "pretrain/cascade_mask_rcnn_r50_fpn_nuimages.pkl"
revise_keys = [("backbone", "img_backbone")]
