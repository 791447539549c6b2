# View-of-Delft mono-camera + 4D-radar variant (mirrors the reference's VoD
# capability, loaders/vod_mono_dataset.py): single frame, single camera,
# 3 classes, KITTI-protocol evaluation.

_base_ = ["racformer_r50_nuimg_704x256_f8.py"]

dataset_type = "vod"

class_names = ["Car", "Pedestrian", "Cyclist"]

model = dict(
    num_cams=1,
    num_frames=1,
    num_query=600,
    num_clusters=4,
    max_gt=32,
)

radar = dict(num_sweeps=5, max_points=1024, point_dims=7)

data = dict(
    train=dict(ann_file="./data/vod/vod_infos_train.pkl", num_frames=1,
               frame_interval=1),
    val=dict(ann_file="./data/vod/vod_infos_val.pkl", num_frames=1,
             frame_interval=1),
)

# train recipe: the reference repo ships no VoD config (its VoD support is
# dataset+eval code only); these defaults follow the paper's single-frame
# fine-tuning setup — fewer epochs than nuScenes, same optimizer family
total_epochs = 24
optimizer = dict(
    base_lr=2e-4,
    weight_decay=0.01,
    clip_norm=35.0,
    warmup_steps=500,
    backbone_lr_mult=0.1,
    sampling_offset_lr_mult=0.1,
)
