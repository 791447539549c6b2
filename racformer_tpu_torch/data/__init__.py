"""The data layer (copies of `racformer_tpu/data/`, numpy only): the
synthetic dataset, the nuScenes and VoD readers, the depth / RCS map
rasterizers, the image and BEV augmentation, batch collation and the native
JPEG / rasterizer library. No module imports Pillow until it decodes or
resizes an image."""

from .depth_maps import points_to_depth_map, radar_to_depth_rcs_maps
from .transforms import ImageAug, apply_image_aug, bev_rot_scale_aug
from .synthetic import SyntheticDataset
from .nuscenes import NuScenesRadarDataset
