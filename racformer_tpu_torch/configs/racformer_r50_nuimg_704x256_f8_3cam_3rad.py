# Front-only 3-camera / 3-radar variant (mirrors the fork's
# racformer_r50_nuimg_704x256_f8_3cam_3rad.py overlay).

_base_ = ["racformer_r50_nuimg_704x256_f8.py"]

camera_types = ["CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT"]
radar_types = ["RADAR_FRONT", "RADAR_FRONT_LEFT", "RADAR_FRONT_RIGHT"]

model = dict(num_cams=3)

# the fork evaluates front-only (ego x > 0) in these configs
eval_front_only = True
