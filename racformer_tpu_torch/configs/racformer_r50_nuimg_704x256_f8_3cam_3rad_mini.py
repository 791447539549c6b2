# Mini smoke-eval config: 3-cam/3-radar capped at 50 val samples (mirrors the
# fork's ..._3cam_3rad_mini.py).

_base_ = ["racformer_r50_nuimg_704x256_f8_3cam_3rad.py"]

max_samples = 50
