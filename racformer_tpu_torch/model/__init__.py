from .racformer import RaCFormer, config_kwargs, preprocess_images, random_init_
