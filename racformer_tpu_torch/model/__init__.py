from .racformer import RaCFormer, preprocess_images, random_init_
