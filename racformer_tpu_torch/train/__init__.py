"""Training (port of `racformer_tpu/train/`): matching, losses, optimizer
and the train step. `python -m racformer_tpu_torch.train` is the driver."""

from .losses import depth_loss, detection_loss
from .matching import hungarian_assign, match_cost
from .optim import Optimizer, cosine_warmup_lr, param_label
from .step import make_draws, make_train_step, split_microbatches
