from .step import make_draws, make_train_step
