"""Training (port of ``repro.train``): the train-step factory."""
from repro_torch.train.step import init_train_state, make_loss_fn, make_train_step, modeled_speedup

__all__ = ["make_train_step", "make_loss_fn", "init_train_state", "modeled_speedup"]
