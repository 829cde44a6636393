"""The training step (twin of repro.train)."""
from repro_torch.train.step import TrainState, init_state, make_train_step, train_state_specs

__all__ = ["TrainState", "init_state", "make_train_step", "train_state_specs"]
