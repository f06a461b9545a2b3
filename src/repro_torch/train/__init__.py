from repro_torch.train.optimizer import adamw_init, adamw_update
from repro_torch.train.train_loop import TrainState, make_train_step, train_loop

__all__ = [
    "adamw_init",
    "adamw_update",
    "TrainState",
    "make_train_step",
    "train_loop",
]
