from .checkpoint import (latest_checkpoint, restore_checkpoint,
                         save_checkpoint, wait_for_saves)
from .train import (OptimizerChain, TrainState, create_train_state,
                    get_lr_multiplier, make_eval_step, make_optimizer,
                    make_train_step, set_lr_multiplier)

__all__ = ["OptimizerChain", "TrainState", "create_train_state",
           "get_lr_multiplier", "make_eval_step", "make_optimizer",
           "make_train_step", "set_lr_multiplier", "save_checkpoint",
           "restore_checkpoint", "latest_checkpoint", "wait_for_saves"]
