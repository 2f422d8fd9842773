from .train import (TrainState, create_train_state, get_lr_multiplier,
                    make_eval_step, make_optimizer, make_train_step,
                    set_lr_multiplier)

__all__ = ["TrainState", "create_train_state", "get_lr_multiplier",
           "make_eval_step", "make_optimizer", "make_train_step",
           "set_lr_multiplier"]
