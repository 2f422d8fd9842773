from .checkpoint import (latest_checkpoint, restore_checkpoint,
                         save_checkpoint, wait_for_saves)
from .input import process_batch_slice, put_global_batch
from .mesh import (best_data_axis, make_mesh, make_mesh_spatial,
                   spatial_sharding, tensor_parallel_shardings)
from .multihost import (distributed_initialize, distributed_shutdown,
                        is_multiprocess, process_count, process_index)
from .pipeline import PipelineExecutor, split_detector, split_yolov4
from .train import (OptimizerChain, TrainState, create_train_state,
                    get_lr_multiplier, make_eval_step, make_optimizer,
                    make_train_step, set_lr_multiplier)

__all__ = ["OptimizerChain", "TrainState", "create_train_state",
           "get_lr_multiplier", "make_eval_step", "make_optimizer",
           "make_train_step", "set_lr_multiplier", "save_checkpoint",
           "restore_checkpoint", "latest_checkpoint", "wait_for_saves",
           "make_mesh", "make_mesh_spatial", "spatial_sharding",
           "best_data_axis", "tensor_parallel_shardings",
           "put_global_batch", "process_batch_slice",
           "distributed_initialize", "distributed_shutdown",
           "is_multiprocess", "process_count", "process_index",
           "PipelineExecutor", "split_detector", "split_yolov4"]
