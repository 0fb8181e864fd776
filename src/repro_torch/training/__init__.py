from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from .data import DataConfig, data_stream, synthetic_batch
from .optimizer import OptConfig, adamw_update, init_opt_state
from .train_loop import TrainConfig, Trainer, make_train_step
