"""Training of the port (``repro.train``): the loss, the train step
(microbatch accumulation, error-feedback compression, clipping, the
optimizer update) and the fault-tolerant ``Trainer``."""
from repro_torch.train.losses import loss_and_metrics
from repro_torch.train.train_step import TrainState, build_train_step, init_train_state
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = [k for k in dir() if not k.startswith("_")]
