from repro_torch.train.optimizer import (OptConfig, adamw_init, adamw_update,
                                        lr_at)
from repro_torch.train.train_step import TrainStepBuilder, cross_entropy

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_at",
           "TrainStepBuilder", "cross_entropy"]
