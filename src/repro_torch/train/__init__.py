"""The training path: AdamW with clipping and a cosine schedule
(:mod:`~repro_torch.train.optimizer`) and the fault-tolerant loop
(:mod:`~repro_torch.train.loop`)."""
from repro_torch.train.optimizer import (AdamWState, adamw_init, adamw_update,
                                         cosine_schedule)
from repro_torch.train.loop import TrainConfig, train

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "TrainConfig", "train"]
