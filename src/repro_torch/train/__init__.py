"""Training substrate of the port: optimizer, steps, the pod compression,
straggler monitor."""
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.steps import make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "make_train_step"]
