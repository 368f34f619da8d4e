"""Training substrate of the port: optimizer, steps, straggler monitor (the
pod compression comes with the meshes, ROADMAP A17 (ii b))."""
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.steps import make_train_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "make_train_step"]
