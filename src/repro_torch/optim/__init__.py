"""Optimizers (port of ``repro/optim``): LAMB and AdamW with fp32 master
weights and the warmup + polynomial-decay schedule."""
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.lamb import LambState, lamb_init, lamb_update
from repro_torch.optim.schedule import warmup_poly_decay

__all__ = ["LambState", "adamw_init", "adamw_update", "lamb_init",
           "lamb_update", "warmup_poly_decay"]
