"""Optimizers (port of ``repro/optim``): LAMB with fp32 master weights and
the warmup + polynomial-decay schedule.  AdamW ports with a later slice."""
from repro_torch.optim.lamb import LambState, lamb_init, lamb_update
from repro_torch.optim.schedule import warmup_poly_decay

__all__ = ["LambState", "lamb_init", "lamb_update", "warmup_poly_decay"]
