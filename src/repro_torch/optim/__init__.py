"""Optimizers and learning-rate schedules (the JAX package's ``optim``)."""
from repro_torch.optim.optimizers import Optimizer, adafactor, adamw, get_optimizer, sgd  # noqa: F401
from repro_torch.optim.schedules import cosine_schedule, get_schedule, wsd_schedule  # noqa: F401
