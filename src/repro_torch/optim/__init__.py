from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState, MomentumState, Optimizer, ScaleState, adam, adamw,
    apply_updates, clip_by_global_norm, momentum, sgd,
)
from repro_torch.optim import schedules  # noqa: F401
