"""The parameter server on one device: sync models and training loops
(the threaded asynchronous simulator is not ported yet)."""

from repro_torch.core.ps.sync import (  # noqa: F401
    PSConfig, PSState, init_state, make_train_step, replicate_for_workers,
    worker_mean,
)
from repro_torch.core.ps import trainer  # noqa: F401
