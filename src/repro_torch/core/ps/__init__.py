"""The parameter server on one device: sync models and training loops,
and the paper's threaded asynchronous server (``simulator``, §4.2)."""

from repro_torch.core.ps.sync import (  # noqa: F401
    PSConfig, PSState, init_state, make_train_step, replicate_for_workers,
    worker_mean,
)
from repro_torch.core.ps import simulator, trainer  # noqa: F401
