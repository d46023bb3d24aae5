"""Closed-loop hard-pair mining: the serving index feeds the trainer.

Counterpart of ``repro/mining``:

miner.py   HardPairMiner — batched k-NN through the RetrievalEngine,
           label-filtered on the host into hard negatives / hard
           positives / a semi-hard band under the current metric L.
stream.py  MinedPairSource — trainer-contract batch streams mixing
           uniform and mined pairs under a CurriculumSchedule, per-worker
           sharded, gathered on the device from a resident feature table.
loop.py    ClosedLoopTrainer — alternates PS training with index refresh
           (MutableIndex.swap_metric or rebuild, optionally promoted
           through a tenant's shadow arm) + re-mining, under an explicit
           staleness policy (every R steps / on plateau).
"""

from repro_torch.mining.loop import (ClosedLoopConfig,  # noqa: F401
                                     ClosedLoopTrainer)
from repro_torch.mining.miner import (HardPairMiner,  # noqa: F401
                                      MinerConfig, MiningResult)
from repro_torch.mining.stream import (CurriculumSchedule,  # noqa: F401
                                       MinedPairSource)
