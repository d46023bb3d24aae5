"""The paper's own experiment configs (Table 1 / §5.2).

A copy of ``repro/configs/dml_paper.py``. These drive the reproduction
benchmarks. Feature data is generated synthetically at matching
dimensionality (see repro_torch.data.pairs); the paper's raw datasets (MNIST pixels, ImageNet LLC codes) are not shipped offline.
"""

import dataclasses

from repro_torch.core.dml import DMLConfig


@dataclasses.dataclass(frozen=True)
class DMLExperiment:
    name: str
    dml: DMLConfig
    n_samples: int
    n_classes: int
    n_similar: int
    n_dissimilar: int
    batch_size: int          # paper §5.2 minibatch (pairs per step)
    data_kind: str
    source: str = "Xie & Xing 2014, Table 1 / §5.2"


# MNIST: d=780, k=600, minibatch 1000 (500 S + 500 D), 100K+100K pairs
MNIST = DMLExperiment(
    name="dml-mnist",
    dml=DMLConfig(feat_dim=780, proj_dim=600, lam=1.0, margin=1.0),
    n_samples=60_000, n_classes=10,
    n_similar=100_000, n_dissimilar=100_000,
    batch_size=1000,
    data_kind="mnist_like",
)

# ImageNet-63K: d=21504, k=10000 -> 220M params, minibatch 100
IMNET_63K = DMLExperiment(
    name="dml-imnet63k",
    dml=DMLConfig(feat_dim=21504, proj_dim=10000, lam=1.0, margin=1.0),
    n_samples=63_000, n_classes=1000,
    n_similar=100_000, n_dissimilar=100_000,
    batch_size=100,
    data_kind="llc_like",
)

# ImageNet-1M: d=21504, k=1000 -> 21.5M params, minibatch 1000, 100M+100M pairs
IMNET_1M = DMLExperiment(
    name="dml-imnet1m",
    dml=DMLConfig(feat_dim=21504, proj_dim=1000, lam=1.0, margin=1.0),
    n_samples=1_000_000, n_classes=1000,
    n_similar=100_000_000, n_dissimilar=100_000_000,
    batch_size=1000,
    data_kind="llc_like",
)

EXPERIMENTS = {e.name: e for e in (MNIST, IMNET_63K, IMNET_1M)}


def scaled_down(exp: DMLExperiment, factor: int = 10) -> DMLExperiment:
    """CPU-tractable variant preserving d/k aspect and pair balance."""
    return dataclasses.replace(
        exp,
        name=exp.name + f"-small{factor}",
        dml=dataclasses.replace(exp.dml,
                                feat_dim=max(32, exp.dml.feat_dim // factor),
                                proj_dim=max(16, exp.dml.proj_dim // factor)),
        n_samples=max(500, exp.n_samples // factor),
        n_similar=max(2000, exp.n_similar // (factor * factor)),
        n_dissimilar=max(2000, exp.n_dissimilar // (factor * factor)),
        batch_size=min(exp.batch_size, 256),
    )
