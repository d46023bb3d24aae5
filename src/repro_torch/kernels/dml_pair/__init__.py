from repro_torch.kernels.dml_pair.ops import (  # noqa: F401
    dml_pair_forward, dml_pair_loss_and_d2, dml_pair_loss_fused,
    dml_pair_loss_reference,
)
from repro_torch.kernels.dml_pair.kernel import dml_pair_fused  # noqa: F401
from repro_torch.kernels.dml_pair.ref import dml_pair_ref  # noqa: F401
