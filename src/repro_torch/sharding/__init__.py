"""Logical-axis sharding plans (counterpart of ``repro/sharding``)."""

from repro_torch.sharding.partition import (  # noqa: F401
    DEFAULT_RULES, NamedSharding, constrain, local_shape,
    logical_to_physical, make_param_shardings, named, shard_map,
)
