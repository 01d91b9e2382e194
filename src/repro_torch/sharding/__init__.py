"""Partition rules mapping every architecture family onto the production
mesh (reference: ``repro.sharding``), placed as DTensors."""
from repro_torch.sharding import rules  # noqa: F401
from repro_torch.sharding.rules import (  # noqa: F401
    batch_axes,
    cache_specs,
    data_spec,
    param_specs,
)
