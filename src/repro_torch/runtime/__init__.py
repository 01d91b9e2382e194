"""Serving runtime of the port: the service layer, the versioned weight
store and the inference pool."""
from repro_torch.runtime.inference import InferenceService  # noqa: F401
from repro_torch.runtime.service import MetricsRegistry, Service  # noqa: F401
from repro_torch.runtime.weight_store import (  # noqa: F401
    DirectTransport,
    VersionedWeightStore,
)
