"""The asynchronous runtime of the port (paper §3), as the reference
``repro.runtime``, in three layers:

  * **Service** (``service.py``) — the uniform start/stop/join lifecycle,
    health state and per-service ``MetricsRegistry`` of every component
    (rollout workers, the Inference-as-a-Service pool, the trainer),
    wired on a ``ServiceRegistry`` bus;
  * **ExperienceChannel** (``experience.py``) — the data plane: FIFO /
    ring channels with pluggable backpressure and the
    ``MixedExperienceSource``;
  * **Scheduler** (``scheduler.py``) — ``FreeRunScheduler`` (the fully
    asynchronous pipeline) and ``BarrierScheduler`` (the synchronous
    baseline) pacing the SAME services.

``orchestrator.AcceRLSystem`` composes the layers. The versioned weight
store implements the drain protocol (App. D.6) over Table 8's three
transports. ``runtime.transport`` carries the channels and the weights
across the process boundary (remote rollout workers). The telemetry
plane, the step program and the pipelined executor are not ported yet
(ROADMAP A6b, A7).
"""
from repro_torch.runtime.weight_store import (  # noqa: F401
    DirectTransport,
    DiskTransport,
    SerializedTransport,
    VersionedWeightStore,
)
from repro_torch.runtime.service import (  # noqa: F401
    MetricsRegistry,
    NullGate,
    RolloutGate,
    Service,
    ServiceRegistry,
    ServiceState,
)
from repro_torch.runtime.experience import (  # noqa: F401
    ExperienceChannel,
    FifoChannel,
    MixedExperienceSource,
    RingChannel,
)
from repro_torch.runtime.scheduler import (  # noqa: F401
    BarrierGate,
    BarrierScheduler,
    FreeRunScheduler,
    Scheduler,
)
from repro_torch.runtime.inference import InferenceService  # noqa: F401
from repro_torch.runtime.rollout import RolloutWorker  # noqa: F401
from repro_torch.runtime.trainer import TrainerWorker  # noqa: F401
from repro_torch.runtime.orchestrator import AcceRLSystem  # noqa: F401
