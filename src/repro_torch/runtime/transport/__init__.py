"""Cross-process transport subsystem (paper §3 "physical isolation"), as
the reference ``repro.runtime.transport``, wire-compatible with it:

  * :mod:`codec`   — versioned, zero-copy-friendly pytree wire format, on
    numpy and torch leaves (bf16 carried as its bits);
  * :mod:`channel` — :class:`SocketChannel` / :class:`ShmChannel` /
    :class:`ShmRingChannel`, the ExperienceChannel contract (incl.
    backpressure verdicts, batched ``put_many``, coalesced ``pop_many``)
    over the wire, on a reconnecting :class:`WireClient`, plus
    :class:`PutStream`, the pipelined windowed-ack put path;
  * :mod:`ring`    — :class:`ShmRing`, the persistent SPSC shared-memory
    ring replacing per-message segments on the highest-rate channels,
    and the broadcast weight lane;
  * :mod:`server`  — :class:`TransportServer`, the parent-side endpoint
    (a Service on the bus) hosting channels + the weight store + the
    ``worker.hello`` token handshake;
  * :mod:`weights` — :class:`WeightStoreTransport`, remote
    publish/acquire with the drain protocol, decoding onto the worker's
    device;
  * :mod:`remote`  — ``worker_main`` + :class:`RemoteWorkerSpec`, the
    worker process body (one body, two lifecycles);
  * :mod:`supervision` — :class:`Supervisor` / :class:`SupervisedWorker`
    / :class:`RestartPolicy` and the Spawned/Connected endpoints.

Not ported yet (ROADMAP A6b): the journal (``resilience``), the
disaggregated inference plane, fault injection, the elastic autoscaler,
and the import-gated tracing.
"""
from repro_torch.runtime.transport.codec import (  # noqa: F401
    CodecError,
    decode_pytree,
    encode_pytree,
)
from repro_torch.runtime.transport.channel import (  # noqa: F401
    ChannelClosed,
    PutStream,
    ShmChannel,
    ShmRingChannel,
    SocketChannel,
    TransportError,
    WireClient,
)
from repro_torch.runtime.transport.ring import (  # noqa: F401
    RingError,
    ShmRing,
    sweep_stale_shm,
)
from repro_torch.runtime.transport.server import TransportServer  # noqa: F401
from repro_torch.runtime.transport.weights import (  # noqa: F401
    WeightStoreTransport,
)
from repro_torch.runtime.transport.remote import (  # noqa: F401
    RemoteWorkerSpec,
    spec_from_wire,
    spec_to_wire,
    worker_main,
)
from repro_torch.runtime.transport.supervision import (  # noqa: F401
    ConnectedEndpoint,
    RestartPolicy,
    SpawnedEndpoint,
    SupervisedWorker,
    Supervisor,
    WorkerEndpoint,
)
