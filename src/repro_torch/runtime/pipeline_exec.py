"""Pipelined multi-submesh training runtime (Alpa-style static schedules),
as in the reference ``repro/runtime/pipeline_exec.py``.

Runs the policy trainer and the world-model trainer as pipeline stages on
submeshes of one local device list. Each submesh executes a STATIC
instruction schedule — a flat tuple of RUN / SEND / RECV / FREE
instructions compiled from the :class:`~repro_torch.runtime.step_program
.StepProgram` — on its own worker thread:

  * RUN   — invoke one stage body on buffers already resident on the
            submesh (micro-batch grads fold into the f32 accumulator
            immediately after each fwd_bwd, GPipe/1F1B-style, so live
            gradient memory is bounded to ONE micro-batch regardless of
            the accumulation depth). A RUN ends when its device work has:
            on a CUDA submesh it synchronizes the stream it issued to, so
            ``busy_s`` counts device time as the reference's
            ``block_until_ready`` does;
  * SEND / RECV — rendezvous through a tagged mailbox; on a placing
            stream (a disjoint single-device submesh) a RECV moves the tree
            onto the submesh's device (``.to``, numpy batches through
            ``bridge.batch_from_numpy``), as the reference's
            ``jax.device_put``;
  * FREE  — drop the buffer reference so the allocator can reuse it; the
            schedule validator proves every buffer is freed and that the
            micro-grad high-water mark is 1.

Submeshes are tuples of ``torch.device``. On one card both stages share
it (the reference's single-CPU case): the schedules still interleave,
and there the WM stage overlaps the policy's stage on the card.

Two host threads issue to one card. The policy stream issues on a CUDA
stream of its own, which first waits on everything the host's stream had
queued when the round was submitted (the previous publish's snapshot
clone, a prefetched batch's copy), and whose work is complete when the
round returns; the WM stage issues on the device's default stream, as the
free-running WM trainer does, so the WM trees it rebinds are ordered
before any reader's kernels on that stream. The two share no tensor, so
the order in which the card interleaves their kernels cannot change
either's results.

With ``REPRO_TRACE`` set, each RUN records a ``train.stage`` span and
each round a ``pipeline.round`` instant.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import functools
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.bridge import batch_from_numpy
from repro_torch.data.trajectory import TrajectoryBatch
from repro_torch.runtime.step_program import StepProgram

# Import-gated tracing (see runtime/trainer.py for the idiom).
if os.environ.get("REPRO_TRACE"):
    from repro_torch.runtime import telemetry as _tel
else:  # pragma: no cover - default path
    _tel = None


class PipelineOp(enum.IntEnum):
    RUN = 0
    SEND = 1
    RECV = 2
    FREE = 3


@dataclasses.dataclass(frozen=True)
class Instruction:
    """One schedule entry. RUN names a program stage and its buffer
    bindings; SEND/RECV move ``buffer`` through the mailbox under
    ``tag``; FREE drops ``buffer``."""

    op: PipelineOp
    stage: str = ""
    inputs: Tuple[str, ...] = ()
    outputs: Tuple[str, ...] = ()
    buffer: str = ""
    micro: int = -1
    tag: str = ""

    def __repr__(self):
        if self.op == PipelineOp.RUN:
            m = f" m={self.micro}" if self.micro >= 0 else ""
            return (f"RUN {self.stage}{m} ({','.join(self.inputs)})->"
                    f"({','.join(self.outputs)})")
        if self.op == PipelineOp.FREE:
            return f"FREE {self.buffer}"
        return f"{self.op.name} {self.buffer} tag={self.tag}"


@dataclasses.dataclass(frozen=True)
class Submesh:
    """A named slice of the local device list."""

    name: str
    devices: Tuple[torch.device, ...]

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def mesh(self):
        """(n, 1) ``DeviceMesh`` over exactly these devices, axes (data,
        model). A ``DeviceMesh`` has one rank a device, so n must be the
        process group's world size (1 with no group: one is started in
        process, ``launch.mesh.make_local_mesh``)."""
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_local_mesh
        n = len(self.devices)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n != world:
            raise ValueError(
                f"a mesh over {n} devices needs {n} ranks, one a device; "
                f"this process group has {world}")
        return make_local_mesh(self.device.type)


@dataclasses.dataclass(frozen=True)
class SubmeshLayout:
    """Policy + WM submeshes carved from one device list."""

    policy: Submesh
    wm: Submesh
    disjoint: bool

    @classmethod
    def split(cls, devices: Sequence, *, wm_devices: int = 0
              ) -> "SubmeshLayout":
        """Slice the local device list: the WM stage takes ``wm_devices``
        from the tail (default: half when >=2 devices). With one device
        both submeshes alias it — the schedules still interleave
        correctly."""
        devices = tuple(torch.device(d) for d in devices)
        if len(devices) >= 2:
            n_wm = wm_devices or len(devices) // 2
            n_wm = max(1, min(n_wm, len(devices) - 1))
            return cls(Submesh("policy", devices[:len(devices) - n_wm]),
                       Submesh("wm", devices[len(devices) - n_wm:]),
                       disjoint=True)
        return cls(Submesh("policy", devices), Submesh("wm", devices),
                   disjoint=False)


def local_devices(device) -> Tuple[torch.device, ...]:
    """Every local device of ``device``'s type: the CUDA devices, or the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


# --------------------------------------------------------------------------
# schedule construction + static validation
# --------------------------------------------------------------------------

def _I(op, **kw):
    return Instruction(op=op, **kw)


@functools.lru_cache(maxsize=32)
def build_train_schedules(n_micro: int, wm_micro: int
                          ) -> Dict[str, Tuple[Instruction, ...]]:
    """Static per-submesh schedules for one training round.

    Policy stream: RECV state + micro feeds, fold each micro-batch's
    grads immediately (1F1B — ``g{m}`` FREEd before ``g{m+1}`` exists),
    optimizer update, SEND the updated state back to the host. WM stream:
    one RUN per WM micro-batch. Host-side tags are the feeds/collects of
    ``PipelineExecutor.run_round``.
    """
    pol: List[Instruction] = [
        _I(PipelineOp.RECV, buffer="state", tag="host:policy:state"),
        _I(PipelineOp.RUN, stage="grad_reduce/init", inputs=("state",),
           outputs=("acc0",)),
    ]
    for m in range(n_micro):
        pol += [
            _I(PipelineOp.RECV, buffer=f"mb{m}", tag=f"host:policy:micro{m}"),
            _I(PipelineOp.RUN, stage="fwd_bwd", micro=m,
               inputs=("state", f"mb{m}"), outputs=(f"g{m}", f"aux{m}")),
            _I(PipelineOp.RUN, stage="grad_reduce", micro=m,
               inputs=(f"acc{m}", f"g{m}", f"aux{m}"),
               outputs=(f"acc{m + 1}",)),
            _I(PipelineOp.FREE, buffer=f"g{m}"),
            _I(PipelineOp.FREE, buffer=f"mb{m}"),
            _I(PipelineOp.FREE, buffer=f"acc{m}"),
        ]
        if m < n_micro - 1:
            pol.append(_I(PipelineOp.FREE, buffer=f"aux{m}"))
    last = n_micro - 1
    pol += [
        _I(PipelineOp.RUN, stage="optim_update",
           inputs=("state", f"acc{n_micro}", f"aux{last}"),
           outputs=("state_out", "metrics")),
        _I(PipelineOp.FREE, buffer=f"acc{n_micro}"),
        _I(PipelineOp.FREE, buffer=f"aux{last}"),
        _I(PipelineOp.FREE, buffer="state"),
        _I(PipelineOp.SEND, buffer="state_out", tag="pipe:policy:state"),
        _I(PipelineOp.SEND, buffer="metrics", tag="pipe:policy:metrics"),
        _I(PipelineOp.FREE, buffer="state_out"),
        _I(PipelineOp.FREE, buffer="metrics"),
    ]

    wm: List[Instruction] = []
    for m in range(wm_micro):
        wm += [
            _I(PipelineOp.RECV, buffer=f"wmb{m}", tag=f"host:wm:micro{m}"),
            _I(PipelineOp.RUN, stage="wm_update", micro=m,
               inputs=(f"wmb{m}",), outputs=(f"wmo{m}",)),
            _I(PipelineOp.FREE, buffer=f"wmb{m}"),
        ]
        if m < wm_micro - 1:
            wm.append(_I(PipelineOp.FREE, buffer=f"wmo{m}"))
    if wm_micro:
        wm += [
            _I(PipelineOp.SEND, buffer=f"wmo{wm_micro - 1}",
               tag="pipe:wm:out"),
            _I(PipelineOp.FREE, buffer=f"wmo{wm_micro - 1}"),
        ]
    return {"policy": tuple(pol), "wm": tuple(wm)}


def _is_grad(buffer: str) -> bool:
    return buffer.startswith("g") and buffer[1:].isdigit()


def validate_schedules(schedules: Dict[str, Tuple[Instruction, ...]], *,
                       feeds: Sequence[str], collects: Sequence[str]
                       ) -> Dict[str, Dict]:
    """Abstractly interpret the schedules; raise on any unsound program.

    Checks, per stream: RUN/SEND/FREE only touch live buffers, no buffer
    is redefined while live, everything is FREEd by the end. Globally:
    every RECV tag is fed exactly once (by the host or a peer SEND) and
    every SEND is consumed (host collect or peer RECV). Returns per-stream
    stats including the micro-grad high-water mark (the 1F1B bound).
    """
    sends: Dict[str, str] = {}
    recvs: Dict[str, str] = {}
    stats: Dict[str, Dict] = {}
    for name, sched in schedules.items():
        live: set = set()
        peak_grads = grads_live = 0
        for ins in sched:
            if ins.op == PipelineOp.RECV:
                if ins.tag in recvs:
                    raise ValueError(f"[{name}] duplicate RECV {ins.tag}")
                recvs[ins.tag] = name
                if ins.buffer in live:
                    raise ValueError(
                        f"[{name}] RECV redefines live {ins.buffer!r}")
                live.add(ins.buffer)
            elif ins.op == PipelineOp.RUN:
                dead = [b for b in ins.inputs if b not in live]
                if dead:
                    raise ValueError(
                        f"[{name}] {ins!r} reads dead buffers {dead}")
                clash = [b for b in ins.outputs if b in live]
                if clash:
                    raise ValueError(
                        f"[{name}] {ins!r} redefines live {clash}")
                live.update(ins.outputs)
                grads_live += sum(1 for b in ins.outputs if _is_grad(b))
                peak_grads = max(peak_grads, grads_live)
            elif ins.op == PipelineOp.SEND:
                if ins.buffer not in live:
                    raise ValueError(
                        f"[{name}] SEND of dead buffer {ins.buffer!r}")
                if ins.tag in sends:
                    raise ValueError(f"[{name}] duplicate SEND {ins.tag}")
                sends[ins.tag] = name
            elif ins.op == PipelineOp.FREE:
                if ins.buffer not in live:
                    raise ValueError(
                        f"[{name}] FREE of dead buffer {ins.buffer!r}")
                live.discard(ins.buffer)
                if _is_grad(ins.buffer):
                    grads_live -= 1
        if live:
            raise ValueError(f"[{name}] leaks buffers {sorted(live)}")
        stats[name] = {"instructions": len(sched),
                       "peak_micro_grads": peak_grads}

    for tag, stream in recvs.items():
        if tag not in feeds and sends.get(tag, stream) == stream:
            raise ValueError(f"RECV {tag} in [{stream}] never fed")
    for tag, stream in sends.items():
        if tag not in collects and recvs.get(tag, stream) == stream:
            raise ValueError(f"SEND {tag} from [{stream}] never consumed")
    return stats


# --------------------------------------------------------------------------
# executor
# --------------------------------------------------------------------------

def host_microbatches(batch: TrajectoryBatch, n_micro: int
                      ) -> List[TrajectoryBatch]:
    """Contiguous micro-batch slices (App. C.1) as views (numpy arrays or
    tensors) — exactly ``core.train_step._microbatches``'s slicing."""
    b = batch.obs_tokens.shape[0]
    # floor like the fused step does (a non-divisible tail is dropped)
    mb = b // n_micro
    if mb == 0:
        raise ValueError(f"batch of {b} too small for {n_micro} "
                         f"micro-batches")
    return [TrajectoryBatch(*(None if x is None else x[i * mb:(i + 1) * mb]
                              for x in batch))
            for i in range(n_micro)]


class _Mailbox:
    """Tagged single-consumer rendezvous between host and streams."""

    def __init__(self):
        self._cv = threading.Condition()
        self._slots: Dict[str, object] = {}

    def put(self, tag: str, value) -> None:
        with self._cv:
            if tag in self._slots:
                raise RuntimeError(f"mailbox tag {tag!r} already occupied")
            self._slots[tag] = value
            self._cv.notify_all()

    def take(self, tag: str, timeout: float = 120.0):
        deadline = time.monotonic() + timeout
        with self._cv:
            while tag not in self._slots:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"RECV {tag!r} timed out")
                self._cv.wait(left)
            return self._slots.pop(tag)


def _tree_leaves(value):
    """Leaves of a tree of dicts, tuples (NamedTuples too) and lists."""
    if isinstance(value, dict):
        for k in sorted(value):
            yield from _tree_leaves(value[k])
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tree_leaves(v)
    elif value is not None:
        yield value


def _tree_nbytes(value) -> int:
    total = 0
    for leaf in _tree_leaves(value):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
    return total


def _to_device(value, device: torch.device):
    """``value`` moved onto ``device``: tensors by ``.to`` (no copy where
    they are there already), a numpy batch through ``batch_from_numpy``,
    structure kept."""
    if isinstance(value, TrajectoryBatch) \
            and isinstance(value.obs_tokens, np.ndarray):
        return batch_from_numpy(value, device=device)
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, dict):
        return {k: _to_device(v, device) for k, v in value.items()}
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_to_device(v, device) for v in value))
    return value


class _Stream:
    """One submesh's persistent worker thread executing its schedule.

    ``cuda_stream``: on a CUDA submesh, the stream RUNs issue to (None:
    the device's current stream, the default one for a new thread)."""

    def __init__(self, name: str, submesh: Submesh, mailbox: _Mailbox,
                 run_fns: Dict[str, Callable], *, place: bool,
                 cuda_stream: Optional[torch.cuda.Stream] = None):
        self.name = name
        self.submesh = submesh
        self.mailbox = mailbox
        self.run_fns = run_fns
        self.place = place                       # move RECVs onto the
                                                 # submesh (disjoint
                                                 # layouts only)
        self.cuda_stream = cuda_stream
        self.busy_s = 0.0
        self.peak_live_bytes = 0
        self.peak_grad_bytes = 0
        self._schedule: Tuple[Instruction, ...] = ()
        self._ready: Optional[torch.cuda.Event] = None
        self._go = threading.Event()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._shutdown = False
        self._thread = threading.Thread(
            target=self._loop, name=f"pipeline-{name}", daemon=True)
        self._thread.start()

    def submit(self, schedule: Tuple[Instruction, ...],
               ready: Optional[torch.cuda.Event] = None) -> None:
        """Run ``schedule``; ``ready``: an event on the host's stream that
        this stream's CUDA work waits on first."""
        self._schedule = schedule
        self._ready = ready
        self._error = None
        self._done.clear()
        self._go.set()

    def wait(self, timeout: float = 300.0) -> None:
        if not self._done.wait(timeout):
            raise TimeoutError(f"pipeline stream {self.name!r} wedged")
        if self._error is not None:
            raise self._error

    def close(self) -> None:
        self._shutdown = True
        self._go.set()
        self._thread.join(timeout=10.0)

    # -- instruction interpreter ------------------------------------------------
    def _loop(self) -> None:
        while True:
            self._go.wait()
            self._go.clear()
            if self._shutdown:
                return
            try:
                self._execute(self._schedule)
            except BaseException as e:  # surfaced by wait()
                self._error = e
            self._done.set()

    def _device_ctx(self):
        dev = self.submesh.device
        if dev.type != "cuda":
            return contextlib.nullcontext()
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(dev))
        if self.cuda_stream is not None:
            ctx.enter_context(torch.cuda.stream(self.cuda_stream))
        return ctx

    def _sync(self) -> None:
        if self.submesh.device.type == "cuda":
            torch.cuda.current_stream(self.submesh.device).synchronize()

    def _execute(self, schedule: Tuple[Instruction, ...]) -> None:
        bufs: Dict[str, object] = {}
        live_bytes = grad_bytes = 0
        sizes: Dict[str, int] = {}
        self.busy_s = 0.0
        with self._device_ctx():
            if self._ready is not None:
                torch.cuda.current_stream(
                    self.submesh.device).wait_event(self._ready)
            for ins in schedule:
                if ins.op == PipelineOp.RECV:
                    value = self.mailbox.take(ins.tag)
                    if self.place:
                        # commit the buffer to this submesh so RUNs
                        # execute here, not where the producer left it
                        value = _to_device(value, self.submesh.device)
                    bufs[ins.buffer] = value
                elif ins.op == PipelineOp.RUN:
                    fn = self.run_fns[ins.stage]
                    args = tuple(bufs[b] for b in ins.inputs)
                    t0 = time.perf_counter()
                    if _tel is not None:
                        with _tel.span("train.stage", cat="train",
                                       args={"stage": ins.stage,
                                             "submesh": self.name,
                                             "micro": ins.micro}):
                            out = fn(*args)
                            self._sync()
                    else:
                        out = fn(*args)
                        self._sync()
                    self.busy_s += time.perf_counter() - t0
                    if len(ins.outputs) == 1:
                        out = (out,)
                    for b, v in zip(ins.outputs, out):
                        bufs[b] = v
                        sizes[b] = _tree_nbytes(v)
                        live_bytes += sizes[b]
                        if _is_grad(b):
                            grad_bytes += sizes[b]
                    self.peak_live_bytes = max(self.peak_live_bytes,
                                               live_bytes)
                    self.peak_grad_bytes = max(self.peak_grad_bytes,
                                               grad_bytes)
                elif ins.op == PipelineOp.SEND:
                    self.mailbox.put(ins.tag, bufs[ins.buffer])
                elif ins.op == PipelineOp.FREE:
                    bufs.pop(ins.buffer)
                    freed = sizes.pop(ins.buffer, 0)
                    live_bytes -= freed
                    if _is_grad(ins.buffer):
                        grad_bytes -= freed


class PipelineExecutor:
    """Drives the static schedules over a :class:`SubmeshLayout`.

    ``run_round`` executes one training round: the policy stream consumes
    ``n_micro`` micro-batches and produces the updated TrainState; the WM
    stream (when a stage is attached via :meth:`set_wm_stage`) trains the
    world model on its own submesh concurrently. Per-round bubble
    fraction = 1 − busy/wall per stream, fed to the
    ``pipeline_bubble_frac`` histogram.

    Live bytes count RUN outputs by buffer name, as the reference counts
    them: the port's ``grad_reduce`` folds in place, so ``acc{m+1}`` is
    the tensor ``acc{m}`` was, counted twice until ``acc{m}`` is FREEd.
    """

    FEEDS = ("host:policy:state", "host:policy:micro{m}",
             "host:wm:micro{m}")
    COLLECTS = ("pipe:policy:state", "pipe:policy:metrics", "pipe:wm:out")

    def __init__(self, program: StepProgram, layout: SubmeshLayout, *,
                 n_micro: int = 0, metrics=None):
        self.program = program
        self.layout = layout
        self.n_micro = n_micro or program.n_micro
        self.metrics = metrics
        self._wm_stage: Optional[Callable] = None
        self._wm_feed: Optional[Callable] = None
        self.wm_micro = 0
        self.last_bubble: Dict[str, float] = {}
        self.rounds = 0

        self._mailbox = _Mailbox()
        # single-device submesh: move RECVd buffers to that device so RUNs
        # land there. Multi-device policy submeshes keep the state's own
        # (ZeRO-placed) layout.
        place = layout.disjoint and len(layout.policy.devices) == 1
        pol_fns = {
            "fwd_bwd": program.stage("fwd_bwd").fn,
            "grad_reduce/init": program.stage("grad_reduce").init,
            "grad_reduce": program.stage("grad_reduce").fn,
            "optim_update": program.stage("optim_update").fn,
        }
        pol_dev = layout.policy.device
        self._policy = _Stream(
            "policy", layout.policy, self._mailbox, pol_fns, place=place,
            cuda_stream=(torch.cuda.Stream(pol_dev)
                         if pol_dev.type == "cuda" else None))
        self._wm = _Stream("wm", layout.wm, self._mailbox, {}, place=False)
        self._closed = False

    # -- WM stage attachment -----------------------------------------------------
    def set_wm_stage(self, stage_fn: Callable, feed_fn: Callable, *,
                     wm_micro: int = 1) -> None:
        """Attach the world-model stage: ``stage_fn(batch)`` runs one WM
        train cycle (host callable owning its own state, run with the WM
        submesh's device entered: ``torch.device`` as the default for new
        tensors, and the current CUDA device); ``feed_fn()`` returns the
        next WM batch or None."""
        submesh = self.layout.wm

        def run(batch):
            with torch.device(submesh.device):
                return stage_fn(batch)

        self._wm.run_fns = {"wm_update": run}
        self._wm_stage = stage_fn
        self._wm_feed = feed_fn
        self.wm_micro = wm_micro

    # -- one round ---------------------------------------------------------------
    def run_round(self, state, batch):
        """One optimizer step through the pipeline. Returns
        ``(new_state, metrics_dict, wm_out)``."""
        if self._closed:
            raise RuntimeError("executor is closed")
        wm_batches = []
        if self._wm_feed is not None:
            for _ in range(self.wm_micro):
                b = self._wm_feed()
                if b is None:
                    break
                wm_batches.append(b)
        schedules = build_train_schedules(self.n_micro, len(wm_batches))

        self._mailbox.put("host:policy:state", state)
        for m, mb in enumerate(host_microbatches(batch, self.n_micro)):
            self._mailbox.put(f"host:policy:micro{m}", mb)
        for m, wb in enumerate(wm_batches):
            self._mailbox.put(f"host:wm:micro{m}", wb)

        ready = None
        if self.layout.policy.device.type == "cuda":
            # the policy stream's work follows what the host queued
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(
                self.layout.policy.device))
        t0 = time.perf_counter()
        self._policy.submit(schedules["policy"], ready)
        self._wm.submit(schedules["wm"])
        self._policy.wait()
        self._wm.wait()
        wall = max(time.perf_counter() - t0, 1e-9)

        new_state = self._mailbox.take("pipe:policy:state", timeout=1.0)
        metrics = self._mailbox.take("pipe:policy:metrics", timeout=1.0)
        wm_out = (self._mailbox.take("pipe:wm:out", timeout=1.0)
                  if wm_batches else None)

        self.rounds += 1
        self.last_bubble = {
            s.name: max(0.0, 1.0 - s.busy_s / wall)
            for s in (self._policy, self._wm)
            if s is self._policy or wm_batches
        }
        if self.metrics is not None:
            for frac in self.last_bubble.values():
                self.metrics.observe("pipeline_bubble_frac", frac)
        if _tel is not None:
            _tel.instant("pipeline.round", cat="train",
                         args={"round": self.rounds, "wall_s": wall,
                               **{f"bubble_{k}": v
                                  for k, v in self.last_bubble.items()}})
        return new_state, metrics, wm_out

    @property
    def peak_grad_bytes(self) -> int:
        return self._policy.peak_grad_bytes

    @property
    def peak_live_bytes(self) -> Dict[str, int]:
        return {"policy": self._policy.peak_live_bytes,
                "wm": self._wm.peak_live_bytes}

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._policy.close()
            self._wm.close()
