"""Train-step program IR: one optimizer step as a graph of named stages, as
in the reference ``repro/runtime/step_program.py``.

The single source of truth for *what one training step is*, consumed by
the executors that must never drift apart:

  * the fused single-device path (``StepProgram.fused``: the port's
    ``core.train_step.train_step`` bound to a device, the default
    ``TrainerWorker`` step, which is ``make_train_step``);
  * the pipelined executor (``runtime/pipeline_exec.py``), which runs each
    device stage from a static per-submesh RUN/SEND/RECV/FREE
    instruction schedule;
  * the sync/async schedulers, which only ever see
    ``TrainerWorker.train_on_batch`` and therefore inherit whichever of
    the two executors the config selected.

A stage is a named function with declared dataflow (``inputs`` →
``outputs`` buffer names) and, when a mesh is supplied, declared
partition specs for its pinned buffers. Stage *functions* come from
``core.train_step``; the fused path composes the very same callables, so
pipelined-vs-fused parity is structural.

Step layout (paper §3.1 / App. C):

    collate(host) → fwd_bwd(×K micro) → grad_reduce(×K) →
        optim_update → publish(host)

The reference jits its stages; the port runs them eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import batch_from_numpy
from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.core import train_step as core
from repro_torch.runtime.trainer import collate_segments


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One named stage of the step program.

    ``fn`` is the stage body (None for host-side stages the runtime owns,
    e.g. publish). ``init`` optionally builds the stage's carried
    accumulator (grad_reduce). ``per_micro`` stages run once per
    micro-batch inside a gradient-accumulation window. ``specs`` maps
    buffer names to spec trees — the declared placements of those buffers
    when a mesh is in play.
    """

    name: str
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    fn: Optional[Callable] = None
    init: Optional[Callable] = None
    kind: str = "device"                 # {"device", "host"}
    per_micro: bool = False
    specs: Optional[Dict[str, object]] = None


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """Validated sequence of stages + the fused whole-step function."""

    name: str
    stages: Tuple[StageSpec, ...]
    inputs: Tuple[str, ...] = ()         # externally-fed buffer names
    fused_fn: Optional[Callable] = None
    n_micro: int = 1

    def __post_init__(self):
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names in {names}")
        live = set(self.inputs)
        for s in self.stages:
            missing = [b for b in s.inputs if b not in live]
            if missing:
                raise ValueError(
                    f"stage {s.name!r} reads {missing} before any stage "
                    f"produces them (live: {sorted(live)})")
            live.update(s.outputs)

    def stage(self, name: str) -> StageSpec:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(f"{self.name!r} has no stage {name!r}; have "
                       f"{[s.name for s in self.stages]}")

    def fused(self, *, donate: bool = False) -> Callable:
        """The whole step as one call — the single-device default path.

        The port's step updates the state's params and AdamW moments in
        place (``optim/adamw.py``) whatever ``donate`` says: the input
        state is always consumed, as the reference's is only with
        ``donate=True``. Keep a copy to step the same state twice."""
        if self.fused_fn is None:
            raise ValueError(f"program {self.name!r} has no fused form")
        return self.fused_fn

    def describe(self) -> str:
        lines = [f"program {self.name} (K={self.n_micro}; "
                 f"feeds: {', '.join(self.inputs)})"]
        for s in self.stages:
            micro = f" ×{self.n_micro}" if s.per_micro else ""
            lines.append(
                f"  {s.name:<14}[{s.kind}]{micro:<4} "
                f"({', '.join(s.inputs)}) -> ({', '.join(s.outputs)})")
        return "\n".join(lines)


def _train_state_specs(cfg: ModelConfig, mesh):
    """Declared specs for the TrainState buffer: params under the TP/FSDP
    rules, f32 Adam moments additionally ZeRO-sharded over ``data``
    (optim/zero.py), scalars replicated. The shapes come from a ``meta``
    parameter tree (no memory)."""
    from repro_torch.models.policy import init_policy_params
    from repro_torch.optim import zero
    from repro_torch.sharding import rules
    from repro_torch.sharding.rules import P, mesh_shape

    shapes = init_policy_params(cfg, 0, device="meta")
    pspec = rules.param_specs(cfg, shapes, mesh)
    mspec = zero.shard_moments_spec(shapes, pspec, data_axis="data",
                                    data_size=mesh_shape(mesh).get("data", 1))
    return {"params": pspec, "moments": mspec, "scalars": P()}


def build_train_step_program(cfg: ModelConfig, rl: RLConfig, *,
                             remat: bool = False, n_micro: int = 0,
                             mesh=None, device="cuda") -> StepProgram:
    """The GIPO train step as a StepProgram, its fused form bound to
    ``device`` (the card unless the caller asks for the CPU).

    Buffer conventions (what the executor's schedule names refer to):
      * ``state``   — TrainState (params frozen across the window, eq. 7)
      * ``micro``   — one contiguous micro-batch slice (App. C.1): numpy
        arrays, carried to the state's device by ``fwd_bwd``, or tensors
      * ``grads``   — one micro-batch's grads (FREEd after folding)
      * ``aux``     — (metrics, packed adv stats) from that micro-batch
      * ``acc``     — (f32 grad accumulator, stats accumulator), folded in
        place
    """
    dev = resolve_device(device)
    n_micro = n_micro or rl.grad_accum
    specs = _train_state_specs(cfg, mesh) if mesh is not None else None

    def fwd_bwd(state, micro):
        if isinstance(micro.obs_tokens, np.ndarray):
            micro = batch_from_numpy(micro, device=state.version.device)
        return core.microbatch_grads(state.params, micro, state.adv_norm,
                                     cfg=cfg, rl=rl, remat=remat)

    def grad_init(state):
        return (core.zero_grads_like(state.params),
                torch.zeros((3,), dtype=torch.float32,
                            device=state.version.device))

    def grad_reduce(acc, grads, aux):
        return core.accumulate_grads(acc[0], grads, acc[1], aux[1], n_micro)

    def optim_update(state, acc, aux):
        return core.apply_update(state, acc[0], acc[1], aux[0], rl=rl)

    stages = (
        StageSpec("collate", inputs=("segments",), outputs=("batch",),
                  fn=collate_segments, kind="host"),
        StageSpec("fwd_bwd", inputs=("state", "micro"),
                  outputs=("grads", "aux"), fn=fwd_bwd, per_micro=True),
        StageSpec("grad_reduce", inputs=("acc", "grads", "aux"),
                  outputs=("acc",), fn=grad_reduce, init=grad_init,
                  per_micro=True),
        StageSpec("optim_update", inputs=("state", "acc", "aux"),
                  outputs=("state", "metrics"), fn=optim_update,
                  specs={"state": specs} if specs else None),
        StageSpec("publish", inputs=("state",), outputs=(), kind="host"),
    )
    return StepProgram(name="gipo_train_step", stages=stages,
                       inputs=("segments", "state", "micro", "acc"),
                       fused_fn=core.make_train_step(cfg, rl, remat=remat,
                                                     device=dev),
                       n_micro=n_micro)
