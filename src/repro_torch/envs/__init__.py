"""Environments (reference: ``repro.envs``)."""
from repro_torch.envs.toy_manipulation import (  # noqa: F401
    FRAME_DIM,
    GRID,
    SUITES,
    T_OBS,
    TASKS_PER_SUITE,
    ManipulationEnv,
    lognormal_latency,
)
