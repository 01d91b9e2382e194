"""RL core: GIPO, JIT-GAE, lagged advantage normalisation and the train
step (reference: ``repro.core``)."""
