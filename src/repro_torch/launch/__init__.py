"""Launchers (reference: ``repro.launch``). Ported so far: ``worker``, the
dial-in entry point of a connected rollout worker; ``train`` and
``serve`` come with ROADMAP A8."""
