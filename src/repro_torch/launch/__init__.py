"""Launchers (reference: ``repro.launch``). Ported so far: ``mesh``, the
production and local device meshes; ``worker``, the dial-in entry point
of a connected rollout worker; ``train`` and ``serve`` come with ROADMAP
A8."""
