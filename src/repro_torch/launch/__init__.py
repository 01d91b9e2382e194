"""Launchers (reference: ``repro.launch``): ``mesh``, the production and
local device meshes; ``steps``, the step programs and their spec builders;
``train`` and ``serve``, the training and serving CLIs; ``dryrun``, the
dry run of the step programs on a fake process group (host only); and
``worker``, the dial-in entry point of a connected rollout worker."""
