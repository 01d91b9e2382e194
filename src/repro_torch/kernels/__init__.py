"""The port's hand-written CUDA kernels, their plain PyTorch versions and
the routing between them (``dispatch``), exported as the reference's
``repro/kernels/__init__.py`` exports them. Importing builds nothing: the
kernels are compiled at their first launch.

As in the reference, the names ``flash_attention`` and ``ssd_scan`` here
are the kernels' functions, which hide their modules of the same name:
reach those modules with ``from repro_torch.kernels.ssd_scan import ...``.
"""
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.gipo_loss import (  # noqa: F401
    fused_policy_loss,
    gipo_head_loss,
    gipo_loss_fused,
)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401
from repro_torch.kernels import dispatch, ops, ref  # noqa: F401
