"""The plug-and-play pixel-interface world model (paper §4), as the
reference ``repro.wm``.

``M_obs`` is a DIAMOND-style EDM diffusion next-frame predictor; ``M_reward``
is a success-probability classifier; ``imagination`` runs the horizon-H
alternating rollout with potential-based rewards (eq. 4); ``wm_system``
attaches them onto the asynchronous pipeline's service bus
(``system.attach(WorldModelAttachment(...))`` — no orchestrator subclass)
with the decoupled trainer loops of §4.2."""
from repro_torch.wm.denoiser import (  # noqa: F401
    denoiser_init,
    denoiser_apply,
    denoiser_loss,
    sample_next_frame,
)
from repro_torch.wm.reward import (  # noqa: F401
    reward_init,
    reward_apply,
    reward_loss,
)
from repro_torch.wm.imagination import (  # noqa: F401
    ImaginationWorker,
    imagine_segment,
)
from repro_torch.wm.wm_system import (  # noqa: F401
    AcceRLWMSystem,
    WorldModelAttachment,
    WorldModelTrainer,
)
