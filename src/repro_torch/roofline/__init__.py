"""Three-term roofline analysis of the port's step programs (reference:
``repro.roofline``)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    RooflineTerms,
    collective_bytes,
    model_flops,
    terms_from_program,
)
