"""dj_tpu_torch.utils: the timing helpers (``timing``)."""

from . import timing
from .timing import PhaseTimer, annotate, profile

__all__ = ["PhaseTimer", "annotate", "profile", "timing"]
