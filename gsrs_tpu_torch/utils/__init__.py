"""Host-side helpers of the port (copies of `gsrs_tpu.utils`)."""

from gsrs_tpu_torch.utils.seeding import set_seed
from gsrs_tpu_torch.utils.timer import Timer, profile_trace

__all__ = ["Timer", "profile_trace", "set_seed"]
