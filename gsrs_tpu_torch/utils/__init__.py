"""Host-side helpers of the port (copies of `gsrs_tpu.utils`)."""

from gsrs_tpu_torch.utils.seeding import set_seed

__all__ = ["set_seed"]
