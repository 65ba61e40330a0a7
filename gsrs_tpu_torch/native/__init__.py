"""Native (C++) host-side components of the port, built at first use with
the host's g++ and bound with ctypes (copy of `gsrs_tpu.native`)."""

from gsrs_tpu_torch.native.build import NativeSampler, load_native_sampler

__all__ = ["NativeSampler", "load_native_sampler"]
