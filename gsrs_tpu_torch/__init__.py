"""PyTorch + CUDA port of gsrs_tpu for NVIDIA Hopper.

Module names follow the JAX package (`gsrs_tpu`), which stays the
reference every module here is tested against. The port imports neither
JAX nor anything of `gsrs_tpu`: it keeps its own copies of the host code
it needs. Entry points run on the first CUDA device unless the caller
passes ``device="cpu"`` (`gsrs_tpu_torch.device.resolve_device`).
"""
