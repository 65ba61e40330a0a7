"""embed_grad_ms.train: device milliseconds a step of the backward of the
BPR loss's batch row gathers (``all_users[users]``, ``items[pos]``,
``items[neg]`` in `gsrs_tpu_torch/models/lightgcn.py::_pairwise_bpr`):
PyTorch's ``index_put_`` with accumulation, which sorts the indices
(cub's radix sort) and then runs its ``indexing_backward_kernel``."""

KERNELS = ("indexing_backward_kernel", "DeviceRadixSort")


def read(ctx):
    steps = ctx.work.get("steps")
    t = ctx.kernel_s(KERNELS)
    if not steps or t <= 0:
        return None
    return 1e3 * t / steps
