"""table_grad_ms.train, table_grad_ms.bert4rec: device milliseconds a step
of the backward of the training loss's table row gathers, whichever
kernels run it: PyTorch's ``index_put_`` with accumulation (cub's radix
sort, then ``indexing_backward_kernel``) or the port's own backward
(`gsrs_tpu_torch/ops/gather.py`: the ids' radix sort, then the
``gather_rows_grad`` kernels). ``.train`` reads the BPR loss's gathers in
`gsrs_tpu_torch/models/lightgcn.py::_pairwise_bpr`, ``.bert4rec`` the
sequence encoder's item-table gather in
`gsrs_tpu_torch/models/_transformer.py::encode_transformer`. One
yardstick for a program with either backward."""

KERNELS = ("indexing_backward_kernel", "DeviceRadixSort", "gather_rows_grad")


def read(ctx):
    steps = ctx.work.get("steps")
    t = ctx.kernel_s(KERNELS)
    if not steps or t <= 0:
        return None
    return 1e3 * t / steps
