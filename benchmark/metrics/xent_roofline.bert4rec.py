"""xent_roofline.bert4rec: the head's softmax cross-entropy over the
catalog, forward and backward, against its least time: one read of the
slot × item logits and one write of their gradient at the HBM rate
(`benchmark.counts.bert4rec.xent_least_s`), a step, over the device time
of the kernels it launches in the traced window, in %.

Its kernels (`F.cross_entropy` in `gsrs_tpu_torch/models/bert4rec.py::
cloze_softmax_loss`): the log-softmax forward and backward (PyTorch's
``cunn_SoftMaxForward``/``cunn_SoftMaxBackward`` with the LogSoftMax
epilogues), the NLL forward and backward (``nll_loss_*``), and the float
fill that zeroes the NLL's input gradient (``FillFunctor<float>``; the
step's only other float fill zeroes the item table's gradient, 6.8 MB
against the logits' 1.1 GB). The attention's 200-wide softmax launches
PyTorch's warp softmax (``softmax_warp_forward``/``_backward``), not
counted."""

from benchmark.counts.bert4rec import xent_least_s

KERNELS = ("LogSoftMax", "nll_loss", "FillFunctor<float>")


def read(ctx):
    steps = ctx.work.get("steps")
    t = ctx.kernel_s(KERNELS)
    if not steps or t <= 0:
        return None
    return 100.0 * xent_least_s(ctx.cfg) * steps / t
