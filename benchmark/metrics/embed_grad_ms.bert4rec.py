"""embed_grad_ms.bert4rec: device milliseconds a step of the backward of
the encoder's item-table gathers (``item_emb[seqs]`` over the B·N tokens
in `gsrs_tpu_torch/models/_transformer.py::encode_transformer`). They run
the kernels of the graph cells' batch gathers, PyTorch's ``index_put_``
with accumulation (cub's radix sort, then ``indexing_backward_kernel``),
so this is `embed_grad_ms.train`'s reader, read in the sequential cell."""

from benchmark.harness import metric_reader

read = metric_reader("embed_grad_ms.train")
