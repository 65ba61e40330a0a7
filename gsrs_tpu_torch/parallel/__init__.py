"""The (data, model) mesh on `torch.distributed` (port of `gsrs_tpu.parallel`)."""
