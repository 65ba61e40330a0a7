"""Host-side data: interaction datasets, synthetic generators and the
normalized bipartite graph (numpy copies of `gsrs_tpu.data`)."""
