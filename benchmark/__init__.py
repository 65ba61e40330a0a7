"""The benchmark of `gsrs_tpu_torch` on one CUDA card: cells of a model
configuration under a traffic mix, found by name in ``BENCHMARK.json``
(see README.md)."""
