"""One reader per per-layer metric, ``read(ctx) -> float | None``: in
``<metric name>.py``, or for a quantity split by the end-to-end metric it
moves (``k1_roofline.eval``, ``k1_roofline.serve``) in the one file of the
quantity, ``<name up to its first dot>.py``. The harness loads them by
file name."""
