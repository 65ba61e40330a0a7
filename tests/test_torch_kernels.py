"""The port's list of hand-written kernels (`gsrs_tpu_torch.kernels`):
it is the ``csrc/*.cu`` sources, and every kernel on it has a launch
counter."""

import pathlib

from gsrs_tpu_torch import kernels


def test_the_kernel_list_is_the_sources_and_each_kernel_is_counted():
    stems = sorted(p.stem for p in pathlib.Path(kernels.CSRC_DIR).glob("*.cu"))
    assert list(kernels.KERNELS) == stems and stems
    counts = kernels.launch_counts()
    missing = [k for k in kernels.KERNELS if k not in counts]
    assert missing == [], f"kernels without a launch counter: {missing}"
    assert kernels.launches_since(counts) == {k: 0 for k in counts}
