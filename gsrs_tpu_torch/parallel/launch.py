"""Start the ranks of a mesh on this host.

`spawn` runs ``fn(*args)`` in ``n_ranks`` fresh processes
(`torch.multiprocessing`, spawn start method), each joined to one
process group through a ``file://`` rendezvous in a temporary directory
(no TCP port to collide with) and given a timeout, so that a rank that
hangs fails the run instead of holding it. Each rank's stdout is
silenced but rank 0's: rank 0 prints. A rank that raises or dies ends
every rank and makes `spawn` raise; nothing is caught and dropped. The
ranks' return values come back through ``torch.save`` files.

The CLIs call `spawn` themselves when asked for a mesh larger than 1 × 1
and no process group exists; `build_kernels_for` builds the CUDA kernels
once, in the parent, before the ranks start, so that N ranks do not run
N ``nvcc`` on each source.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch

from gsrs_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S, choose_backend, init_process_group, rank_device,
)


def build_kernels_for(device_type: str) -> None:
    """Build every kernel library before the ranks start (CUDA only)."""
    if device_type == "cuda":
        from gsrs_tpu_torch.kernels import KERNELS, build_kernels

        build_kernels(KERNELS)


def _rank_main(rank: int, n_ranks: int, backend: str, device_type: str, tmp: str,
               timeout_s: float, fn: Callable, args: Sequence) -> None:
    if rank != 0:
        sys.stdout = open(os.devnull, "w")
    os.environ["LOCAL_RANK"] = str(rank)
    device = rank_device(device_type, backend, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the host's cores shared out, not each rank's threads on all of them
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    init_process_group(backend, f"file://{os.path.join(tmp, 'rendezvous')}", n_ranks, rank,
                       timeout_s)
    try:
        out = fn(device, *args)
        torch.save(out, os.path.join(tmp, f"result{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def spawn(fn: Callable, n_ranks: int, *args: Any, device_type: str = "cuda",
          backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(device, *args)`` in ``n_ranks`` ranks → their return
    values by rank. ``fn`` is a module-level function (it is pickled);
    ``device`` is the rank's `torch.device`. ``backend``: as
    `choose_backend` decides; gloo on the CPU, and on CUDA only by name
    for more ranks than cards. Raises when a rank fails or the run
    outlasts ``timeout_s`` plus a minute of start-up."""
    import torch.multiprocessing as mp

    backend = choose_backend(backend, device_type, n_ranks)
    with tempfile.TemporaryDirectory(prefix="gsrs_mesh_") as tmp:
        ctx = mp.start_processes(_rank_main, nprocs=n_ranks, join=False, start_method="spawn",
                                 args=(n_ranks, backend, device_type, tmp, timeout_s, fn, args))
        deadline = time.monotonic() + timeout_s + 60.0
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"the {n_ranks} ranks did not finish in {timeout_s:.0f} s")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(n_ranks)]
