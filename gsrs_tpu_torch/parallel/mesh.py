"""The (data, model) rank mesh and the process-group set-up (port of
`gsrs_tpu.parallel.mesh`).

JAX runs one process per host and lets GSPMD place work on the host's
devices; here each rank of the mesh is one process with one device, and
every collective is written out (`gsrs_tpu_torch.parallel.collectives`).
The ``data`` axis shards the BPR batch (gradient sum); the ``model`` axis
shards the embedding tables' rows and the item catalog (an all-gather for
propagation, a sharded top-k merge for retrieval). Ranks are laid out
row-major, as `make_mesh` reshapes the JAX devices: rank = d · M + m.

The backend is chosen explicitly, never by a silent switch
(`choose_backend`): NCCL with one rank per card, gloo on the CPU or for
several ranks on one card, and only when asked for by name. Either way
each rank's work (the kernels) runs on its own device; gloo stages CUDA
tensors through host memory for its collectives.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Optional

import torch
import torch.distributed as dist

from gsrs_tpu_torch.config import ParallelConfig

DEFAULT_TIMEOUT_S = 600.0  # a collective that waits longer than this fails the run


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``data_size`` × ``model_size`` grid of ranks.

    ``world``, ``data_group`` and ``model_group`` are the process groups
    of the whole mesh, of the ranks sharing this rank's model index (the
    data axis) and of those sharing its data index (the model axis). A
    group is None where its axis has one rank (its collectives are the
    identity), and all are None on `single_device_mesh`; a caller may
    give a one-rank axis a group, to run its collectives anyway."""

    data_size: int
    model_size: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    world: Any = None
    data_group: Any = None
    model_group: Any = None

    @property
    def size(self) -> int:
        return self.data_size * self.model_size

    @property
    def data_index(self) -> int:
        return self.rank // self.model_size

    @property
    def model_index(self) -> int:
        return self.rank % self.model_size

    @property
    def is_primary(self) -> bool:
        """Rank 0 prints, logs and writes the checkpoints."""
        return self.rank == 0


def choose_backend(requested: Optional[str], device_type: str, n_ranks: int) -> str:
    """The process-group backend for ``n_ranks`` ranks on ``device_type``:
    gloo on the CPU; NCCL on CUDA, one rank per card; gloo on CUDA only
    when asked for by name (it runs several ranks on one card). Raises on
    a request that cannot run, saying how to ask for one that can."""
    if requested not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {requested!r}")
    if device_type == "cpu":
        if requested == "nccl":
            raise ValueError("NCCL needs CUDA devices; the CPU runs gloo")
        return "gloo"
    if requested == "gloo":
        return "gloo"
    cards = torch.cuda.device_count()
    if n_ranks > cards:
        raise ValueError(
            f"{n_ranks} ranks on {cards} CUDA card(s): NCCL runs one rank per card. Ask for "
            "gloo by name (--dist_backend gloo) to run several ranks on one card")
    return "nccl"


def rank_device(device_type: str, backend: str, local_rank: int) -> torch.device:
    """A rank's device: the CPU, or a card (its own under NCCL; under gloo
    the ranks of a host take the host's cards in turn)."""
    if device_type == "cpu":
        return torch.device("cpu")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("a CUDA rank was asked for but no CUDA device is available")
    if backend == "nccl" and local_rank >= cards:
        raise ValueError(f"local rank {local_rank} has no card of its own ({cards} cards)")
    return torch.device("cuda", local_rank % cards)


def init_process_group(backend: str, init_method: str, world_size: int, rank: int,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timedelta(seconds=timeout_s))


def distributed_init(backend: Optional[str] = None, device_type: str = "cuda") -> bool:
    """Join the process group a launcher described in the environment →
    whether one is initialized. An explicit configuration is a
    coordinator address (``GSRS_COORDINATOR_ADDRESS``, or the JAX
    package's ``JAX_COORDINATOR_ADDRESS``) with ``GSRS_NUM_PROCESSES`` and
    ``GSRS_PROCESS_ID`` (or ``JAX_*``); ``torchrun``'s ``RANK`` and
    ``WORLD_SIZE`` (with ``MASTER_ADDR``/``MASTER_PORT``) are the other
    way. A partial explicit configuration raises: falling through would
    turn one launch into N independent single-process runs. No
    configuration: nothing to join (False), unless a group exists."""
    if dist.is_initialized():
        return True
    env = os.environ
    addr = env.get("GSRS_COORDINATOR_ADDRESS") or env.get("JAX_COORDINATOR_ADDRESS")
    nproc = env.get("GSRS_NUM_PROCESSES") or env.get("JAX_NUM_PROCESSES")
    pid = env.get("GSRS_PROCESS_ID") or env.get("JAX_PROCESS_ID")
    if addr and (nproc is None) != (pid is None):
        raise RuntimeError(
            "a coordinator address is set but only one of GSRS_NUM_PROCESSES/GSRS_PROCESS_ID "
            "(or JAX_*) is present: set both (explicit launcher) or neither")
    if addr and nproc is not None:
        world, rank, method = int(nproc), int(pid), f"tcp://{addr}"
    elif "RANK" in env and "WORLD_SIZE" in env:
        world, rank, method = int(env["WORLD_SIZE"]), int(env["RANK"]), "env://"
    else:
        return False
    init_process_group(choose_backend(backend, device_type, world), method, world, rank)
    return True


def make_mesh(
    cfg: Optional[ParallelConfig] = None,
    data_axis: Optional[int] = None,
    model_axis: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> Mesh:
    """This rank's `Mesh` over the initialized process group, whose size
    must be ``data_axis × model_axis``; the 1 × 1 mesh needs no group.
    Every rank must call it, in the same order, since it creates the
    axes' process groups. ``device``: the rank's device (default its
    card; raises without one)."""
    cfg = cfg or ParallelConfig()
    data_axis = cfg.data_axis if data_axis is None else data_axis
    model_axis = cfg.model_axis if model_axis is None else model_axis
    need = data_axis * model_axis
    if need < 1:
        raise ValueError(f"mesh {data_axis}x{model_axis} has no rank")
    if need == 1:
        return single_device_mesh(device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {data_axis}x{model_axis} mesh needs a process group of {need} ranks: start the "
            "ranks through gsrs_tpu_torch.parallel.launch (the CLIs do), torchrun or the "
            "GSRS_* launcher variables")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"mesh {data_axis}x{model_axis} needs {need} ranks, the process group "
                         f"has {world}")
    rank, backend = dist.get_rank(), dist.get_backend()
    model_groups = [dist.new_group([d * model_axis + m for m in range(model_axis)])
                    for d in range(data_axis)]
    data_groups = [dist.new_group([d * model_axis + m for d in range(data_axis)])
                   for m in range(model_axis)]
    if device is None:  # the rank's card; the CPU only when the caller passes it
        device = rank_device("cuda", backend, int(os.environ.get("LOCAL_RANK", rank)))
    return Mesh(data_axis, model_axis, rank, torch.device(device), backend, dist.group.WORLD,
                data_groups[rank % model_axis] if data_axis > 1 else None,
                model_groups[rank // model_axis] if model_axis > 1 else None)


def single_device_mesh(device: Optional[torch.device] = None) -> Mesh:
    """The degenerate 1 × 1 mesh: one card, trivial collectives."""
    from gsrs_tpu_torch.device import resolve_device

    return Mesh(1, 1, 0, resolve_device(device))
