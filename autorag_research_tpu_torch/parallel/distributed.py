"""Multi-process initialization for corpus-sharded retrieval and training.

The port's copy of the JAX package's ``parallel/distributed.py``.
``torch.distributed`` joins the processes (one a host, or one a card), the
corpus axis of :func:`global_corpus_mesh` spans every process's devices
host-major, and ``parallel/sharded.py`` all-gathers each process's per-shard
``[Q, k]`` candidate lists over the process group before the one merge: only
those lists cross hosts. For training, :func:`global_train_mesh` lays the
``(dp, tp)`` grid over every process's devices host-major, so each process
holds whole dp rows (``parallel/train.py`` all-gathers the embeddings and
all-reduces the gradients).

Nothing on a machine tells a program of a cluster: the address, the number
of processes and this process's rank come from the arguments or from
torch's standard environment variables (``MASTER_ADDR`` / ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``).
"""

from __future__ import annotations

import logging
import os

import torch

from autorag_research_tpu_torch.parallel.mesh import (
    DeviceMesh,
    corpus_mesh,
    train_mesh,
    visible_devices,
)

logger = logging.getLogger("AutoRAG-Research-TPU")


def world_size() -> int:
    """Processes in the ``torch.distributed`` group, 1 when none is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Join the process group from the arguments or the environment
    (``coordinator_address`` is ``tcp://host:port``, else ``MASTER_ADDR`` /
    ``MASTER_PORT``; ``WORLD_SIZE``; ``RANK``). NCCL where a CUDA device is
    visible, gloo otherwise, unless ``backend`` names one. Returns True when
    more than one process is joined; with no settings it is a no-op that
    returns False (one host)."""
    import torch.distributed as dist

    env_np = os.environ.get("WORLD_SIZE")
    num_processes = num_processes if num_processes is not None else (int(env_np) if env_np else None)
    env_pid = os.environ.get("RANK")
    process_id = process_id if process_id is not None else (int(env_pid) if env_pid else None)
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator_address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if coordinator_address is None and num_processes is None:
        logger.debug("single-host mode: no process group settings")
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs an address, a number of processes and a rank")
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(
            backend, init_method=coordinator_address, world_size=num_processes, rank=process_id
        )
    multi = dist.get_world_size() > 1
    if multi:
        logger.info("distributed: process %d/%d (%s)", dist.get_rank(), dist.get_world_size(),
                    dist.get_backend())
    return multi


def gather_devices(local_devices=None) -> tuple[list[torch.device], list[int]]:
    """Every process's devices, host-major, and the rank holding each.
    ``local_devices`` defaults to this process's visible CUDA devices."""
    import torch.distributed as dist

    local = [str(torch.device(d)) for d in (local_devices if local_devices is not None else visible_devices())]
    if world_size() <= 1:
        return [torch.device(d) for d in local], [0] * len(local)
    per_rank: list = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, local)
    devices, ranks = [], []
    for rank, devs in enumerate(per_rank):
        devices += [torch.device(d) for d in devs]
        ranks += [rank] * len(devs)
    return devices, ranks


def global_corpus_mesh(n_dp: int = 1, local_devices=None) -> DeviceMesh:
    """A ``(dp, corpus)`` mesh over every process's devices (call
    :func:`initialize_distributed` first in every process); each process
    passes its own ``local_devices`` (default: its visible CUDA devices)."""
    devices, ranks = gather_devices(local_devices)
    return corpus_mesh(n_dp=n_dp, devices=devices, ranks=ranks)


def global_train_mesh(tp: int | None = None, local_devices=None) -> DeviceMesh:
    """A ``(dp, tp)`` mesh over every process's devices, host-major (call
    :func:`initialize_distributed` first in every process): with as many
    devices in each process as a multiple of ``tp``, each process holds
    whole dp rows; a tp group that spans processes is refused when the
    parameters are sharded over it."""
    devices, ranks = gather_devices(local_devices)
    return train_mesh(devices=devices, tp=tp, ranks=ranks)
