"""Device meshes for corpus-sharded retrieval and sharded training.

The port's copy of the JAX package's ``parallel/mesh.py``. A mesh is an
ordered two-axis grid of ``torch.device``s. For retrieval the axes are
``(dp, corpus)``: the corpus dimension of an index shards over the
``"corpus"`` axis, one shard a grid device, and ``mesh.shape`` is the JAX
mesh's ``{"dp": ..., "corpus": ...}``. For training they are ``(dp, tp)``
(:func:`train_mesh`, the JAX CLI's ``train --mesh`` rule): batch rows over
``dp``, the tensor-parallel slices of ``param_specs`` over ``tp``
(``parallel/train.py``). The retrieval engines
of ``parallel/sharded.py`` run in one process over the grid, as JAX's
``shard_map`` does (single controller), and merge the shards' top-k lists on
the first device of the row they search.

A grid may list one device more than once: a card (or the CPU) then holds
several shards and runs the same per-shard code and merge, which is how one
card, or the CPU tests, stand in for JAX's virtual devices. Each grid entry
also names the ``torch.distributed`` rank of the process that holds it, so
that a mesh built by ``parallel/distributed.py::global_corpus_mesh`` spans
the devices of every process, host-major.
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence

import torch

CORPUS_AXIS = "corpus"
DP_AXIS = "dp"
TP_AXIS = "tp"

_default_mesh: "DeviceMesh | None" = None


def process_rank() -> int:
    """This process's ``torch.distributed`` rank, 0 when no group is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class DeviceMesh:
    """An ordered grid of devices over two named axes, ``(dp, corpus)``
    unless ``axis_names`` says otherwise, each entry with the rank of the
    process that holds it (0 for every entry in one process)."""

    def __init__(self, grid: Sequence[Sequence], ranks: Sequence[Sequence[int]] | None = None,
                 axis_names: tuple[str, str] = (DP_AXIS, CORPUS_AXIS)):
        self.grid = [[torch.device(d) for d in row] for row in grid]
        n_dp = len(self.grid)
        n_corpus = len(self.grid[0]) if n_dp else 0
        if n_dp == 0 or n_corpus == 0 or any(len(row) != n_corpus for row in self.grid):
            raise ValueError("a mesh needs a non-empty rectangular grid of devices")
        self.ranks = [list(r) for r in ranks] if ranks is not None else [[0] * n_corpus for _ in range(n_dp)]
        if [len(r) for r in self.ranks] != [n_corpus] * n_dp:
            raise ValueError("ranks must have the grid's shape")
        if len(axis_names) != 2 or axis_names[0] == axis_names[1]:
            raise ValueError(f"a mesh has two distinct axis names, not {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = {axis_names[0]: n_dp, axis_names[1]: n_corpus}

    @property
    def size(self) -> int:
        return len(self.grid) * len(self.grid[0])

    def _row(self) -> int:
        """The dp row this process searches: the first that holds one of its
        devices (row 0 in one process)."""
        rank = process_rank()
        for i, row in enumerate(self.ranks):
            if rank in row:
                return i
        raise ValueError(f"process {rank} holds no device of this mesh")

    def corpus_devices(self) -> list[torch.device]:
        """The devices of the corpus axis that this process searches, shard
        order."""
        return list(self.grid[self._row()])

    def local_shards(self) -> list[bool]:
        """Per corpus shard: whether this process holds it."""
        rank = process_rank()
        return [r == rank for r in self.ranks[self._row()]]

    def merge_device(self) -> torch.device:
        """This process's first device of the searched row: where queries
        are prepared and the shards' lists merge."""
        return next(d for d, mine in zip(self.corpus_devices(), self.local_shards()) if mine)

    def shards_per_device(self) -> int:
        """Most shards of the searched row that one local device holds."""
        devs = [d for d, mine in zip(self.corpus_devices(), self.local_shards()) if mine]
        return max(Counter(devs).values(), default=0)

    def __repr__(self) -> str:
        return f"DeviceMesh(shape={self.shape}, grid={self.grid}, ranks={self.ranks})"


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself if it is a :class:`DeviceMesh`, else a TypeError."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a DeviceMesh (parallel/mesh.py::corpus_mesh), got {type(mesh).__name__}")
    if CORPUS_AXIS not in mesh.shape:
        raise ValueError(f"a retrieval mesh has a {CORPUS_AXIS!r} axis, not {mesh.axis_names}")
    return mesh


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device; none raises (there is no fallback to the
    CPU: ask for it with ``devices=[torch.device("cpu")] * P``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device for a mesh; pass devices=[torch.device('cpu')] * P to shard on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


def corpus_mesh(
    n_corpus: int | None = None, n_dp: int = 1, devices=None, ranks: Sequence[int] | None = None
) -> DeviceMesh:
    """Build a ``(dp, corpus)`` mesh, by default all visible CUDA devices on
    the corpus axis. ``devices`` may repeat a device; ``ranks`` (one a
    device) names the process holding each, all 0 by default."""
    devices = list(devices if devices is not None else visible_devices())
    ranks = list(ranks) if ranks is not None else [0] * len(devices)
    if len(ranks) != len(devices):
        raise ValueError("one rank a device")
    if n_corpus is None:
        n_corpus = len(devices) // n_dp
    if n_dp * n_corpus > len(devices) or n_dp * n_corpus == 0:
        raise ValueError(
            f"mesh {n_dp}x{n_corpus} needs {n_dp * n_corpus} devices, have {len(devices)}"
        )
    rows = range(n_dp)
    return DeviceMesh(
        [devices[i * n_corpus : (i + 1) * n_corpus] for i in rows],
        [ranks[i * n_corpus : (i + 1) * n_corpus] for i in rows],
    )


def train_mesh(devices=None, tp: int | None = None, ranks: Sequence[int] | None = None) -> DeviceMesh:
    """A ``(dp, tp)`` mesh for sharded training over ``devices`` (default:
    every visible card), by the JAX CLI's rule: ``tp = 2`` when the device
    count is even and above 1, else 1, and ``dp = n // tp``. ``devices`` may
    repeat a device (one card, or the CPU, standing in for several);
    ``ranks`` (one a device) names the process holding each."""
    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} does not divide {n} devices")
    mesh = corpus_mesh(n_corpus=tp, n_dp=n // tp, devices=devices, ranks=ranks)
    return DeviceMesh(mesh.grid, mesh.ranks, axis_names=(DP_AXIS, TP_AXIS))


def device_corpus_mesh(device) -> DeviceMesh:
    """The mesh a command builds on ``device`` (the CLI's ``--mesh``, a
    server's ``mesh=True``): every visible card for ``cuda``, else that one
    device (one card, or the CPU, runs unsharded)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return corpus_mesh()
    return corpus_mesh(devices=[device])


def device_train_mesh(device) -> DeviceMesh:
    """The mesh ``train --mesh`` builds on ``device``: :func:`train_mesh` of
    every visible card for ``cuda``, else of that one device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return train_mesh()
    return train_mesh(devices=[device])


def hybrid_corpus_mesh(n_slices: int | None = None, devices=None) -> DeviceMesh:
    """A ``(dp, corpus)`` mesh for several hosts: the corpus axis spans one
    process's devices and ``dp`` spans processes (JAX groups by
    ``slice_index``), so the per-shard merge never crosses hosts and each
    process searches a whole replica of the corpus. One process, or
    ``n_slices`` of 1, gives :func:`corpus_mesh` (over every process's
    devices when there are several)."""
    from autorag_research_tpu_torch.parallel.distributed import gather_devices, world_size

    n_proc = world_size()
    n_slices = n_slices if n_slices is not None else n_proc
    if n_proc <= 1:
        return corpus_mesh(devices=devices)
    devs, ranks = gather_devices(devices)
    if n_slices <= 1:
        return corpus_mesh(devices=devs, ranks=ranks)
    if n_slices != n_proc or len(devs) % n_proc:
        raise ValueError(f"{n_slices} slices over {n_proc} processes of {len(devs)} devices")
    return corpus_mesh(n_dp=n_proc, devices=devs, ranks=ranks)


def set_default_mesh(mesh: DeviceMesh | None) -> None:
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh() -> DeviceMesh:
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = corpus_mesh()
    return _default_mesh
