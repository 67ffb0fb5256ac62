"""Profiling and tracing utilities.

The port's copy of the JAX package's ``utils/profiling.py``:

- :func:`trace` — context manager around ``torch.profiler`` (CPU and, where
  a card is present, CUDA activities) writing a Chrome trace into a
  directory, the counterpart of the JAX ``jax.profiler`` trace;
- :func:`annotate` — a named span that ``torch.profiler`` traces show
  (``record_function``), the counterpart of the JAX ``TraceAnnotation``;
- :class:`KernelTimer` — sustained timing of a callable over stacked inputs:
  one warm-up pass, then the timed pass back to back, by CUDA events on the
  card or the host clock on the CPU;
- :class:`SpanRecorder` — lightweight in-process span log (start/stop named
  sections with wall-clock durations) exported as JSON; the ``Executor``
  records its stages with it.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Capture a ``torch.profiler`` trace: ``with trace('/tmp/trace'):
    step()`` writes ``<log_dir>/trace.json`` (Chrome trace format, readable
    in Perfetto). Yields the profiler, whose ``key_averages()`` splits the
    span by operator."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named span visible in profiler traces."""
    with torch.profiler.record_function(name):
        yield


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _index(tree, i: int):
    """Slice ``i`` of the first dimension of every tensor in ``tree``."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, i) for v in tree)
    return tree[i]


class KernelTimer:
    """Sustained timing of ``fn``: ``measure(fn, stacked_inputs,
    *static_args)`` calls ``fn(x, *static_args)`` for every slice ``x`` of
    the first dimension of ``stacked_inputs`` (a tensor, or a tuple / list /
    dict of tensors with that dimension in common), back to back, once to
    warm up and once timed, and returns the timed pass's seconds divided by
    ``reps``, as the JAX timer does (so stack ``reps`` slices). On a card the
    pass is timed by CUDA events on the current stream; on the CPU by the
    host clock."""

    def __init__(self, reps: int = 20):
        self.reps = reps

    def measure(self, fn, stacked_inputs, *static_args) -> float:
        leaves = [t for t in _leaves(stacked_inputs) if isinstance(t, torch.Tensor)]
        if not leaves:
            raise ValueError("stacked_inputs holds no tensor")
        n = leaves[0].shape[0]
        device = leaves[0].device

        def run():
            return [fn(_index(stacked_inputs, i), *static_args) for i in range(n)]

        run()  # warm-up: builds, caches and allocator pools
        if device.type == "cuda":
            with torch.cuda.device(device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3 / self.reps
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) / self.reps


@dataclass
class Span:
    name: str
    start: float
    duration_ms: float


@dataclass
class SpanRecorder:
    spans: list[Span] = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append(
                Span(name, t0, (time.perf_counter() - t0) * 1000.0)
            )

    def summary(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.duration_ms
        return out

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(
            json.dumps([s.__dict__ for s in self.spans], indent=2)
        )
