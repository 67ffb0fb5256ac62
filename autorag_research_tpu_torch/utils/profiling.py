"""Host spans for traces and run reports.

The port's part of the JAX package's ``utils/profiling.py``:

- :func:`annotate` — a named span that ``torch.profiler`` traces show
  (``record_function``), the counterpart of the JAX ``TraceAnnotation``;
- :class:`SpanRecorder` — lightweight in-process span log (start/stop named
  sections with wall-clock durations) exported as JSON; the ``Executor``
  records its stages with it.

``trace`` and ``KernelTimer`` come with the port's benchmark.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@contextlib.contextmanager
def annotate(name: str):
    """Named span visible in profiler traces."""
    with torch.profiler.record_function(name):
        yield


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
