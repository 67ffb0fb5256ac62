"""Reading a ``torch.profiler`` Chrome trace: device intervals, call spans, host events.

Times are in seconds on the trace's own clock, which the profiler shares
between host events and device events.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
NAME_CHARS = 160


def _short(name: str) -> str:
    """A Python frame ``/any/path/pkg/mod.py(12): fn`` as ``pkg/mod.py(12): fn``."""
    head, sep, tail = name.partition(".py(")
    if sep:
        head = "/".join(head.split("/")[-2:])
    return (head + sep + tail)[:NAME_CHARS]


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class TraceView:
    """The events of one traced stretch of calls.

    ``events`` keeps every complete event as the profiler wrote it, ``args``
    included (a ``gpu_memcpy``'s ``args["bytes"]``, a kernel's grid), so that a
    metric's reader can take what the views below do not."""

    def __init__(self, events: list[dict], call_name: str):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
        self.events = xs
        span = self.seconds
        self.calls = sorted(span(e) for e in xs
                            if e.get("cat") == "user_annotation" and e.get("name") == call_name)
        self.device_events = [(*span(e), str(e.get("name", ""))[:NAME_CHARS], e["cat"])
                              for e in xs if e.get("cat") in DEVICE_CATS]
        self.kernels = sorted(s for s, _, _, cat in self.device_events if cat == "kernel")
        self.busy = _merge([(s, e) for s, e, _, _ in self.device_events])
        self._busy_starts = [s for s, _ in self.busy]
        host = [(*span(e), _short(str(e.get("name", "")))) for e in xs if e.get("cat") in HOST_CATS]
        self.host_start = np.array([h[0] for h in host])
        self.host_end = np.array([h[1] for h in host])
        self.host_name = [h[2] for h in host]
        self.window = (self.calls[0][0], self.calls[-1][1]) if self.calls else None

    @classmethod
    def load(cls, path: str | Path, call_name: str) -> "TraceView":
        data = json.loads(Path(path).read_text())
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events, call_name)

    @staticmethod
    def seconds(event: dict) -> tuple[float, float]:
        """(start, end) of a raw event in seconds, on the views' clock."""
        s = float(event["ts"]) * 1e-6
        return s, s + float(event["dur"]) * 1e-6

    @property
    def has_device(self) -> bool:
        return bool(self.device_events)

    def busy_s(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi] in which some operation ran on the device."""
        total = 0.0
        i = max(0, bisect.bisect_right(self._busy_starts, lo) - 1)
        while i < len(self.busy) and self.busy[i][0] < hi:
            s, e = self.busy[i]
            total += max(0.0, min(e, hi) - max(s, lo))
            i += 1
        return total

    def kernels_in(self, lo: float, hi: float) -> int:
        """Kernels that started in [lo, hi]."""
        return bisect.bisect_right(self.kernels, hi) - bisect.bisect_left(self.kernels, lo)

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time in the window, by name."""
        lo, hi = self.window
        by = defaultdict(float)
        for s, e, name, _ in self.device_events:
            by[name] += max(0.0, min(e, hi) - max(s, lo))
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top] if t > 0]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The window's device-idle time by what the host was doing: each gap
        goes to the innermost host event around its middle."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy:
            if e <= lo or s >= hi:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < hi:
            gaps.append((t, hi))
        by = defaultdict(float)
        for s, e in gaps:
            mid = 0.5 * (s + e)
            around = np.nonzero((self.host_start <= mid) & (self.host_end >= mid))[0]
            if around.size:
                inner = around[np.argmin(self.host_end[around] - self.host_start[around])]
                name = self.host_name[inner]
            else:
                name = "(no host event)"
            by[name] += e - s
        return [[n, t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:top]]
