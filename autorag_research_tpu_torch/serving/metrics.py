"""Serving observability: Prometheus-text metrics for the HTTP layer.

The reference's observability is the results database itself (SURVEY §5 —
per-query scores and latency rows queried after the fact); a production
serving deployment needs live operational metrics instead. This module is a
dependency-free collector + renderer for the exposition text format
(prometheus.io/docs/instrumenting/exposition_formats): counters with labels,
cumulative histograms, and gauges, exposed by ``GET /metrics`` on the
serving handle.

Design notes:
- one lock around plain dicts — the hot path adds a histogram observation
  per request, microseconds against a multi-ms device call;
- histogram buckets are fixed at construction (latency buckets span 5 ms
  through 30 s first-call tails; batch-size buckets follow the power-of-two
  sizes the batcher pads to).

The port's copy of the JAX package's ``serving/metrics.py``, verbatim in
its code.
"""

from __future__ import annotations

import threading
from bisect import bisect_left


def _escape_label_value(v) -> str:
    # exposition format requires \\, \", \n escaping in label values — one
    # unescaped pipeline name would make the WHOLE scrape unparseable
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str] | None) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float):
        if v.is_integer() and abs(v) < 1e15:
            return str(int(v))
        return repr(round(v, 9))
    return str(v)


LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class ServingMetrics:
    """Thread-safe counter/gauge/histogram registry with Prometheus text output."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> labelstr -> value
        self._counters: dict[str, dict[str, float]] = {}
        self._gauges: dict[str, dict[str, float]] = {}
        # name -> labelstr -> [bucket counts..., +Inf count, sum, count]
        self._hists: dict[str, dict[str, list[float]]] = {}
        self._hist_buckets: dict[str, tuple[float, ...]] = {}
        self._help: dict[str, tuple[str, str]] = {}  # name -> (type, help)

    # ----------------------------------------------------------- registration
    def _declare(self, name: str, kind: str, help_text: str) -> None:
        self._help.setdefault(name, (kind, help_text))

    # ------------------------------------------------------------- operations
    def inc(
        self,
        name: str,
        labels: dict[str, str] | None = None,
        value: float = 1.0,
        help_text: str = "",
    ) -> None:
        key = _fmt_labels(labels)
        with self._lock:
            self._declare(name, "counter", help_text)
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + value

    def set_gauge(
        self,
        name: str,
        value: float,
        labels: dict[str, str] | None = None,
        help_text: str = "",
    ) -> None:
        key = _fmt_labels(labels)
        with self._lock:
            self._declare(name, "gauge", help_text)
            self._gauges.setdefault(name, {})[key] = value

    def add_gauge(
        self,
        name: str,
        delta: float,
        labels: dict[str, str] | None = None,
        help_text: str = "",
    ) -> None:
        key = _fmt_labels(labels)
        with self._lock:
            self._declare(name, "gauge", help_text)
            series = self._gauges.setdefault(name, {})
            series[key] = series.get(key, 0.0) + delta

    def observe(
        self,
        name: str,
        value: float,
        labels: dict[str, str] | None = None,
        buckets: tuple[float, ...] = LATENCY_BUCKETS,
        help_text: str = "",
    ) -> None:
        key = _fmt_labels(labels)
        with self._lock:
            self._declare(name, "histogram", help_text)
            # buckets are fixed per metric NAME: rows are sized and rendered
            # with the first-registered tuple, so a second caller with
            # different buckets would silently corrupt sum/count slots
            registered = self._hist_buckets.setdefault(name, buckets)
            if registered != buckets:
                raise ValueError(
                    f"histogram '{name}' already registered with buckets "
                    f"{registered}; got {buckets}"
                )
            series = self._hists.setdefault(name, {})
            row = series.get(key)
            if row is None:
                row = series[key] = [0.0] * (len(buckets) + 3)
            # cumulative: bump the first bucket >= value and all above
            i = bisect_left(buckets, value)
            for j in range(i, len(buckets)):
                row[j] += 1
            row[len(buckets)] += 1  # +Inf
            row[len(buckets) + 1] += value  # sum
            row[len(buckets) + 2] += 1  # count

    # -------------------------------------------------------------- rendering
    def render(self) -> str:
        lines: list[str] = []
        with self._lock:
            for name, series in sorted(self._counters.items()):
                kind, help_text = self._help[name]
                if help_text:
                    lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} {kind}")
                for key, val in sorted(series.items()):
                    lines.append(f"{name}{key} {_fmt_value(val)}")
            for name, series in sorted(self._gauges.items()):
                kind, help_text = self._help[name]
                if help_text:
                    lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} {kind}")
                for key, val in sorted(series.items()):
                    lines.append(f"{name}{key} {_fmt_value(val)}")
            for name, series in sorted(self._hists.items()):
                kind, help_text = self._help[name]
                buckets = self._hist_buckets[name]
                if help_text:
                    lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} {kind}")
                for key, row in sorted(series.items()):
                    base = key[1:-1] if key else ""
                    for i, ub in enumerate(list(buckets) + [float("inf")]):
                        le = f'le="{_fmt_value(ub)}"'
                        label = "{" + (base + "," if base else "") + le + "}"
                        lines.append(f"{name}_bucket{label} {_fmt_value(row[i])}")
                    lines.append(f"{name}_sum{key} {_fmt_value(row[len(buckets) + 1])}")
                    lines.append(f"{name}_count{key} {_fmt_value(row[len(buckets) + 2])}")
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------ convenience
    def latency_quantile(self, name: str, q: float, labels: dict[str, str] | None = None) -> float | None:
        """Approximate quantile from the cumulative histogram (upper bucket
        bound). For eyeballing in tests/health — dashboards should compute
        quantiles from the exported buckets."""
        key = _fmt_labels(labels)
        with self._lock:
            row = self._hists.get(name, {}).get(key)
            if row is None:
                return None
            buckets = self._hist_buckets[name]
            total = row[len(buckets) + 2]
            if total == 0:
                return None
            target = q * total
            for i, ub in enumerate(buckets):
                if row[i] >= target:
                    return ub
            return float("inf")
