"""One run of one cell: set-up, the measured window, the check, one JSON line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``, its
configuration file and ``traffic/<traffic>.json``, the index kind's builder
``kinds/<kind>.py``, its reference ``reference/<kind>.py``, its work count
``work/<kind>.py``, and each metric's reader ``metrics/<name>.py`` (see
:func:`reader_name`).

The window is a closed loop: one call after another, each a page of queries
through the index's public ``search``, from the first call until the first
call that ends past ``--seconds``. ``--trace 1`` spends the first half of the
window without the profiler, then up to the traffic's ``trace_calls`` calls
under ``torch.profiler``, which the per-layer metrics read, then
``STACK_CALLS`` calls traced with Python stacks, which name what the host did
while the device idled.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import random
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import compare
from portbench.trace import TraceView
from portbench.work import bound_s

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# no module of these top-level names may be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "autorag_research_tpu")
CALL_SPAN = "portbench.call"
# calls traced with Python stacks (their overhead lengthens them) for the idle gaps' names
STACK_CALLS = 4


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Forbidden top-level names among the loaded modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def find_cell(bench: dict, name: str) -> tuple[dict, dict]:
    """(the workload entry, its configuration entry) of cell ``name``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, conf


def load_cell(name: str, overrides: dict | None = None) -> tuple[dict, dict, dict, dict]:
    """(the benchmark, the cell, its configuration, its traffic), with the
    keys of ``overrides["config"]`` / ``overrides["traffic"]`` merged in."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, conf = find_cell(bench, name)
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    overrides = overrides or {}
    cfg.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    return bench, cell, cfg, traffic


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: with ``trace`` the per-layer ones,
    else the end-to-end ones. A metric without ``workloads`` applies to every
    cell that reports the end-to-end metric it moves."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def applies(m: dict) -> bool:
        if "workloads" in m:
            return cell in m["workloads"]
        return "moves" not in m or applies(e2e[m["moves"]])

    return [m for m in bench["per_layer" if trace else "end_to_end"] if applies(m)]


def reader_name(metric: str) -> str:
    """The reader of a metric: ``metrics/<name>.py``, the name up to its first
    dot (``qps.dense`` and ``qps.multi_vector`` are one quantity, split by the
    cells that report it)."""
    return metric.split(".")[0]


@dataclass
class Records:
    """What a run recorded, for the metric readers."""

    cell: str
    cfg: dict
    traffic: dict
    setup_s: float = 0.0
    index_build_s: float = 0.0
    # the stretch without the profiler, the whole window with --trace 0: each
    # call's seconds from submit until its hits were on the host, the queries
    # answered, and the seconds from the first submit to the last answer
    call_s: list = field(default_factory=list)
    queries: int = 0
    window_s: float = 0.0
    # the verified proof's failures over the queries of calls that ran one
    proof_failures: int = 0
    proof_queries: int = 0
    # (operations, bytes) of one call
    work: tuple = (0.0, 0.0)
    # the device memory peak of the run until the window closed (0 off the card)
    memory_peak_bytes: int = 0
    trace: TraceView | None = None

    @property
    def call_bound_s(self) -> float:
        return bound_s(*self.work)


class Window:
    """The closed loop of calls, with a seeded reservoir of answers to check."""

    def __init__(self, kind, index, pool: list, k: int, keep_calls: int, seed: int):
        self.kind, self.index, self.pool, self.k = kind, index, pool, k
        self.q = len(pool[0])
        self.k_eff = min(k, index.n_docs)
        self.keep_calls = keep_calls
        self.rng = random.Random(seed)
        self.kept: list[tuple[int, list]] = []
        self.calls = 0
        self.call_s: list[float] = []
        self.failed = 0
        self.proof_failures = 0
        self.proof_queries = 0
        self.first_error: str | None = None

    def call(self, span: str | None) -> None:
        page_no = self.calls % len(self.pool)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(span) if span else nullcontext():
                hits = self.kind.search(self.index, self.pool[page_no], self.k)
        except Exception:  # a call that raises fails its queries; the run goes on
            hits = None
            if self.first_error is None:
                self.first_error = traceback.format_exc()
        self.call_s.append(time.perf_counter() - t0)
        if hits is None or len(hits) != self.q or any(len(h) != self.k_eff for h in hits):
            self.failed += self.q
        else:
            fails = self.kind.proof_failures(self.index)
            if fails is not None:
                self.proof_failures += fails
                self.proof_queries += self.q
            self._keep(page_no, hits)
        self.calls += 1

    def _keep(self, page_no: int, hits: list) -> None:
        """Reservoir sampling: every call of the window is equally likely kept."""
        if len(self.kept) < self.keep_calls:
            self.kept.append((page_no, hits))
            return
        j = self.rng.randrange(self.calls + 1)
        if j < self.keep_calls:
            self.kept[j] = (page_no, hits)

    def run(self, seconds: float, span: str | None = None, max_calls: int | None = None) -> tuple[list, int, float]:
        """Calls until one ends past ``seconds`` (or ``max_calls`` are made):
        (their seconds, the queries they answered, seconds from the first
        submit to the last answer)."""
        t0 = time.perf_counter()
        first, failed = self.calls, self.failed
        while True:
            self.call(span)
            now = time.perf_counter()
            if now - t0 >= seconds or (max_calls is not None and self.calls - first >= max_calls):
                answered = (self.calls - first) * self.q - (self.failed - failed)
                return self.call_s[first:], answered, now - t0


def quarters(call_s: list, q: int) -> str:
    """qps and the 95th percentile of call time in each quarter of a
    stretch of back-to-back calls: whether a run's speed drifts inside it."""
    if len(call_s) < 8:
        return "too few calls"
    ends = np.cumsum(call_s)
    part = np.minimum((4 * (ends - np.asarray(call_s)) / ends[-1]).astype(int), 3)
    out = []
    for i in range(4):
        s = np.asarray(call_s)[part == i]
        if s.size:
            out.append(f"{q * s.size / s.sum():.1f} qps, p95 {1e3 * np.percentile(s, 95):.2f} ms")
    return "; ".join(out)


def parse_args(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it (None without it)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (subprocess.SubprocessError, ValueError, IndexError):
        return None


def _traced_stretch(win: Window, seconds: float, max_calls: int, device: torch.device,
                    with_stack: bool = False) -> TraceView:
    """Calls under ``torch.profiler`` (one unannotated call first, which
    takes the profiler's own start-up), read back from its Chrome trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out_dir = Path(tempfile.mkdtemp(prefix="portbench-trace-"))
    try:
        with torch.profiler.profile(activities=acts, with_stack=with_stack) as prof:
            win.call("portbench.warm")
            win.run(seconds, span=CALL_SPAN, max_calls=max_calls)
        path = out_dir / "trace.json"
        prof.export_chrome_trace(str(path))
        log(f"trace: {path.stat().st_size / 2**20:.1f} MiB")
        return TraceView.load(path, CALL_SPAN)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _check(kind_name: str, cfg: dict, traffic: dict, seed: int, device: torch.device,
           pool: list, kept: list, n: int, k_eff: int) -> dict:
    """The checked answers against the reference: the three numbers."""
    if not kept:  # every call failed: nothing to check, and the run is not correct
        return {"malformed": 0, "rank_gap": 0.0, "score_gap": 0.0, "checked": 0}
    reference = importlib.import_module(f"portbench.reference.{kind_name}")
    queries, answers = [], []
    for page_no, hits in kept:
        queries.extend(pool[page_no])
        answers.extend(hits)
    k = int(traffic["k"])
    ids, scores = compare.hits_arrays(answers, k)
    counts = np.array([len(h) for h in answers])
    ref = reference.evaluate(cfg, seed, device, queries, k, {"program": ids})
    readings = compare.judge(ids, scores, counts, ref["top_s"], ref["at"]["program"], n, k_eff)
    readings["checked"] = len(answers)
    return readings


def main(argv=None, *, process_start: float | None = None, device: str | None = None,
         overrides: dict | None = None, check_modules: bool = True) -> int:
    """Run one cell and print its result line. ``device``, ``overrides``
    (keys merged into the configuration and the traffic) and
    ``check_modules=False`` serve the tests' dry runs on the CPU inside a
    test process, which has imported jax itself; a real run finds its card or
    fails, and refuses to print if a forbidden module was loaded."""
    t_start = time.time() if process_start is None else process_start
    args = parse_args(argv)
    bench, cell, cfg, traffic = load_cell(args.workload, overrides)

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            log(f"needs {cell['chips']} CUDA device(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    kind_name = cfg["kind"]
    kind = importlib.import_module(f"portbench.kinds.{kind_name}")
    work = importlib.import_module(f"portbench.work.{kind_name}")
    k = int(traffic["k"])
    rec = Records(cell=args.workload, cfg=cfg, traffic=traffic)

    # ---- set-up: inputs from the seed, the index, warm-up of the cell's shapes
    t0 = time.perf_counter()
    corpus = kind.make_corpus(cfg, args.seed, dev)
    pool = kind.make_pool(cfg, traffic, args.seed, corpus)
    sync()
    log(f"inputs drawn in {time.perf_counter() - t0:.2f} s")
    rec.work = work.count(kind.work_shape(cfg, traffic, corpus))
    t0 = time.perf_counter()
    index = kind.build_index(cfg, corpus, dev)
    sync()
    rec.index_build_s = time.perf_counter() - t0
    del corpus
    gc.collect()
    log(f"index built in {rec.index_build_s:.2f} s")
    keep_calls = max(1, math.ceil(int(traffic["check_queries"]) / int(traffic["queries_per_call"])))
    win = Window(kind, index, pool, k, keep_calls, args.seed)
    for i in range(int(traffic["warmup_calls"])):
        kind.search(index, pool[i % len(pool)], k)
    sync()
    rec.setup_s = time.time() - t_start
    log(f"set-up {rec.setup_s:.2f} s")

    # ---- the window
    if args.trace:
        rec.call_s, rec.queries, rec.window_s = win.run(args.seconds / 2)
        rec.trace = _traced_stretch(win, args.seconds / 2, int(traffic["trace_calls"]), dev)
        stacks = _traced_stretch(win, args.seconds / 2, STACK_CALLS, dev, with_stack=True)
    else:
        rec.call_s, rec.queries, rec.window_s = win.run(args.seconds)
    rec.proof_failures, rec.proof_queries = win.proof_failures, win.proof_queries
    attempted, failed = win.calls * win.q, win.failed
    log(f"window: {win.calls} calls, {attempted} queries, {failed} failed; without the profiler "
        f"{len(rec.call_s)} calls in {rec.window_s:.3f} s")
    if win.first_error:
        log(f"first failed call:\n{win.first_error}")
    rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    log(f"window by quarters: {quarters(rec.call_s, win.q)}")

    # ---- the program's state goes, then the reference checks the kept answers
    n_docs, k_eff = index.n_docs, win.k_eff
    kept = win.kept
    del index, win
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    readings = _check(kind_name, cfg, traffic, args.seed, dev, pool, kept, n_docs, k_eff)
    log(f"check of {readings['checked']} answers in {time.perf_counter() - t0:.2f} s")
    limits = dict(cfg["check"])
    correct = compare.within(readings, limits) and failed == 0 and readings["checked"] > 0

    # ---- metrics by their readers
    values = {}
    for m in metrics_of(bench, args.workload, bool(args.trace)):
        reader = importlib.import_module(f"portbench.metrics.{reader_name(m['name'])}")
        v = reader.read(rec)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": 1,
        "memory_peak_bytes": rec.memory_peak_bytes,
    }
    if dev.type == "cuda":
        device_info["power_limit_w"] = power_limit_w()
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": values, "device": device_info}
    tv = rec.trace
    if tv is not None and tv.window is not None:
        lo, hi = tv.window
        device_info["busy_s"] = tv.busy_s(lo, hi)
        device_info["window_s"] = hi - lo
        result["breakdown"] = {"device_ops": tv.device_ops(), "idle_gaps": stacks.idle_gaps()}

    checks = {name: {"value": readings[name], "limit": limits[name]} for name in compare.NUMBERS}
    checks["failed_queries"] = {"value": failed, "limit": 0}
    result["checks"] = checks

    bad = forbidden_modules() if check_modules else []
    if bad:
        log(f"refused: modules of a forbidden top-level name were loaded: {bad}")
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
