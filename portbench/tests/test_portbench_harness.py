"""CPU tests of the port's benchmark: the contract's shape, discovery by name,
the work counts, the references, the trace reader and the result line."""

from __future__ import annotations

import importlib
import io
import json
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import compare, inputs  # noqa: E402
from portbench.harness import find_cell, load_json, main, metrics_of, reader_name  # noqa: E402
from portbench.reference import dense as ref_dense  # noqa: E402
from portbench.reference import multi_vector as ref_mv  # noqa: E402
from portbench.trace import TraceView  # noqa: E402
from portbench.work import bound_s  # noqa: E402
from portbench.work import dense as work_dense  # noqa: E402
from portbench.work import multi_vector as work_mv  # noqa: E402

BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# tiny sizes for dry runs on the CPU
TINY = {
    "dense": {"config": {"n_docs": 3000},
              "traffic": {"queries_per_call": 8, "pool_calls": 4, "check_queries": 16, "trace_calls": 4}},
    "multi_vector": {"config": {"n_docs": 40, "corpus": {"law": "gaussian_tokens", "min_tokens": 20,
                                                         "max_tokens": 48}},
                     "traffic": {"queries_per_call": 4, "pool_calls": 4, "check_queries": 8,
                                 "trace_calls": 4}},
}


def kind_of(cell: str) -> str:
    _, conf = find_cell(BENCH, cell)
    return load_json(ROOT / conf["file"])["kind"]


def dry_run(cell: str, trace: int = 0, seconds: float = 0.3, seed: int = 3_000_000_019) -> dict:
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], device="cpu", overrides=TINY[kind_of(cell)], check_modules=False)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


# ------------------------------------------------------------ the contract's shape
def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [key for c in BENCH["configs"] for key in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_entries_have_only_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in CELLS:  # setup_s, one more end-to-end metric, and a per-layer metric a cell
        got = {m["name"] for m in metrics_of(BENCH, cell, False)}
        assert "setup_s" in got and len(got) >= 2
        for m in metrics_of(BENCH, cell, True):
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]


def test_paths_hold_the_command_and_every_file():
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()


# ------------------------------------------------------------ discovery by name
@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w, conf = find_cell(BENCH, cell)
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(ROOT / "portbench" / "traffic" / f"{w['traffic']}.json")
    for part in ("kinds", "reference", "work"):
        importlib.import_module(f"portbench.{part}.{cfg['kind']}")
    assert set(cfg["check"]) == set(compare.NUMBERS)
    for key in ("queries_per_call", "k", "query", "pool_calls", "warmup_calls", "check_queries", "trace_calls"):
        assert key in traffic, key
    for trace in (False, True):
        assert metrics_of(BENCH, cell, trace)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(importlib.import_module(f"portbench.metrics.{reader_name(metric)}").read)


def test_verified_fail_share_lists_the_dense_cells_only():
    m = next(m for m in BENCH["per_layer"] if m["name"] == "verified_fail_share")
    assert all(kind_of(c) == "dense" for c in m["workloads"])


# ------------------------------------------------------------ work counts
@pytest.mark.parametrize("shape, kind, ms, by_bytes", [
    ({"queries": 128, "n": 2_681_468, "d": 768, "k": 10}, work_dense, 1.229, True),
    ({"queries": 1024, "n": 2_681_468, "d": 768, "k": 10}, work_dense, 4.264, False),
    ({"queries": 128, "query_tokens": 128 * 32, "page_tokens": 10_300_000, "d": 128, "k": 10}, work_mv, 10.920, False),
    ({"queries": 1, "query_tokens": 32, "page_tokens": 10_300_000, "d": 128, "k": 10}, work_mv, 0.787, True),
])
def test_work_counts_give_the_cells_bounds(shape, kind, ms, by_bytes):
    ops, nbytes = kind.count(shape)
    assert bound_s(ops, nbytes) * 1e3 == pytest.approx(ms, abs=1e-3)
    assert (nbytes / 3.35e12 > ops / 989e12) == by_bytes


def test_dense_operations_alone():
    ops, _ = work_dense.count({"queries": 128, "n": 2_681_468, "d": 768, "k": 10})
    assert ops / 989e12 * 1e3 == pytest.approx(0.533, abs=5e-4)


# ------------------------------------------------------------ references
def test_tf32_rounding_keeps_ten_mantissa_bits():
    from portbench.reference.common import round_tf32

    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12, 3.0e-3])
    got = round_tf32(x)
    assert got.tolist()[:5] == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0]
    assert (got.view(torch.int32) & 0x1FFF == 0).all()


def _dense_brute(rows, queries, k):
    c = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    q = np.stack(queries) / np.linalg.norm(np.stack(queries), axis=1, keepdims=True)
    s = q.astype(np.float64) @ c.T.astype(np.float64)
    return -np.sort(-s, axis=1)[:, :k], s


def test_dense_reference_against_numpy_with_ties(monkeypatch):
    cfg = {"n_docs": 700, "dim": 24, "corpus": {"law": "gaussian"}}
    dev = torch.device("cpu")
    rows = inputs.dense_rows_host(cfg["corpus"], 5, 700, 24, dev)
    rows[300] = rows[10] * 2.0  # the same direction: a tie under cosine
    rows[650] = rows[10]

    def slabs(law, seed, n, d, device):  # small slabs, so the running merge is exercised
        for lo in range(0, n, 128):
            yield lo, torch.from_numpy(rows[lo : lo + 128].copy())

    monkeypatch.setattr(ref_dense, "dense_slabs", slabs)
    queries = [rows[10] + 0.01 * np.random.default_rng(1).standard_normal(24).astype(np.float32)]
    queries += list(np.random.default_rng(2).standard_normal((5, 24)).astype(np.float32))
    top, s = _dense_brute(rows, queries, 8)
    program = np.argsort(-s, axis=1, kind="stable")[:, :8]
    program[0, :3] = [650, 300, 10]  # tied hits in another order
    out = ref_dense.evaluate(cfg, 5, dev, queries, 8, {"program": program})
    np.testing.assert_allclose(out["top_s"], top, atol=2e-6)
    readings = compare.judge(program, np.take_along_axis(s, program, 1), np.full(6, 8), out["top_s"],
                             out["at"]["program"], 700, 8)
    assert readings["malformed"] == 0 and readings["rank_gap"] < 1e-6 and readings["score_gap"] < 1e-6


def test_multi_vector_reference_against_numpy_with_padding():
    law = {"law": "gaussian_tokens", "min_tokens": 3, "max_tokens": 9}
    cfg = {"n_docs": 30, "dim": 16, "corpus": law}
    dev = torch.device("cpu")
    toks, lens = inputs.pages_host(law, 7, 30, 16, dev)
    rng = np.random.default_rng(3)
    queries = [rng.standard_normal((t, 16)).astype(np.float32) for t in (1, 4, 7, 2)]
    unit = toks / np.linalg.norm(toks, axis=2, keepdims=True)
    want = np.zeros((4, 30))
    for i, q in enumerate(queries):
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        for p in range(30):
            want[i, p] = (qn @ unit[p, : lens[p]].T).max(axis=1).sum() / len(q)
    out = ref_mv.evaluate(cfg, 7, dev, queries, 5, {"program": np.argsort(-want, axis=1)[:, :5]})
    np.testing.assert_allclose(out["top_s"], -np.sort(-want, axis=1)[:, :5], atol=2e-6)
    np.testing.assert_allclose(out["at"]["program"], -np.sort(-want, axis=1)[:, :5], atol=2e-6)


def test_judge_flags_malformed_and_gaps():
    top = np.array([[0.9, 0.8, 0.7]])
    ids = np.array([[1, 2, 3]])
    assert compare.judge(ids, top.copy(), np.array([3]), top, top.copy(), 10, 3)["rank_gap"] == 0.0
    swapped = compare.judge(ids, top.copy(), np.array([3]), top, np.array([[0.8, 0.9, 0.7]]), 10, 3)
    assert swapped["rank_gap"] == pytest.approx(0.1)
    assert compare.judge(np.array([[1, 1, 3]]), top, np.array([3]), top, top, 10, 3)["malformed"] == 1
    assert compare.judge(np.array([[1, 2, 30]]), top, np.array([3]), top, top, 10, 3)["malformed"] == 1
    assert compare.judge(ids, top, np.array([2]), top, top, 10, 3)["malformed"] == 1


# ------------------------------------------------------------ the trace reader
def test_trace_view_busy_launches_and_gaps():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.call", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.call", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 60, "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 150, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 30, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 110, "dur": 30},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "portbench.call", "ts": 0, "dur": 300},
    ]
    tv = TraceView(ev, "portbench.call")
    assert tv.window == pytest.approx((0.0, 200e-6))
    assert tv.busy_s(0, 100e-6) == pytest.approx(40e-6)
    assert tv.busy_s(0, 200e-6) == pytest.approx(70e-6)
    assert tv.kernels_in(0, 100e-6) == 2 and tv.kernels_in(100e-6, 200e-6) == 0
    assert tv.device_ops()[0] == ["k1", pytest.approx(40e-6)]
    gaps = dict((n, t) for n, t in tv.idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(60e-6)
    assert gaps["aten::copy_"] == pytest.approx(60e-6)


def test_trace_view_keeps_raw_events_for_readers():
    """A reader can take what the views leave out, such as the bytes of the
    copies to the device inside the calls."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.call", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 5, "dur": 10,
         "args": {"bytes": 4096}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 150, "dur": 10,
         "args": {"bytes": 999}},
        {"ph": "i", "cat": "cpu_instant_event", "name": "x", "ts": 1},
    ]
    tv = TraceView(ev, "portbench.call")
    assert len(tv.events) == 3
    lo, hi = tv.calls[0]
    h2d = sum(e["args"]["bytes"] for e in tv.events
              if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"] and lo <= tv.seconds(e)[0] <= hi)
    assert h2d == 4096


# ------------------------------------------------------------ the result line
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_result_line(cell):
    res = dry_run(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in metrics_of(BENCH, cell, False)}
    assert set(res["metrics"]) == want
    for v in res["metrics"].values():
        assert v["value"] > 0 and set(v) == {"value", "unit"}
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_readers_see_the_memory_peak(monkeypatch):
    """A reader added as a file reads the run's device memory peak from the records."""
    import types

    from portbench import harness

    probe = types.ModuleType("portbench.metrics.peak_probe")
    probe.read = lambda rec: rec.memory_peak_bytes + 1
    monkeypatch.setitem(sys.modules, "portbench.metrics.peak_probe", probe)
    base = harness.metrics_of
    monkeypatch.setattr(harness, "metrics_of", lambda *a: base(*a) + [{"name": "peak_probe", "unit": "B"}])
    res = dry_run(CELLS[0])
    assert res["metrics"]["peak_probe"]["value"] == res["device"]["memory_peak_bytes"] + 1


@pytest.mark.parametrize("cell", CELLS[:2])
def test_traced_dry_run_result_line(cell):
    res = dry_run(cell, trace=1)
    assert res["correct"] is True
    assert set(res["metrics"]) <= {m["name"] for m in metrics_of(BENCH, cell, True)}
    assert "index_build_s" in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_dry_run_loads_no_jax_module():
    """A CPU dry run of every cell, in a fresh process (the repository's
    conftest imports jax in this one), leaves no module of a forbidden
    top-level name loaded; the harness itself refuses to print otherwise."""
    code = (
        "import io, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from contextlib import redirect_stdout\n"
        "from portbench.harness import FORBIDDEN, main\n"
        f"tiny = {TINY!r}\n"
        f"cells = {[(c, kind_of(c)) for c in CELLS]!r}\n"
        "for cell, kind in cells:\n"
        "    out = io.StringIO()\n"
        "    with redirect_stdout(out):\n"
        "        rc = main(['--workload', cell, '--seed', '77', '--seconds', '0.2', '--trace', '0'],\n"
        "                  device='cpu', overrides=tiny[kind])\n"
        "    assert rc == 0, (cell, rc)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)\n"
        "print(json.dumps({'bad': bad, 'torch_port': 'autorag_research_tpu_torch' in sys.modules}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "torch_port": True}
