"""The check that decides ``correct`` fails what it must: the control (the
reference one precision down) and a run whose timed path alters an answer.

The control also runs on the card at each cell's own size (``cuda`` marker;
``python -m pytest --noconftest -m cuda portbench/tests`` there)."""

from __future__ import annotations

import io
import json
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import compare  # noqa: E402
from portbench.control import control_readings  # noqa: E402
from portbench.harness import find_cell, load_json, main  # noqa: E402

BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY = {
    "dense": {"config": {"n_docs": 3000},
              "traffic": {"queries_per_call": 8, "pool_calls": 4, "check_queries": 32, "trace_calls": 4}},
    "multi_vector": {"config": {"n_docs": 60, "corpus": {"law": "gaussian_tokens", "min_tokens": 20,
                                                         "max_tokens": 48}},
                     "traffic": {"queries_per_call": 4, "pool_calls": 4, "check_queries": 16,
                                 "trace_calls": 4}},
}
# where each kind's answers are produced: the op the index layer calls
PRODUCERS = {"dense": ("autorag_research_tpu_torch.index.dense", "dense_topk_verified"),
             "multi_vector": ("autorag_research_tpu_torch.index.multi_vector", "maxsim_topk")}


def kind_of(cell: str) -> str:
    _, conf = find_cell(BENCH, cell)
    return load_json(ROOT / conf["file"])["kind"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seed", [11, 2_500_000_003, 4_000_000_007])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell, seed):
    out = control_readings(cell, seed, torch.device("cpu"), overrides=TINY[kind_of(cell)])
    assert out["readings"]["malformed"] == 0
    assert not compare.within(out["readings"], out["limits"]), out


def _run(cell: str, monkeypatch, alter) -> dict:
    module, name = PRODUCERS[kind_of(cell)]
    mod = __import__(module, fromlist=[name])
    produce = getattr(mod, name)

    def broken(*args, **kwargs):
        out = list(produce(*args, **kwargs))
        out[0], out[1] = alter(out[0].clone(), out[1].clone())
        return tuple(out)

    monkeypatch.setattr(mod, name, broken)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["--workload", cell, "--seed", "901", "--seconds", "0.3", "--trace", "0"],
                  device="cpu", overrides=TINY[kind_of(cell)], check_modules=False)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _other_row(scores, rows):
    rows[:, -1] = torch.where(rows[:, -1] == 0, 1, 0)
    return scores, rows


def _score_off(scores, rows):
    return scores + 1e-3 * scores.abs().clamp(min=1.0), rows


@pytest.mark.parametrize("alter", [_other_row, _score_off], ids=["id", "score"])
@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_is_not_correct(cell, alter, monkeypatch):
    res = _run(cell, monkeypatch, alter)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, monkeypatch):
    res = _run(cell, monkeypatch, lambda s, r: (s, r))
    assert res["correct"] is True, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell, card):
    proc = subprocess.run([sys.executable, "portbench/control.py", "--workload", cell, "--seeds", "31"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["control_fails"] is True


@pytest.mark.parametrize("cell", CELLS[:2])
def test_raising_search_is_not_correct(cell, monkeypatch):
    """Calls of the window that raise (after the set-up's warm-up ones)."""
    module, name = PRODUCERS[kind_of(cell)]
    mod = __import__(module, fromlist=[name])
    produce, seen = getattr(mod, name), []

    def fail(*args, **kwargs):
        seen.append(1)
        if len(seen) > 3:
            raise RuntimeError("planted")
        return produce(*args, **kwargs)

    monkeypatch.setattr(mod, name, fail)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["--workload", cell, "--seed", "5", "--seconds", "0.2", "--trace", "0"],
                  device="cpu", overrides=TINY[kind_of(cell)], check_modules=False)
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is False and res["failed"] == res["attempted"] > 0
