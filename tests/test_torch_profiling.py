"""``utils/profiling.py``: ``trace``, ``annotate``, ``KernelTimer`` and
``SpanRecorder`` of the port, on the CPU (the CUDA-event timing carries the
``cuda`` marker and skips without a card).

``KernelTimer.measure`` follows the JAX timer: a warm-up pass over every
slice of the stacked inputs' first dimension, then the timed pass, and the
seconds divided by ``reps``; the JAX timer maps one jitted function over the
slices, so the per-slice results are compared with it here.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorag_research_tpu.utils import profiling as jprof
from autorag_research_tpu_torch.utils import profiling as tprof


def test_kernel_timer_walks_every_slice_twice():
    x = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)
    w = torch.ones(3)
    seen = []

    def fn(row, weight):
        seen.append(row.clone())
        return row @ weight

    secs = tprof.KernelTimer(reps=5).measure(fn, x, w)
    assert secs > 0 and np.isfinite(secs)
    assert len(seen) == 10  # one warm-up pass, one timed pass
    for i, row in enumerate(seen):
        assert torch.equal(row, x[i % 5])


def test_kernel_timer_takes_a_tree_of_inputs():
    rng = np.random.default_rng(0)
    stacked = {"a": torch.from_numpy(rng.normal(size=(4, 2, 3)).astype(np.float32)),
               "b": (torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),)}
    outs = []

    def fn(xs):
        out = xs["a"] @ xs["b"][0]
        outs.append(out)
        return out

    tprof.KernelTimer(reps=4).measure(fn, stacked)
    # the slices the JAX timer's lax.map feeds its function
    ref = jax.lax.map(lambda xs: xs["a"] @ xs["b"][0],
                      {"a": jnp.asarray(stacked["a"].numpy()), "b": (jnp.asarray(stacked["b"][0].numpy()),)})
    np.testing.assert_allclose(torch.stack(outs[4:]).numpy(), np.asarray(ref), rtol=1e-6)


def test_kernel_timer_divides_by_reps_as_jax_does():
    """Both timers return the timed pass over ``reps``: a pass of 4 slices
    of a 20 ms sleep reported with ``reps=4`` and ``reps=8``."""
    import time

    x = torch.zeros(4, 1)
    t4 = tprof.KernelTimer(reps=4).measure(lambda row: time.sleep(0.02), x)
    t8 = tprof.KernelTimer(reps=8).measure(lambda row: time.sleep(0.02), x)
    assert 0.018 <= t4 < 0.2 and 0.009 <= t8 < 0.1
    assert tprof.KernelTimer().reps == jprof.KernelTimer().reps == 20


def test_kernel_timer_refuses_inputs_without_a_tensor():
    with pytest.raises(ValueError, match="no tensor"):
        tprof.KernelTimer().measure(lambda x: x, [1, 2])


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    with tprof.trace(tmp_path / "tr") as prof:
        with tprof.annotate("embed_step"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "embed_step" in names and any("mm" in str(n) for n in names)
    assert any(e.key == "embed_step" for e in prof.key_averages())


def test_span_recorder_matches_jax(tmp_path):
    for mod in (tprof, jprof):
        rec = mod.SpanRecorder()
        with rec.span("a"):
            pass
        with rec.span("a"):
            pass
        with rec.span("b"):
            pass
        assert list(rec.summary()) == ["a", "b"]
        rec.dump(tmp_path / "spans.json")
        assert [s["name"] for s in json.loads((tmp_path / "spans.json").read_text())] == ["a", "a", "b"]


@pytest.mark.cuda
def test_kernel_timer_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(8, 512, 512, device="cuda")
    secs = tprof.KernelTimer(reps=8).measure(lambda a, b: a @ b, x, x[0])
    assert 0 < secs < 1
