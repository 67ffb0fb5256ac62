"""The port's MaxSim pins (kernels #11 and #12) and its lists of any k, held
against the JAX package.

The same seeded numpy inputs go through both packages. The JAX side runs
``maxsim_topk_pallas`` (v1) and ``maxsim_topk_pallas_v3`` in
``interpret=True``, as its own tests run them on the CPU; the port runs on
CPU tensors, where ``maxsim_topk_v1`` / ``_v3`` take their plain versions.

Tolerances: ids equal; scores bitwise on dyadic tokens (small multiples of
1/8: every product and sum exact, so the TPU kernel's grouping matmul and the
port's sums agree), ``rtol = atol = 1e-5`` on random ones (f32 sums in
another order). Empty documents: the JAX v1 kernel lets their sum
overflow to -inf and leaves them out of its top-k, the JAX v3 kernel scores
them Tq_pad x -1e30; the port lists them at NEG_INF with their row on every
route, so against v1 the tests compare the entries JAX lists and against v3
every id and the non-empty scores. The CUDA kernels are held against these
plain versions in ``test_torch_kernels_cuda.py``.

The CUDA kernels compute each query's own rows only (one row for a query of
length 0), where the TPU kernels and the plain versions also sum the zero
pad rows: a test here shows on random (non-dyadic) data that, summed in the
kernels' order, those rows add exactly +0, so leaving them out changes no
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorag_research_tpu.index.multi_vector import MultiVectorIndex as JaxMultiVectorIndex
from autorag_research_tpu.ops import dense as jd
from autorag_research_tpu.ops import maxsim as jm
from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex
from autorag_research_tpu_torch.ops import dense as td
from autorag_research_tpu_torch.ops import maxsim as tm
from autorag_research_tpu_torch.ops.topk import INT_MAX, NEG_INF

RTOL = ATOL = 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
PINS = {
    "v1": (tm.maxsim_topk_v1, jm.maxsim_topk_pallas),
    "v3": (tm.maxsim_topk_v3, jm.maxsim_topk_pallas_v3),
}


def _data(seed, b=5, tq=7, n=60, td=21, d=40, empty=(), dyadic=False, zero_q=()):
    """Padded queries [b, tq, d] + lens and docs [n, td, d] + lens; pads are
    zero, ``empty`` rows have length 0, and so do the queries ``zero_q``;
    dyadic data also has two rows that duplicate a third (exact ties)."""
    rng = np.random.default_rng(seed)

    def vals(shape):
        if dyadic:
            return (rng.integers(-8, 9, size=shape) / 8.0).astype(np.float32)
        return rng.normal(size=shape).astype(np.float32)

    q = vals((b, tq, d))
    ql = rng.integers(1, tq + 1, size=b).astype(np.int32)
    ql[0] = tq
    ql[list(zero_q)] = 0
    q *= (np.arange(tq)[None, :] < ql[:, None])[:, :, None]
    docs = vals((n, td, d))
    dl = rng.integers(1, td + 1, size=n).astype(np.int32)
    if dyadic:
        docs[[9, n - 3]] = docs[4]
        dl[[9, n - 3]] = dl[4]
    dl[list(empty)] = 0
    docs *= (np.arange(td)[None, :] < dl[:, None])[:, :, None]
    return q, ql, docs, dl


def _jax(dtype, q, ql, docs, dl):
    jdt = DTYPES[dtype][1]
    return jnp.asarray(q, jdt), jnp.asarray(ql), jnp.asarray(docs, jdt), jnp.asarray(dl)


def _torch(dtype, q, ql, docs, dl):
    tdt = DTYPES[dtype][0]
    return (torch.from_numpy(q).to(tdt), torch.from_numpy(ql),
            torch.from_numpy(docs).to(tdt), torch.from_numpy(dl))


def _compare(pin, ts, ti, js, ji, dl, exact):
    """Port vs JAX top-k of one pin, empty documents by the pin's convention."""
    ts, ti, js, ji = ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji)
    empty = np.isin(ti, np.flatnonzero(dl == 0))
    if pin == "v1":
        listed = js > NEG_INF / 2  # JAX v1 leaves empty documents out
        assert not (empty & listed).any()
        keep = listed
    else:
        np.testing.assert_array_equal(ti, ji)  # v3 lists them in the same places
        assert (ts[empty] == np.float32(NEG_INF)).all() and (js[empty] < -1e30).all()
        keep = ~empty
    np.testing.assert_array_equal(ti[keep], ji[keep])
    if exact:
        np.testing.assert_array_equal(ts[keep], js[keep])
    else:
        np.testing.assert_allclose(ts[keep], js[keep], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 8, 9, 17, 70])
@pytest.mark.parametrize("pin", ["v1", "v3"])
def test_pin_plain_matches_pallas(pin, dtype, k):
    # k = 70 > n = 60: the tail pads with (NEG_INF, INT_MAX)
    arrays = _data(20 + k, empty=(2, 50))
    port, jax_fn = PINS[pin]
    js, ji = jax_fn(*_jax(dtype, *arrays), k, interpret=True)
    tm.reset_launch_counts()
    ts, ti = port(*_torch(dtype, *arrays), k)
    assert tm.PLAIN_CALLS[f"maxsim_topk_{pin}_plain"] == 1
    assert ts.shape == ti.shape == (5, k)
    _compare(pin, ts, ti, js, ji, arrays[3], exact=False)
    if k == 70:
        assert (ti.numpy()[:, 60:] == INT_MAX).all()
        assert {2, 50} <= set(ti.numpy()[0, 58:60].tolist())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pin", ["v1", "v3"])
def test_pin_plain_bitwise_on_dyadic_inputs(pin, dtype):
    arrays = _data(31, b=3, tq=5, td=13, dyadic=True, empty=(7,))
    port, jax_fn = PINS[pin]
    js, ji = jax_fn(*_jax(dtype, *arrays), 12, interpret=True)
    ts, ti = port(*_torch(dtype, *arrays), 12)
    _compare(pin, ts, ti, js, ji, arrays[3], exact=True)
    # the duplicate rows tie exactly and order by row
    row = [r for r in ti.numpy()[0] if r in (4, 9, 57)]
    assert row == sorted(row)


@pytest.mark.parametrize("d", [12, 100])
@pytest.mark.parametrize("pin", ["v1", "v3"])
def test_pin_plain_odd_widths(pin, d):
    # d % 8 != 0 (the JAX wrappers pad it to 128; v3 puts its bias lane there)
    arrays = _data(40 + d, d=d, empty=(3,))
    port, jax_fn = PINS[pin]
    js, ji = jax_fn(*_jax("f32", *arrays), 10, interpret=True)
    ts, ti = port(*_torch("f32", *arrays), 10)
    _compare(pin, ts, ti, js, ji, arrays[3], exact=False)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pin", ["v1", "v3"])
def test_pin_plain_edge_cases_match_pallas(pin, dtype):
    # d = 128 (v3's bias lane then needs a lane past the first 128; on the
    # card it is the only live lane group of the last k-box) and a query of
    # length 0 (every non-empty document scores 0 for it, so its list is the
    # rows in order; the empty ones last)
    arrays = _data(60, b=4, tq=9, n=70, td=19, d=128, empty=(5, 66), zero_q=(2,))
    port, jax_fn = PINS[pin]
    js, ji = jax_fn(*_jax(dtype, *arrays), 73, interpret=True)
    ts, ti = port(*_torch(dtype, *arrays), 73)
    _compare(pin, ts, ti, js, ji, arrays[3], exact=False)
    full = [r for r in range(70) if r not in (5, 66)]
    assert ti.numpy()[2, :68].tolist() == full and (ts.numpy()[2, :68] == 0).all()
    assert ti.numpy()[2, 68:70].tolist() == [5, 66] and (ts.numpy()[2, 68:70] == NEG_INF).all()


def _row_sums(pin, q, ql, docs, dl, own: bool):
    """[B, N] pin scores in the plain version's products and per-token
    maxima, the rows summed one by one in token order from +0, as the kernels
    sum: over all padded rows (own False: Tq for v1, Tq_pad for v3, the rows
    the TPU kernels and the plain versions sum) or over each query's own rows
    only (one row of a query of length 0, the rows the CUDA kernels compute);
    then the v1 clamp, or NEG_INF for v3's empty documents."""
    b, tq, _ = q.shape
    n, td, _ = docs.shape
    if pin == "v1":
        qa, da = tm._masked_queries(q, ql), docs
        extra = tm.v1_bias(dl, n, td, "cpu")[None, None]
    else:
        qa, da = tm.maxsim_v3_operands(q, ql, docs, dl)
        extra = 0.0
    rows = qa.shape[1]
    s = torch.matmul(qa.float().reshape(b * rows, -1), da.float().reshape(n * td, -1).T)
    per_token = torch.amax(s.view(b, rows, n, td) + extra, dim=3)
    scores = torch.zeros((b, n))
    for i in range(b):
        for t in range(max(int(ql[i]), 1) if own else rows):
            scores[i] = scores[i] + per_token[i, t]
    if pin == "v1":
        return torch.clamp(scores, min=NEG_INF)
    return scores.masked_fill(~(dl > 0)[None, :], NEG_INF)


@pytest.mark.parametrize("seed", [61, 62, 63])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pin", ["v1", "v3"])
def test_dropped_pad_rows_change_no_bit(pin, dtype, seed):
    # random floats (no exact sums), empty documents, a query of length 0
    # and queries shorter than Tq: summed in the kernels' order, each
    # query's own rows give every score bitwise as all its padded rows do
    # (each pad row adds exactly +0); and that function, ranked in
    # (-score, row) order, is the plain version's (its sum over the padded
    # rows in torch's order, so scores to RTOL / ATOL), every document listed
    arrays = _data(seed, b=6, tq=11, n=90, td=23, d=48, empty=(3, 40, 89), zero_q=(4,))
    args = _torch(dtype, *arrays)
    own = _row_sums(pin, *args, own=True)
    np.testing.assert_array_equal(own.numpy(), _row_sums(pin, *args, own=False).numpy())
    ids = np.arange(90)[None, :].repeat(6, axis=0)
    order = np.lexsort((ids, -own.numpy().astype(np.float64)), axis=1)
    ps, pi = PINS[pin][0](*args, 90)
    np.testing.assert_array_equal(pi.numpy(), order)
    np.testing.assert_allclose(ps.numpy(), np.take_along_axis(own.numpy(), order, 1),
                               rtol=RTOL, atol=ATOL)
    assert (pi.numpy()[:, -3:] == [3, 40, 89]).all()
    assert (ps.numpy()[:, -3:] == NEG_INF).all()


def test_pins_route_through_maxsim_topk():
    # method="pallas" / "pallas_v3" on CPU tensors take the plain versions,
    # as the JAX package runs the pinned kernel in interpret mode
    arrays = _data(50, empty=(4,))
    tm.reset_launch_counts()
    for method, pin in (("pallas", "v1"), ("pallas_v3", "v3")):
        js, ji = jm.maxsim_topk(*_jax("f32", *arrays), 10, method=method)
        ts, ti = tm.maxsim_topk(*_torch("f32", *arrays), 10, method=method)
        _compare(pin, ts, ti, js, ji, arrays[3], exact=False)
    assert tm.PLAIN_CALLS["maxsim_topk_v1_plain"] == tm.PLAIN_CALLS["maxsim_topk_v3_plain"] == 1
    assert sum(tm.LAUNCHES.values()) == 0


def test_v3_operands_carry_the_bias_lane():
    q, ql, docs, dl = _data(51, b=2, tq=5, n=4, td=6, d=16, empty=(1,))
    qa, da = tm.maxsim_v3_operands(*_torch("f32", q, ql, docs, dl))
    assert qa.shape == (2, 8, 24) and da.shape == (4, 6, 24)  # tq 5 -> 8, d 16 + 1 -> 24
    assert (qa[:, :, 16] == 1).all() and (qa[:, :, 17:] == 0).all()
    valid = np.arange(6)[None, :] < dl[:, None]
    np.testing.assert_array_equal(da[:, :, 16].numpy(), np.where(valid, 0.0, np.float32(-1e30)))
    np.testing.assert_array_equal(qa[:, :5, :16].numpy(), q)
    # -1e30 stays finite in bf16, where NEG_INF would not
    qb, db = tm.maxsim_v3_operands(*_torch("bf16", q, ql, docs, dl))
    assert torch.isfinite(db.float()).all() and not torch.isfinite(torch.tensor(NEG_INF).bfloat16())


def test_v3_empty_document_listed_by_jax_not_by_port():
    # The JAX v3 pin scores an empty document Tq_pad x -1e30, above the
    # search layer's s > -1e37 floor, so it lists it as a hit; the port gives
    # it NEG_INF with its row (the other routes' convention) and drops it.
    # Every other hit agrees.
    rng = np.random.default_rng(52)
    mats = [rng.normal(size=(int(rng.integers(2, 9)), 16)).astype(np.float32) for _ in range(20)]
    mats[6] = np.zeros((0, 16), np.float32)
    queries = [rng.normal(size=(int(rng.integers(2, 6)), 16)).astype(np.float32) for _ in range(3)]
    ids = [f"d{i}" for i in range(20)]
    jax_hits = JaxMultiVectorIndex(ids, mats, search_method="pallas_v3").search(queries, 20)
    port_hits = MultiVectorIndex(ids, mats, search_method="pallas_v3", device="cpu").search(
        queries, 20
    )
    for jh, th in zip(jax_hits, port_hits):
        j_ids = [h.doc_id for h in jh]
        assert "d6" in j_ids and jh[-1].doc_id == "d6" and jh[-1].score < -1e30
        assert [h.doc_id for h in th] == j_ids[:-1] and len(th) == 19
        np.testing.assert_allclose([h.score for h in th], [h.score for h in jh[:-1]],
                                   rtol=RTOL, atol=ATOL)
    # the port's v3 hits equal its other routes'
    exact = MultiVectorIndex(ids, mats, device="cpu").search(queries, 20)
    assert [[h.doc_id for h in q] for q in exact] == [[h.doc_id for h in q] for q in port_hits]


# ------------------------------------------------------------------ any k
@pytest.mark.parametrize("k", [257, 1000])
def test_dense_any_k_above_budget_matches_jax(monkeypatch, k):
    # over the 2 GiB budget "auto" takes the streaming kernel's route (its
    # plain version here); the JAX package takes dense_topk_xla off the TPU
    rng = np.random.default_rng(k)
    c = rng.normal(size=(1200, 24)).astype(np.float32)
    c[100:110] = c[3]  # exact ties
    q = rng.normal(size=(4, 24)).astype(np.float32)
    monkeypatch.setattr(jd, "FULL_MATERIALIZE_BUDGET", 64)
    monkeypatch.setattr(td, "FULL_MATERIALIZE_BUDGET", 64)
    js, ji = jd.dense_topk(jnp.asarray(q), jnp.asarray(c), k)
    ts, ti = td.dense_topk(torch.from_numpy(q), torch.from_numpy(c), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # sums of magnitude up to ~20 in another order: an ulp of 16 near 0 too
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=2e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pallas_v2_pin_at_k_257_matches_jax(dtype):
    # lists beyond the fused kernel's 256 shared-memory entries; JAX grows
    # its tile with k (interpret mode)
    arrays = _data(53, b=3, tq=4, n=300, td=6, d=16, empty=(9,))
    js, ji = jm.maxsim_topk(*_jax(dtype, *arrays), 257, method="pallas_v2")
    ts, ti = tm.maxsim_topk(*_torch(dtype, *arrays), 257, method="pallas_v2")
    listed = np.asarray(js) > NEG_INF / 2
    np.testing.assert_array_equal(ti.numpy()[listed], np.asarray(ji)[listed])
    np.testing.assert_allclose(ts.numpy()[listed], np.asarray(js)[listed], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["pallas", "pallas_v2", "pallas_v3"])
def test_fused_pins_at_k_1000_match_the_scan(method):
    arrays = _data(54, b=2, tq=4, n=1100, td=5, d=12, empty=(17, 600))
    js, ji = jm.maxsim_topk_xla(*_jax("f32", *arrays), 1000, tile_n=256)
    ts, ti = tm.maxsim_topk(*_torch("f32", *arrays), 1000, method=method)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
