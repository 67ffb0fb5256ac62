"""Port ``ops/maxsim.py`` vs the JAX package's ``ops/maxsim.py``.

The same seeded numpy inputs go through both packages. The JAX side runs its
Pallas kernels as its own tests do on the CPU (``interpret=True``); the port
runs on CPU tensors, where each kernel wrapper takes its plain version.

Tolerances: bitwise where every product and sum is exact in f32 (token values
that are small multiples of 1/8); on random inputs ids equal and scores
``rtol=1e-5, atol=1e-5`` (f32 sums in another order). Empty documents: the
port scores them NEG_INF with their row on every route, which is what
``maxsim_topk_xla`` gives; the JAX Pallas kernels let their sum overflow to
``-inf`` (scores kernel) and drop them from the fused top-k, so against those
two the tests compare the non-empty entries. The CUDA kernels themselves are
held against these plain versions in ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorag_research_tpu.ops import maxsim as jm
from autorag_research_tpu_torch.ops import maxsim as tm
from autorag_research_tpu_torch.ops.topk import INT_MAX, NEG_INF

RTOL = ATOL = 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _data(seed, b=5, tq=7, n=60, td=21, d=40, empty=(), dyadic=False):
    """Padded queries [b, tq, d] + lens and docs [n, td, d] + lens; pads are
    zero, ``empty`` rows have length 0. Dyadic data also has two rows that
    duplicate a third: exact ties, which random floats would split by sum
    order (a CPU GEMM rounds a row differently at another tile position)."""
    rng = np.random.default_rng(seed)

    def vals(shape):
        if dyadic:
            return (rng.integers(-8, 9, size=shape) / 8.0).astype(np.float32)
        return rng.normal(size=shape).astype(np.float32)

    q = vals((b, tq, d))
    ql = rng.integers(1, tq + 1, size=b).astype(np.int32)
    ql[0] = tq
    q *= (np.arange(tq)[None, :] < ql[:, None])[:, :, None]
    docs = vals((n, td, d))
    dl = rng.integers(1, td + 1, size=n).astype(np.int32)
    if dyadic:
        docs[[9, n - 3]] = docs[4]
        dl[[9, n - 3]] = dl[4]
    dl[list(empty)] = 0
    docs *= (np.arange(td)[None, :] < dl[:, None])[:, :, None]
    return q, ql, docs, dl


def _jax(dtype, *arrays):
    q, ql, docs, dl = arrays
    jdt = DTYPES[dtype][1]
    return jnp.asarray(q, jdt), jnp.asarray(ql), jnp.asarray(docs, jdt), jnp.asarray(dl)


def _torch(dtype, *arrays):
    q, ql, docs, dl = arrays
    tdt = DTYPES[dtype][0]
    return (torch.from_numpy(q).to(tdt), torch.from_numpy(ql),
            torch.from_numpy(docs).to(tdt), torch.from_numpy(dl))


def _assert_topk(ts, ti, js, ji, exact=False):
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if exact:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    else:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ scan
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 10, 16, 17, 70])
def test_scan_matches_xla(dtype, k):
    arrays = _data(1, empty=(2, 50))
    js, ji = jm.maxsim_topk_xla(*_jax(dtype, *arrays), k, tile_n=8)
    ts, ti = tm.maxsim_topk_scan(*_torch(dtype, *arrays), k, tile_n=8)
    _assert_topk(ts, ti, js, ji)
    if k == 70:  # k > n pads, empty docs keep their rows at NEG_INF
        assert (ti.numpy()[:, 60:] == INT_MAX).all()
        assert {2, 50} <= set(ti.numpy()[0, 58:60].tolist())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_scan_bitwise_on_dyadic_inputs(dtype):
    arrays = _data(2, empty=(7,), dyadic=True)
    js, ji = jm.maxsim_topk_xla(*_jax(dtype, *arrays), 12, tile_n=16)
    ts, ti = tm.maxsim_topk_scan(*_torch(dtype, *arrays), 12)
    _assert_topk(ts, ti, js, ji, exact=True)
    # the duplicate rows tie exactly and order by row
    row = [r for r in ti.numpy()[0] if r in (4, 9, 57)]
    assert row == sorted(row)


# ------------------------------------------------------ fused kernel plain
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mm_docs", [1, 2, 4])
def test_v2_plain_matches_pallas_v2(dtype, mm_docs):
    arrays = _data(3)
    js, ji = jm.maxsim_topk_pallas_v2(
        *_jax(dtype, *arrays), 10, block_q=8, block_n=8, mm_docs=mm_docs, interpret=True
    )
    ts, ti = tm.maxsim_topk_v2(*_torch(dtype, *arrays), 10)
    _assert_topk(ts, ti, js, ji)


@pytest.mark.parametrize("k", [16, 17])
def test_v2_plain_bitwise_on_dyadic_inputs(k):
    arrays = _data(4, b=3, tq=5, td=13, dyadic=True)
    js, ji = jm.maxsim_topk_pallas_v2(*_jax("f32", *arrays), k, block_n=16, interpret=True)
    ts, ti = tm.maxsim_topk_v2(*_torch("f32", *arrays), k)
    _assert_topk(ts, ti, js, ji, exact=True)


def test_v2_plain_empty_docs_and_k_beyond_n():
    # the port matches maxsim_topk_xla in full and the Pallas kernel on every
    # entry the Pallas kernel lists (it leaves empty docs out)
    arrays = _data(5, n=20, empty=(0, 11))
    ts, ti = tm.maxsim_topk_v2(*_torch("f32", *arrays), 24)
    xs, xi = jm.maxsim_topk_xla(*_jax("f32", *arrays), 24, tile_n=8)
    _assert_topk(ts, ti, xs, xi)
    ps, pi = jm.maxsim_topk_pallas_v2(*_jax("f32", *arrays), 24, block_n=8, interpret=True)
    listed = np.asarray(ps) > NEG_INF / 2
    assert listed.sum(axis=1).tolist() == [18] * 5
    np.testing.assert_array_equal(ti.numpy()[listed], np.asarray(pi)[listed])
    assert (ti.numpy()[:, 18:20] == [0, 11]).all() and (ti.numpy()[:, 20:] == INT_MAX).all()


def _tile_edge_data(seed):
    """Dyadic queries of very unequal lengths (1 to 70 tokens: a query over
    two 32-row spans, one of a single row) and documents whose lengths sit
    on each token-tile edge of 32 and 64 (31, 32, 33, 63, 64, 65) among
    ragged ones, the inputs the tile body's packing and chunked walk meet."""
    q, ql, docs, dl = _data(seed, b=6, tq=70, n=40, td=70, d=24, dyadic=True)
    ql[:] = [1, 70, 3, 33, 17, 2]
    q *= (np.arange(70)[None, :] < ql[:, None])[:, :, None]
    dl[10:16] = [31, 32, 33, 63, 64, 65]
    dl[16] = 70
    docs *= (np.arange(70)[None, :] < dl[:, None])[:, :, None]
    return q, ql, docs, dl


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_v2_plain_versions_bitwise_on_unequal_queries_and_tile_edges(dtype):
    arrays = _tile_edge_data(9)
    js, ji = jm.maxsim_topk_pallas_v2(*_jax(dtype, *arrays), 10, block_n=8, interpret=True)
    ts, ti = tm.maxsim_topk_v2_plain(*_torch(dtype, *arrays), 10)
    _assert_topk(ts, ti, js, ji, exact=True)
    jsc = jm.maxsim_scores_pallas_v2(*_jax(dtype, *arrays), block_n=8, interpret=True)
    tsc = tm.maxsim_scores_v2_plain(*_torch(dtype, *arrays))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


# ----------------------------------------------------- scores kernel plain
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_scores_plain_matches_pallas_scores(dtype):
    arrays = _data(6, empty=(8,))
    js = np.asarray(jm.maxsim_scores_pallas_v2(*_jax(dtype, *arrays), block_n=8, interpret=True))
    ts = tm.maxsim_scores_v2(*_torch(dtype, *arrays)).numpy()
    assert ts.shape == js.shape == (5, 60)
    live = np.arange(60) != 8
    np.testing.assert_allclose(ts[:, live], js[:, live], rtol=RTOL, atol=ATOL)
    assert (js[:, 8] == -np.inf).all() and (ts[:, 8] == np.float32(NEG_INF)).all()


def test_scores_plain_bitwise_on_dyadic_inputs():
    arrays = _data(7, b=2, tq=3, n=64, td=24, d=64, dyadic=True)
    js = jm.maxsim_scores_pallas_v2(*_jax("bf16", *arrays), block_n=16, interpret=True)
    np.testing.assert_array_equal(tm.maxsim_scores_v2(*_torch("bf16", *arrays)).numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [5, 17, 65])
def test_via_scores_matches_jax(dtype, k):
    # k'+1 = 65 is the verified prescreen's request (k' = 64), beyond n here
    arrays = _data(8)
    js, ji = jm.maxsim_topk_via_scores(*_jax(dtype, *arrays), k, block_n=8, interpret=True)
    ts, ti = tm.maxsim_topk_via_scores(*_torch(dtype, *arrays), k, chunk_b=2)
    _assert_topk(ts, ti, js, ji)


# --------------------------------------------------------------- rerank
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rerank_matches_jax(dtype):
    arrays = _data(9, empty=(6,))
    rng = np.random.default_rng(9)
    cand = rng.integers(0, 60, size=(5, 12)).astype(np.int32)
    cand[:, 0] = 6  # an empty doc
    cand[1, 3:5] = INT_MAX  # pad candidates
    cand[2, 7] = 60  # a row past the corpus
    js, ji = jm.maxsim_rerank(*_jax(dtype, *arrays), jnp.asarray(cand), 7)
    ts, ti = tm.maxsim_rerank(*_torch(dtype, *arrays), torch.from_numpy(cand), 7)
    _assert_topk(ts, ti, js, ji)
    js, ji = jm.maxsim_rerank(*_jax(dtype, *arrays), jnp.asarray(cand), 15)  # k > C pads
    ts, ti = tm.maxsim_rerank(*_torch(dtype, *arrays), torch.from_numpy(cand), 15)
    _assert_topk(ts, ti, js, ji)


# ------------------------------------------------------------- dispatch
def test_route_rule():
    cuda = "cuda"
    assert tm.maxsim_route("auto", 128, 50_000, 16, cuda)[0] == "fused"
    assert tm.maxsim_route("auto", 128, 50_000, 10, cuda)[0] == "fused"
    assert tm.maxsim_route("auto", 128, 50_000, 17, cuda)[0] == "scores"
    assert tm.maxsim_route("auto", 128, 50_000, 65, cuda)[0] == "scores"
    assert tm.maxsim_route("auto", 8, 12, 100, cuda)[0] == "fused"  # min(k, n) = 12 -> 16
    for k in (1, 16, 17, 65):
        assert tm.maxsim_route("auto", 128, 50_000, k, "cpu")[0] == "scan"
    assert tm.maxsim_route("xla", 128, 50_000, 10, cuda)[0] == "scan"
    assert tm.maxsim_route("pallas_v2", 128, 50_000, 100, cuda)[0] == "fused"
    # query chunks of a [Bc, N] f32 block within 256 MiB
    n = 1_000_000
    route, chunk = tm.maxsim_route("auto", 1024, n, 65, cuda)
    assert route == "scores" and chunk == 67 and chunk * n * 4 <= 256 << 20 < (chunk + 1) * n * 4
    assert tm.maxsim_route("auto", 128, 50_000, 65, cuda)[1] == 128
    # the v1 and v3 pins, on the card and off it (where their wrappers take
    # the plain versions, as JAX runs the pinned kernel in interpret mode)
    for device_type in (cuda, "cpu"):
        assert tm.maxsim_route("pallas", 8, 100, 10, device_type)[0] == "v1"
        assert tm.maxsim_route("pallas_v3", 8, 100, 300, device_type)[0] == "v3"
    with pytest.raises(ValueError):
        tm.maxsim_route("fast", 8, 100, 10, cuda)


def test_dispatch_on_cpu_takes_plain_versions():
    arrays = _data(10)
    ref_s, ref_i = jm.maxsim_topk_xla(*_jax("f32", *arrays), 17, tile_n=8)
    tm.reset_launch_counts()
    for method in ("auto", "xla", "pallas_v2"):
        ts, ti = tm.maxsim_topk(*_torch("f32", *arrays), 17, method=method)
        _assert_topk(ts, ti, ref_s, ref_i)
    ts, ti = tm.maxsim_topk_via_scores(*_torch("f32", *arrays), 17)
    _assert_topk(ts, ti, ref_s, ref_i)
    assert tm.LAUNCHES == {
        "maxsim_topk_v2": 0, "maxsim_scores_v2": 0, "maxsim_topk_v1": 0, "maxsim_topk_v3": 0,
    }
    assert tm.PLAIN_CALLS == {
        "maxsim_topk_scan": 2, "maxsim_topk_v2_plain": 1, "maxsim_scores_v2_plain": 1,
        "maxsim_topk_v1_plain": 0, "maxsim_topk_v3_plain": 0,
    }
    # any k through the pallas_v2 pin: k = 300 beyond the kernel's 256
    # shared-memory entries, the JAX package's ids
    big = (*arrays[:2], *_data(11, n=300)[2:])
    js, ji = jm.maxsim_topk_xla(*_jax("f32", *big), 300, tile_n=64)
    ts, ti = tm.maxsim_topk(*_torch("f32", *big), 300, method="pallas_v2")
    _assert_topk(ts, ti, js, ji)


# ------------------------------------------------------------- verified
def test_sidecar_bitwise():
    _, _, docs, dl = _data(12, n=64, td=24, d=64)
    j = jm.build_maxsim_sidecar(docs, dl)
    t = tm.build_maxsim_sidecar(docs, dl)
    assert (t["nd_max"], t["r_max"]) == (j["nd_max"], j["r_max"])
    np.testing.assert_array_equal(
        t["docs_lo"].float().numpy(), np.asarray(j["docs_lo"]).astype(np.float32)
    )
    t2 = tm.build_maxsim_sidecar(torch.from_numpy(docs), torch.from_numpy(dl))
    assert (t2["nd_max"], t2["r_max"]) == (j["nd_max"], j["r_max"])


def test_prescreen_eps_matches_jax():
    q, ql, docs, dl = _data(13)
    side = jm.build_maxsim_sidecar(docs, dl)
    qj = jnp.asarray(q)
    mask = jnp.arange(q.shape[1])[None, :] < jnp.asarray(ql)[:, None]
    je = jm._maxsim_prescreen_eps(
        qj, qj.astype(jnp.bfloat16).astype(jnp.float32), mask,
        jnp.float32(side["nd_max"]), jnp.float32(side["r_max"]),
    )
    qt = torch.from_numpy(q)
    te = tm._maxsim_prescreen_eps(
        qt, qt.to(torch.bfloat16).float(), torch.from_numpy(np.array(mask)),
        side["nd_max"], side["r_max"],
    )
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6, atol=0)


def _unit_tokens(arrays):
    q, ql, docs, dl = arrays
    for x in (q, docs):
        x /= np.maximum(np.linalg.norm(x, axis=2, keepdims=True), 1e-9)
    return q, ql, docs, dl


@pytest.mark.parametrize("qdtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "k,kprime,second_chance",
    [(5, 64, 0), (3, 3, 0), (3, 3, 2), (10, 4, 0)],
    ids=["covered", "batch-fallback", "second-chance", "kprime-below-k"],
)
def test_verified_matches_jax(qdtype, k, kprime, second_chance):
    q, ql, docs, dl = _unit_tokens(_data(14, empty=(21,)))
    if qdtype == "bf16":  # queries given in bf16; the proof runs on their f32 values
        q = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    side = jm.build_maxsim_sidecar(docs, dl)
    js, ji, jf, jc = jm.maxsim_topk_verified(
        jnp.asarray(q), jnp.asarray(ql), jnp.asarray(docs), jnp.asarray(dl), side, k,
        kprime=kprime, second_chance=second_chance, return_stats=True,
    )
    tside = tm.build_maxsim_sidecar(docs, dl)
    tq = torch.from_numpy(q).to(DTYPES[qdtype][0])
    ts, ti, tf, tc = tm.maxsim_topk_verified(
        tq, torch.from_numpy(ql), torch.from_numpy(docs), torch.from_numpy(dl), tside, k,
        kprime=kprime, second_chance=second_chance, return_stats=True,
    )
    _assert_topk(ts, ti, js, ji)
    assert (tf, tc) == (int(jf), bool(jc))
    if kprime == 3:
        assert tf > 0  # random data: the small candidate list fails the proof
    # and the result is the exact scan's
    xs, xi = jm.maxsim_topk_xla(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(docs), jnp.asarray(dl), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
