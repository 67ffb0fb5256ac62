"""The port's serving modes (int8 and approx dense, int8 MaxSim) and their
indexes, held against the JAX package on the CPU.

The same seeded numpy inputs go through both packages. Tolerances: the
quantizers bitwise; int8 dense ids equal and scores bitwise (s32 products are
exact, and the f32 steps after them come in the JAX package's order; on the
flat leg's global-scale branch XLA reassociates the two scale products, so
there one ulp); int8 MaxSim ids equal and scores ``rtol = atol = 1e-5`` (its
token sums run in another order); approx and two-stage ids equal and scores
``rtol=1e-6, atol=1e-6`` (the f32 products of another BLAS).
``lax.approx_max_k`` lowers to an exact top-k off the TPU, which is what the
port selects everywhere, in ``(-score, id)`` order; the JAX approx paths
document no tie order, so against them ids are equal up to exact ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorag_research_tpu.index.dense import DenseIndex as JaxDenseIndex
from autorag_research_tpu.index.multi_vector import MultiVectorIndex as JaxMultiVectorIndex
from autorag_research_tpu.ops import dense as jd
from autorag_research_tpu.ops import maxsim as jm
from autorag_research_tpu_torch.index.dense import DenseIndex, l2_normalize
from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex
from autorag_research_tpu_torch.ops import dense as td
from autorag_research_tpu_torch.ops import maxsim as tm
from autorag_research_tpu_torch.ops.topk import NEG_INF


def _dense(seed, n=900, d=48, nq=6):
    rng = np.random.default_rng(seed)
    c = l2_normalize(rng.normal(size=(n, d)))
    for src, dst in ((3, 40), (3, 41), (10, 500)):  # exact ties
        c[dst] = c[src]
    q = l2_normalize(rng.normal(size=(nq, d)))
    q[1] = c[3]
    return c, q


def _assert_ids_up_to_ties(ti, ji, scores):
    """Ids equal, except where JAX picked another document of exactly the
    same selection score (``scores`` [Q, N], the port's) at that rank: the
    tie order the JAX approx paths leave open."""
    ti, ji = ti.numpy(), np.asarray(ji)
    rows, cols = np.nonzero(ti != ji)
    assert (scores[rows, ji[rows, cols]] == scores[rows, ti[rows, cols]]).all()


def _hits(results):
    ids = [[h.doc_id for h in hits] for hits in results]
    return ids, [[h.score for h in hits] for hits in results]


# -------------------------------------------------------------- quantizers
def test_quantize_int8_bitwise():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 33)).astype(np.float32)
    x[4] = 0.0  # a zero row: scale 0
    x[7, :3] = [127.5, -0.5, 0.5]  # halves: round to even
    jq, js = jd.quantize_int8(x)
    tq, ts = td.quantize_int8(x)
    assert isinstance(tq, np.ndarray) and tq.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    assert js[4] == 0 and (jq[4] == 0).all()
    # a tensor stays a tensor, equal to the JAX package's device path as its
    # ops run it, jitted (where XLA multiplies by f32(1/127))
    jq2, js2 = jax.jit(jd.quantize_int8)(jnp.asarray(x))
    tq2, ts2 = td.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))


def test_quantize_int8_global_bitwise():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(40, 20)).astype(np.float32)
    jq, js = jd.quantize_int8_global(x)
    tq, ts = td.quantize_int8_global(x)
    np.testing.assert_array_equal(tq, jq)
    assert ts == js and isinstance(ts, float)
    zq, zs = td.quantize_int8_global(np.zeros((3, 4), np.float32))
    assert zs == 0.0 and (zq == 0).all()


def test_quantize_int8_tokens_bitwise():
    rng = np.random.default_rng(3)
    docs = rng.normal(size=(7, 5, 12)).astype(np.float32)
    docs[2, 3:] = 0.0  # pad tokens: scale 0
    jq, js = jm.quantize_int8_tokens(docs)
    tq, ts = tm.quantize_int8_tokens(docs)
    assert tq.shape == (7, 5, 12) and ts.shape == (7, 5)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    jq2, js2 = jax.jit(jm.quantize_int8_tokens)(jnp.asarray(docs))
    tq2, ts2 = tm.quantize_int8_tokens(torch.from_numpy(docs))
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))


def test_int8_matmul_exact():
    rng = np.random.default_rng(4)
    for m, kd, n in ((1, 5, 3), (20, 16, 9), (3, 12, 300)):
        a = rng.integers(-127, 128, size=(m, kd)).astype(np.int8)
        b = rng.integers(-127, 128, size=(n, kd)).astype(np.int8)
        got = td.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32 and got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


# ------------------------------------------------------------ int8 dense
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("scale_kind", ["row", "global"])
@pytest.mark.parametrize("leg", ["flat", "scan"])
def test_dense_topk_int8_matches_jax(monkeypatch, leg, scale_kind, exact):
    c, q = _dense(5)
    if scale_kind == "row":
        cq, cs = jd.quantize_int8(c)
        j_scale, t_scale = jnp.asarray(cs), torch.from_numpy(cs)
    else:
        cq, cs = jd.quantize_int8_global(c)
        j_scale = t_scale = cs
    if leg == "scan":  # over the budget: corpus tiles of 256 rows, a ragged tail
        monkeypatch.setattr(jd, "FULL_MATERIALIZE_BUDGET", 64)
        monkeypatch.setattr(td, "FULL_MATERIALIZE_BUDGET", 64)
    q_q, _ = td.quantize_int8(torch.from_numpy(q))
    sel = td.int8_matmul(q_q, torch.from_numpy(cq)).float().numpy()  # selection scores
    if scale_kind == "row":
        sel = sel * cs[None, :]
    for k in (1, 10, 37, 1000):  # k > n pads
        js, ji = jd.dense_topk_int8(jnp.asarray(q), jnp.asarray(cq), j_scale, k,
                                    exact=exact, tile_n=256)
        ts, ti = td.dense_topk_int8(torch.from_numpy(q), torch.from_numpy(cq), t_scale, k,
                                    tile_n=256)
        if exact:
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        else:  # lax.approx_max_k: exact off the TPU, ties in any order
            _assert_ids_up_to_ties(ti, ji, sel)
        if leg == "flat" and scale_kind == "global":
            # jitted, XLA computes absmax * (cs * f32(1/127)) where the port
            # computes (absmax * f32(1/127)) * cs: one ulp apart at most
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.4e-7, atol=0)
        else:
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_dense_topk_int8_legs_agree_and_track_f32():
    # the scan leg gives the flat leg's ids and scores; int8 keeps the
    # documented approximate contract against f32 exact (98% top-10)
    c, q = _dense(6, n=3000, d=64, nq=40)
    cq, cs = td.quantize_int8(c)
    args = (torch.from_numpy(q), torch.from_numpy(cq), torch.from_numpy(cs), 10)
    flat = td._dense_topk_int8_flat(*args)
    scan = td._dense_topk_int8_scan(*args, tile_n=512)
    np.testing.assert_array_equal(flat[1].numpy(), scan[1].numpy())
    np.testing.assert_array_equal(flat[0].numpy(), scan[0].numpy())
    _, exact_i = td.dense_topk_full(torch.from_numpy(q), torch.from_numpy(c), 10)
    agree = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(flat[1].numpy(), exact_i.numpy())])
    assert agree >= 0.98


@pytest.mark.parametrize("k", [10, 3001, 3010])
@pytest.mark.parametrize("scale_kind", ["row", "global"])
@pytest.mark.parametrize("leg", ["flat", "scan"])
def test_dense_topk_int8_masks_stored_pad_rows(monkeypatch, leg, scale_kind, k):
    # an index stores its int8 corpus with zero rows up to int8_rows on the
    # card, so that int8_matmul takes it in place: those rows never win, not
    # even against the negative inner products a k = N search lists
    c, q = _dense(15, n=3001, d=64, nq=9)
    cq, cs = td.quantize_int8(c) if scale_kind == "row" else td.quantize_int8_global(c)
    rows = td.int8_rows(3001, torch.device("cuda"))
    assert rows == 3008
    cq_pad = np.zeros((rows, 64), np.int8)
    cq_pad[:3001] = cq
    cs_pad = cs if scale_kind == "global" else np.concatenate([cs, np.zeros(7, np.float32)])
    if leg == "scan":
        monkeypatch.setattr(td, "FULL_MATERIALIZE_BUDGET", 0)
    tq_ = torch.from_numpy(q)
    ref_s, ref_i = td.dense_topk_int8(tq_, torch.from_numpy(cq), torch.as_tensor(cs), k, 512)
    got_s, got_i = td.dense_topk_int8(tq_, torch.from_numpy(cq_pad), torch.as_tensor(cs_pad), k,
                                      512, n_valid=3001)
    np.testing.assert_array_equal(got_i.numpy(), ref_i.numpy())
    np.testing.assert_array_equal(got_s.numpy(), ref_s.numpy())
    assert (ref_i.numpy()[:, :3001] < 3001).all()
    if k >= 3001:  # the listed rows reach below the pad rows' zero products
        assert (ref_s.numpy()[:, :3001] < 0).any()


# --------------------------------------------------- approx and two-stage
@pytest.mark.parametrize("k", [1, 10, 130, 1000])
def test_two_stage_and_approx_match_jax(k):
    c, q = _dense(7, n=5000)
    jq, jc = jnp.asarray(q), jnp.asarray(c)
    tq_, tc = torch.from_numpy(q), torch.from_numpy(c)
    full = (tq_ @ tc.T).numpy()
    for jax_fn, port_fn in ((jd.dense_topk_xla_two_stage, td.dense_topk_two_stage),
                            (jd.dense_topk_approx, td.dense_topk_approx)):
        js, ji = jax_fn(jq, jc, k)
        ts, ti = port_fn(tq_, tc, k)
        if jax_fn is jd.dense_topk_approx:  # approx_max_k: ties in any order
            _assert_ids_up_to_ties(ti, ji, full)
        else:
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    # both equal the exact selection, ties by id included
    _, full_i = td.dense_topk_full(tq_, tc, k)
    for method in ("two_stage", "approx"):
        np.testing.assert_array_equal(td.dense_topk(tq_, tc, k, method=method)[1].numpy(),
                                      full_i.numpy())


def test_two_stage_segments_smaller_than_k():
    # tile grows to round_up(k, 128): segments always hold k survivors
    c, q = _dense(8, n=700)
    js, ji = jd.dense_topk_xla_two_stage(jnp.asarray(q), jnp.asarray(c), 300, tile=128)
    ts, ti = td.dense_topk_two_stage(torch.from_numpy(q), torch.from_numpy(c), 300, tile=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ------------------------------------------------------------ int8 MaxSim
def _mv(seed, b=5, tq=6, n=70, td=9, d=20, empty=(3, 44)):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, d)).astype(np.float32)
    ql = rng.integers(1, tq + 1, size=b).astype(np.int32)
    q *= (np.arange(tq)[None, :] < ql[:, None])[:, :, None]
    docs = rng.normal(size=(n, td, d)).astype(np.float32)
    dl = rng.integers(1, td + 1, size=n).astype(np.int32)
    dl[list(empty)] = 0
    docs *= (np.arange(td)[None, :] < dl[:, None])[:, :, None]
    return q, ql, docs, dl


@pytest.mark.parametrize("tile_n", [None, 8, 16])
@pytest.mark.parametrize("k", [1, 10, 17, 80])
def test_maxsim_topk_int8_matches_jax(k, tile_n):
    q, ql, docs, dl = _mv(9)
    dq, ds = jm.quantize_int8_tokens(docs)
    js, ji = jm.maxsim_topk_int8(jnp.asarray(q), jnp.asarray(ql), jnp.asarray(dq),
                                 jnp.asarray(ds), jnp.asarray(dl), k, tile_n=tile_n)
    ts, ti = tm.maxsim_topk_int8(torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(dq),
                                 torch.from_numpy(ds), torch.from_numpy(dl), k, tile_n=tile_n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    # empty documents at NEG_INF with their rows, in both packages
    if k == 80:
        assert {3, 44} <= set(ti.numpy()[0, 68:70].tolist())
        assert (ts.numpy()[:, 68:] == np.float32(NEG_INF)).all()


@pytest.mark.parametrize("k", [10, 80])
def test_maxsim_topk_int8_masks_stored_pad_tokens(k):
    # MultiVectorIndex(mode="int8") stores Td = 9 as 16 tokens on the card
    # (int8_rows): zero tokens of scale 0 past every length change nothing
    q, ql, docs, dl = _mv(16)
    dq, ds = tm.quantize_int8_tokens(docs)
    td16 = td.int8_rows(9, torch.device("cuda"))
    dq_pad = np.zeros((70, td16, 20), np.int8)
    dq_pad[:, :9] = dq
    ds_pad = np.zeros((70, td16), np.float32)
    ds_pad[:, :9] = ds
    args = (torch.from_numpy(q), torch.from_numpy(ql))
    ref = tm.maxsim_topk_int8(*args, torch.from_numpy(dq), torch.from_numpy(ds),
                              torch.from_numpy(dl), k)
    got = tm.maxsim_topk_int8(*args, torch.from_numpy(dq_pad), torch.from_numpy(ds_pad),
                              torch.from_numpy(dl), k)
    np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())


def test_maxsim_topk_int8_tracks_f32():
    # approximate against the f32 scan: top-5 agreement >= 0.8, the JAX
    # package's own bound (tests/test_maxsim_int8.py)
    rng = np.random.default_rng(10)
    q = rng.normal(size=(16, 8, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=2, keepdims=True)
    docs = rng.normal(size=(400, 12, 32)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=2, keepdims=True)
    ql = np.full(16, 8, np.int32)
    dl = np.full(400, 12, np.int32)
    dq, ds = tm.quantize_int8_tokens(docs)
    _, ti = tm.maxsim_topk_int8(torch.from_numpy(q), torch.from_numpy(ql), torch.from_numpy(dq),
                                torch.from_numpy(ds), torch.from_numpy(dl), 5)
    _, ei = tm.maxsim_topk_scan(torch.from_numpy(q), torch.from_numpy(ql),
                                torch.from_numpy(docs), torch.from_numpy(dl), 5)
    agree = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(ti.numpy(), ei.numpy())])
    assert agree >= 0.8


# ------------------------------------------------------------------ indexes
@pytest.mark.parametrize("mode", ["approx", "int8"])
def test_dense_index_serving_modes_match_jax(tmp_path, mode):
    c, q = _dense(11, n=1500, d=40, nq=12)
    ids = [f"doc{i}" for i in range(1500)]
    port = DenseIndex(ids, c * 3.0, mode=mode, device="cpu")  # cosine normalizes
    jax_idx = JaxDenseIndex(ids, c * 3.0, mode=mode)
    t_ids, t_s = _hits(port.search(q, 10))
    j_ids, j_s = _hits(jax_idx.search(q, 10))
    assert t_ids == j_ids
    if mode == "int8":
        np.testing.assert_array_equal(t_s, j_s)
        assert port.device_bytes() == 1500 * 40 + 1500 * 4  # 1 byte / dim + a scale per row
    else:
        np.testing.assert_allclose(t_s, j_s, rtol=1e-6, atol=1e-6)
        assert port.device_bytes() == 1500 * 40 * 4
    # artifacts cross the packages both ways and keep the mode
    port.save(tmp_path / "port")
    back = JaxDenseIndex.load(tmp_path / "port")
    assert back.mode == mode and _hits(back.search(q, 10))[0] == j_ids
    jax_idx.save(tmp_path / "jax")
    again = DenseIndex.load(tmp_path / "jax", device="cpu")
    assert again.mode == mode and _hits(again.search(q, 10))[0] == j_ids


def test_dense_index_device_bytes_by_mode():
    c, _ = _dense(12, n=600, d=24)
    ids = list(range(600))
    assert DenseIndex(ids, c, device="cpu").device_bytes() == 0  # nothing uploaded yet
    exact = DenseIndex(ids, c, device="cpu").to_device()
    int8 = DenseIndex(ids, c, mode="int8", device="cpu").to_device()
    verified = DenseIndex(ids, c, mode="verified", device="cpu").to_device()
    assert exact.device_bytes() == 600 * 24 * 4
    assert int8.device_bytes() == 600 * 24 + 600 * 4
    assert verified.device_bytes() == verified.verified_device_bytes()


def _mv_corpus(seed, n=90, d=24, nq=7):
    rng = np.random.default_rng(seed)
    mats = [rng.normal(size=(int(rng.integers(1, 14)), d)).astype(np.float32) for _ in range(n)]
    mats[5] = np.zeros((0, d), np.float32)
    queries = [rng.normal(size=(int(rng.integers(2, 7)), d)).astype(np.float32) for _ in range(nq)]
    return [f"p{i}" for i in range(n)], mats, queries


@pytest.mark.parametrize("bucketize", [1, 3])
def test_multi_vector_int8_matches_jax(tmp_path, bucketize):
    ids, mats, queries = _mv_corpus(13)
    port = MultiVectorIndex(ids, mats, mode="int8", bucketize=bucketize, device="cpu")
    jax_idx = JaxMultiVectorIndex(ids, mats, mode="int8", bucketize=bucketize)
    t_ids, t_s = _hits(port.search(queries, 12))
    j_ids, j_s = _hits(jax_idx.search(queries, 12))
    assert t_ids == j_ids
    for a, b in zip(t_s, j_s):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert port.device_bytes() == jax_idx.device_bytes() > 0
    if bucketize == 1:  # 1 byte per dim plus a 4-byte scale per token
        n, tmax, d = port._docs.shape
        assert port.device_bytes() == n * tmax * d + n * tmax * 4
    with pytest.raises(ValueError, match="int8"):
        port.search(queries, 5, prefilter=2)
    port.save(tmp_path / "port")
    back = JaxMultiVectorIndex.load(tmp_path / "port")
    assert back.mode == "int8" and _hits(back.search(queries, 12))[0] == j_ids
    jax_idx.save(tmp_path / "jax")
    again = MultiVectorIndex.load(tmp_path / "jax", device="cpu")
    assert (again.mode, again.bucketize) == ("int8", bucketize)
    assert _hits(again.search(queries, 12))[0] == j_ids


@pytest.mark.parametrize("method", ["pallas", "pallas_v3"])
@pytest.mark.parametrize("bucketize", [1, 3])
def test_multi_vector_pins_match_jax(tmp_path, method, bucketize):
    # search_method pins a kernel per bucket too, and save / load keep it
    ids, mats, queries = _mv_corpus(14)
    port = MultiVectorIndex(ids, mats, search_method=method, bucketize=bucketize, device="cpu")
    jax_idx = JaxMultiVectorIndex(ids, mats, search_method=method, bucketize=bucketize)
    tm.reset_launch_counts()
    t_ids, t_s = _hits(port.search(queries, 10))
    pin = "v1" if method == "pallas" else "v3"
    assert tm.PLAIN_CALLS[f"maxsim_topk_{pin}_plain"] == (1 if bucketize == 1 else 3)
    j_ids, j_s = _hits(jax_idx.search(queries, 10))
    assert t_ids == j_ids
    for a, b in zip(t_s, j_s):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    port.save(tmp_path / "port")
    assert JaxMultiVectorIndex.load(tmp_path / "port").search_method == method
    again = MultiVectorIndex.load(tmp_path / "port", device="cpu")
    assert again.search_method == method and _hits(again.search(queries, 10))[0] == j_ids


# -------------------------------------------------------------------- slice
def _catalog_run(pkg, tmp_path, pipelines):
    """One catalog per package from one seed (120 chunks with single- and
    multi-vector embeddings, 10 queries with one gold chunk each); run each
    ``(name, search_mode, index_options)`` pipeline at top_k = 8 -> {name:
    (rows, metrics)}."""
    import importlib

    Catalog = importlib.import_module(f"{pkg}.store.catalog").Catalog
    gt_mod = importlib.import_module(f"{pkg}.store.gt")
    metrics = importlib.import_module(f"{pkg}.evaluation.metrics.retrieval")
    MetricInput = importlib.import_module(f"{pkg}.schema").MetricInput
    vs = importlib.import_module(f"{pkg}.pipelines.retrieval.vector_search")
    registry = importlib.import_module(f"{pkg}.index.registry")
    pipe_kw = {"device": "cpu"} if pkg.endswith("_torch") else {}
    rng = np.random.default_rng(15)
    dim, n_chunks, n_queries = 24, 120, 10
    chunk_emb = rng.normal(size=(n_chunks, dim)).astype(np.float32)
    chunk_mv = [rng.normal(size=(int(rng.integers(3, 12)), dim)).astype(np.float32)
                for _ in range(n_chunks)]
    gold = rng.choice(n_chunks, size=n_queries, replace=False)
    query_emb = chunk_emb[gold] + 0.5 * rng.normal(size=(n_queries, dim)).astype(np.float32)
    query_mv = [m[:4] + 0.5 * rng.normal(size=m[:4].shape).astype(np.float32) for m in
                (chunk_mv[g] for g in gold)]
    (tmp_path / pkg).mkdir()
    cat = Catalog(tmp_path / pkg / "ws.db", embedding_dim=dim)
    cat.add_chunks({"id": i, "contents": f"c{i}", "embedding": e} for i, e in enumerate(chunk_emb))
    cat.set_multi_embeddings("chunk", enumerate(chunk_mv))
    cat.add_queries({"id": j, "contents": f"q{j}", "embedding": e} for j, e in enumerate(query_emb))
    cat.set_multi_embeddings("query", enumerate(query_mv))
    for j, g in enumerate(gold):
        cat.add_retrieval_gt(j, gt_mod.or_all([int(g)]))
    out = {}
    try:
        for name, mode, opts in pipelines:
            pipe = vs.VectorSearchPipeline(cat, name=name, search_mode=mode, index_options=opts,
                                           **pipe_kw)
            assert pipe.run(top_k=8)["total_results"] == n_queries * 8
            rows, inputs = [], []
            for j in range(n_queries):
                got = cat.get_retrieved(j, pipe.pipeline_id)
                rows += [(j, r["doc_id"], r["rel_score"]) for r in got]
                gt, _ = gt_mod.build_retrieval_gt_from_relations(
                    [dict(r) for r in cat.get_relations_by_query(j)]
                )
                inputs.append(MetricInput(retrieval_gt=gt,
                                          retrieved_ids=[f"chunk_{r['doc_id']}" for r in got]))
            out[name] = rows, (metrics.retrieval_recall(inputs), metrics.retrieval_ndcg(inputs))
        return out
    finally:
        registry.invalidate(cat)
        cat.close()


def test_pins_and_serving_modes_slice_matches_jax(tmp_path):
    # VectorSearchPipeline multi mode with each MaxSim pin and int8, single
    # mode with int8 and approx: the persisted rows and the metrics of each
    # pipeline equal the JAX package's on the same catalog
    pipelines = [
        ("mv_v1", "multi", {"search_method": "pallas"}),
        ("mv_v3", "multi", {"search_method": "pallas_v3"}),
        ("mv_int8", "multi", {"mode": "int8"}),
        ("dense_int8", "single", {"mode": "int8"}),
        ("dense_approx", "single", {"mode": "approx"}),
    ]
    jax_out = _catalog_run("autorag_research_tpu", tmp_path, pipelines)
    port_out = _catalog_run("autorag_research_tpu_torch", tmp_path, pipelines)
    for name, _, _ in pipelines:
        (j_rows, j_metrics), (t_rows, t_metrics) = jax_out[name], port_out[name]
        assert [r[:2] for r in t_rows] == [r[:2] for r in j_rows], name
        np.testing.assert_allclose([r[2] for r in t_rows], [r[2] for r in j_rows],
                                   rtol=1e-5, atol=1e-6)
        assert t_metrics == j_metrics, name
    assert 0.0 < np.mean(port_out["mv_v1"][1][0]) <= 1.0
