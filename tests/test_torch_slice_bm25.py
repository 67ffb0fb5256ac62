"""The port's whole BM25 slice vs the JAX package's.

Two catalogs built from one seed (300 chunks, 24 queries with one gold chunk
each, a query with no known term); each package runs ``BM25Pipeline`` with
its default options and scores recall / ndcg. The persisted (query, doc,
score) rows agree (scores ``rtol=1e-6``: XLA on the CPU may round a
multiply-add differently from the port's t-ordered sum; an id may swap only
between two scores within that tolerance) and the metrics are equal; so do
the ad-hoc text paths. A second run resumes: it skips every query that
persisted rows.
"""

import importlib

import numpy as np
import pytest

RTOL = 1e-6


def _corpus(seed=0, n_chunks=300, n_queries=24):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(500)]
    chunks = [" ".join(rng.choice(vocab, size=int(rng.integers(5, 40)))) for _ in range(n_chunks)]
    gold = rng.choice(n_chunks, size=n_queries, replace=False)
    queries = [" ".join(rng.choice(chunks[g].split(), size=4)) for g in gold]
    queries[5] = "zebra xylophone"
    return chunks, queries, gold


def _skewed_corpus(seed=1, n_chunks=400, n_queries=30):
    """90% short chunks (6-14 words over 500) and 10% long ones (90-120
    distinct words over 3,000: wider than 64 slots), queries drawn from a
    gold chunk: ``bucketize=2`` gives a packed bucket and a flat one."""
    rng = np.random.default_rng(seed)
    chunks = []
    for _ in range(n_chunks):
        if rng.random() < 0.9:
            chunks.append(" ".join(f"w{j}" for j in rng.choice(500, size=int(rng.integers(6, 15)))))
        else:
            size = int(rng.integers(90, 121))
            chunks.append(" ".join(f"v{j}" for j in rng.choice(3000, size=size, replace=False)))
    gold = rng.choice(n_chunks, size=n_queries, replace=False)
    queries = [" ".join(rng.choice(chunks[g].split(), size=4)) for g in gold]
    return chunks, queries, gold


def _run_slice(pkg, tmp_path, corpus=_corpus, bucketize=1):
    """Build a catalog, run BM25 and score it with one package -> (stats,
    rows, metrics, ad-hoc hits, resume stats)."""
    Catalog = importlib.import_module(f"{pkg}.store.catalog").Catalog
    gt_mod = importlib.import_module(f"{pkg}.store.gt")
    metrics = importlib.import_module(f"{pkg}.evaluation.metrics.retrieval")
    MetricInput = importlib.import_module(f"{pkg}.schema").MetricInput
    bm25 = importlib.import_module(f"{pkg}.pipelines.retrieval.bm25")
    registry = importlib.import_module(f"{pkg}.index.registry")
    pipe_kw = {"bucketize": bucketize}
    if pkg != "autorag_research_tpu":
        pipe_kw["device"] = "cpu"
    chunks, queries, gold = corpus()
    (tmp_path / pkg).mkdir()
    cat = Catalog(tmp_path / pkg / "ws.db")
    cat.add_chunks({"id": i, "contents": t} for i, t in enumerate(chunks))
    cat.add_queries({"id": j, "contents": t} for j, t in enumerate(queries))
    for j, g in enumerate(gold):
        cat.add_retrieval_gt(j, gt_mod.or_all([int(g)]))
    try:
        pipe = bm25.BM25Pipeline(cat, name="bm25", **pipe_kw)
        stats = pipe.run(top_k=10)
        rows, inputs = [], []
        for j in range(len(queries)):
            got = cat.get_retrieved(j, pipe.pipeline_id)
            rows += [(j, r["doc_id"], r["rel_score"]) for r in got]
            gt, _ = gt_mod.build_retrieval_gt_from_relations(
                [dict(r) for r in cat.get_relations_by_query(j)]
            )
            inputs.append(
                MetricInput(retrieval_gt=gt, retrieved_ids=[f"chunk_{r['doc_id']}" for r in got])
            )
        scores = {
            "recall": metrics.retrieval_recall(inputs),
            "ndcg": metrics.retrieval_ndcg(inputs),
            "mrr": metrics.retrieval_mrr(inputs),
        }
        adhoc = pipe._retrieve_batch_by_texts(queries[:3], 5)
        from asyncio import run

        adhoc.append(run(pipe._retrieve_by_text(queries[6], 5)))
        adhoc.append(run(pipe.retrieve(queries[7], 5)))  # a catalog query, by id
        resumed = bm25.BM25Pipeline(cat, name="bm25", **pipe_kw).run(top_k=10)
        buckets = pipe._index()._device_buckets
        layout = [(b["pack"], len(b["rows"])) for b in buckets] if buckets else None
        return stats, rows, scores, adhoc, resumed, pipe._get_pipeline_config(), layout
    finally:
        registry.invalidate(cat)
        cat.close()


def _assert_rows(t_rows, j_rows):
    assert len(t_rows) == len(j_rows)
    ts_, js_ = np.array([r[2] for r in t_rows]), np.array([r[2] for r in j_rows])
    np.testing.assert_allclose(ts_, js_, rtol=RTOL, atol=0)
    for i, (a, b) in enumerate(zip(t_rows, j_rows)):
        assert a[0] == b[0]
        if a[1] != b[1]:  # a near-tie only
            assert any(
                j_rows[x][0] == b[0] and abs(js_[i] - js_[x]) <= RTOL * js_[i]
                for x in (i - 1, i + 1) if 0 <= x < len(j_rows)
            )


def test_whole_bm25_slice_matches_jax(tmp_path):
    j_stats, j_rows, j_scores, j_adhoc, j_res, j_cfg, _ = _run_slice("autorag_research_tpu", tmp_path)
    t_stats, t_rows, t_scores, t_adhoc, t_res, t_cfg, _ = _run_slice("autorag_research_tpu_torch",
                                                                     tmp_path)
    assert t_cfg == j_cfg
    assert t_stats["total_results"] == j_stats["total_results"] == 230  # query 5 matches nothing
    assert t_stats["total_queries"] == j_stats["total_queries"] == 24
    _assert_rows(t_rows, j_rows)
    assert t_scores == j_scores
    assert 0.0 < np.mean(t_scores["recall"]) <= 1.0
    for t, j in zip(t_adhoc, j_adhoc, strict=True):
        _assert_rows([(0, h["doc_id"], h["score"]) for h in t], [(0, h["doc_id"], h["score"]) for h in j])
    # the resumed run retries only the query that persisted no row
    assert t_res["total_queries"] == j_res["total_queries"] == 1


def test_bucketed_bm25_slice_matches_jax(tmp_path):
    # BM25Pipeline(bucketize=2) on a 90/10 short/long catalog: a packed
    # bucket and a flat one in both packages, equal rows and metrics
    runs = {pkg: _run_slice(pkg, tmp_path, _skewed_corpus, bucketize=2)
            for pkg in ("autorag_research_tpu", "autorag_research_tpu_torch")}
    (j_stats, j_rows, j_scores, j_adhoc, _, j_cfg, j_layout), (t_stats, t_rows, t_scores, t_adhoc, _,
                                                                 t_cfg, t_layout) = runs.values()
    assert t_cfg == j_cfg and t_cfg["bucketize"] == 2
    assert t_layout == j_layout and len(t_layout) == 2 and t_layout[0][0] > 1 and t_layout[1][0] == 1
    # queries from a long chunk's rare words may have fewer than 10 hits
    assert t_stats["total_results"] == j_stats["total_results"] == len(t_rows) > 250
    assert t_stats["total_queries"] == 30
    _assert_rows(t_rows, j_rows)
    assert t_scores == j_scores
    assert np.mean(t_scores["recall"]) > 0.5
    for t, j in zip(t_adhoc, j_adhoc, strict=True):
        _assert_rows([(0, h["doc_id"], h["score"]) for h in t], [(0, h["doc_id"], h["score"]) for h in j])


@pytest.mark.parametrize("tokenizer", ["english", "wiki_tocken"])
def test_bm25_pipeline_options_reach_the_index(tmp_path, tokenizer):
    from autorag_research_tpu_torch.index import registry
    from autorag_research_tpu_torch.pipelines.retrieval import BM25Pipeline
    from autorag_research_tpu_torch.store.catalog import Catalog

    cat = Catalog(tmp_path / "ws.db")
    cat.add_chunks([{"id": 0, "contents": "the foxes are running"}, {"id": 1, "contents": "a dog sleeps"}])
    try:
        pipe = BM25Pipeline(cat, tokenizer=tokenizer, k1=0.9, b=0.4, device="cpu")
        idx = pipe._index()
        assert (idx.tokenizer_name, idx.k1, idx.b, idx.device.type) == (tokenizer, 0.9, 0.4, "cpu")
        hits = pipe._retrieve_batch_by_texts(["fox"], 2)[0]  # "foxes" stems to "fox"
        assert [h["doc_id"] for h in hits] == ([0] if tokenizer == "english" else [])
    finally:
        registry.invalidate(cat)
        cat.close()
