"""The port's hybrid slice as a whole vs the JAX package's.

One catalog from the JAX package's jax-free synthetic ingestor
(``data/synthetic.py``: Zipf texts, topical AND/OR graded GT, bag-of-tokens
embeddings) at ``scripts/parity_run.py``'s ``smoke`` scale (300 docs, 20
queries), copied once per package. Each package's ``Executor`` runs
``vector_search`` (verified), ``bm25``, ``hybrid_rrf``, ``hybrid_cc`` (tmm,
as ``parity_run.py`` configures it) and ``gqr_hybrid`` with health checks and
recall / ndcg. Per pipeline the persisted rows agree (ids equal; RRF's rows
bitwise; the dense leg's scores within 1e-5 relative, BM25's within 1e-6;
CC and GQR scores within ``tests/test_torch_hybrid.py``'s 1e-5 absolute plus
1e-6 relative, ids equal up to near-ties within it) and the metric averages
are equal.
"""

import importlib
import shutil

import numpy as np

from test_torch_hybrid import ATOL, JAX, RTOL, TORCH, assert_rows_close

PIPELINES = ["vector_search", "bm25", "hybrid_rrf", "hybrid_cc", "gqr_hybrid"]


def _ingest(path):
    from autorag_research_tpu.data.synthetic import BagOfTokensEmbedding, SyntheticIngestor
    from autorag_research_tpu.store.catalog import Catalog
    from autorag_research_tpu.store.ingestion import IngestionService

    cat = Catalog(path)
    ingestor = SyntheticIngestor(
        embedding_model=BagOfTokensEmbedding(dim=256), n_docs=300, n_queries=20
    )
    ingestor.set_service(IngestionService(cat))
    ingestor.ingest()
    ingestor.embed_all()
    cat.close()


def _run(pkg, db):
    config = importlib.import_module(f"{pkg}.config")
    r = importlib.import_module(f"{pkg}.pipelines.retrieval")
    registry = importlib.import_module(f"{pkg}.index.registry")
    cat = importlib.import_module(f"{pkg}.store.catalog").Catalog(db)
    legs = dict(retrieval_pipeline_1_name="vector_search", retrieval_pipeline_2_name="bm25")
    cfg = config.ExecutorConfig(
        pipelines=[
            r.VectorSearchConfig(name="vector_search", index_options={"mode": "verified"}),
            r.BM25Config(name="bm25"),
            r.HybridRRFConfig(name="hybrid_rrf", **legs),
            r.HybridCCConfig(name="hybrid_cc", normalize_method="tmm", **legs),
            r.GQRHybridConfig(name="gqr_hybrid", **legs),
        ],
        metrics=[config.BaseMetricConfig(name="recall"), config.BaseMetricConfig(name="ndcg")],
    )
    ctx = config.BuildContext(device="cpu") if pkg == TORCH else None
    try:
        result = importlib.import_module(f"{pkg}.executor").Executor(cat, cfg, ctx).run()
        rows = {
            p.name: [
                (q, x["doc_id"], x["rel_score"])
                for q in cat.get_all_query_ids()
                for x in cat.get_retrieved(q, p.stats["pipeline_id"])
            ]
            for p in result.pipelines
        }
        leftovers = [n for n in PIPELINES if cat.get_pipeline(f"{n}_health_check")]
        return result, rows, leftovers
    finally:
        registry.invalidate(cat)
        cat.close()


def test_hybrid_slice_matches_jax(tmp_path):
    _ingest(tmp_path / "src.db")
    out = {}
    for pkg in (JAX, TORCH):
        (tmp_path / pkg).mkdir()
        shutil.copy(tmp_path / "src.db", tmp_path / pkg / "ws.db")
        out[pkg] = _run(pkg, tmp_path / pkg / "ws.db")
    (j_res, j_rows, j_left), (t_res, t_rows, t_left) = out[JAX], out[TORCH]
    assert j_res.success and t_res.success, t_res.report()
    assert j_left == t_left == []
    assert [p.name for p in t_res.pipelines] == PIPELINES
    for pj, pt in zip(j_res.pipelines, t_res.pipelines):
        assert pt.stats["total_results"] == pj.stats["total_results"] == 200, pt.name
        assert [(m.metric_name, m.count, m.average) for m in pt.metrics] == [
            (m.metric_name, m.count, m.average) for m in pj.metrics
        ], pt.name
        assert all(m.success for m in pt.metrics)
    for name, rtol in (("vector_search", 1e-5), ("bm25", 1e-6)):
        assert [x[:2] for x in t_rows[name]] == [x[:2] for x in j_rows[name]]
        np.testing.assert_allclose([x[2] for x in t_rows[name]], [x[2] for x in j_rows[name]],
                                   rtol=rtol)
    assert t_rows["hybrid_rrf"] == j_rows["hybrid_rrf"]
    for name in ("hybrid_cc", "gqr_hybrid"):
        assert_rows_close(t_rows[name], j_rows[name], RTOL, ATOL)
    # the recipe's hybrid reaches both legs' relevant documents
    recall = {p.name: p.metrics[0].average for p in t_res.pipelines}
    assert recall["hybrid_rrf"] >= min(recall["vector_search"], recall["bm25"])
