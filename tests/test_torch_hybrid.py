"""The port's hybrid pipelines and loader against the JAX package's.

One small catalog (dense + BM25 legs, two gold chunks a query, HotpotQA's
shape at 240 chunks) is built once and copied; each package's ``Executor``
runs the two legs and the RRF, CC (mm, tmm, z, dbsf) and GQR hybrids over
its own copy, the dense leg in verified and in exact mode. Persisted rows:

- the legs' and RRF's ids are equal (RRF depends on ranks alone), RRF's
  scores bitwise;
- CC and GQR ids are equal up to fused near-ties within the tolerance, and
  scores within ``ATOL`` = 1e-5 absolute plus ``RTOL`` = 1e-6 relative. The
  fused scores are O(1) (mm / tmm / dbsf in [0, 1], z-scores within about 3);
  normalization divides the legs' ulp-level differences between the packages
  (BM25 about 1e-7 relative at scores up to about 30, dense about 1e-7
  absolute) by the leg's spread, and a z-score near 0 has no useful relative
  bound;
- the dense leg's scores within 1e-5 relative, BM25's within 1e-6.

Also: ``_theoretical_min`` per leg type, mixed retrieval units refused, the
loader's cycle error, not-found error and shared-leg cache, and the cases of
``tests/test_hybrid.py::TestHybridPipelines``.
"""

import importlib
import shutil

import numpy as np
import pytest

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
RTOL, ATOL = 1e-6, 1e-5
DIM = 32
HYBRIDS = ["rrf", "cc_mm", "cc_tmm", "cc_z", "cc_dbsf", "gqr"]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def build_catalog(path, seed=0, n_chunks=240, n_queries=24):
    """HotpotQA's shape at a small size: texts of 6-30 words, two distinct
    gold chunks a query (AND), query text drawn from both, query embedding
    the normalized sum of the gold embeddings plus noise."""
    from autorag_research_tpu_torch.store.catalog import Catalog
    from autorag_research_tpu_torch.store.gt import and_all

    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(300)]
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(6, 31)))) for _ in range(n_chunks)]
    emb = rng.standard_normal((n_chunks, DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    cat = Catalog(path, embedding_dim=DIM)
    cat.add_chunks({"id": i, "contents": t, "embedding": e} for i, (t, e) in enumerate(zip(texts, emb)))
    queries = []
    for j in range(n_queries):
        g = rng.choice(n_chunks, size=2, replace=False)
        words = list(rng.choice(texts[g[0]].split(), size=3)) + list(rng.choice(texts[g[1]].split(), size=3))
        q = emb[g[0]] + emb[g[1]] + 0.3 * rng.standard_normal(DIM).astype(np.float32)
        queries.append(({"id": j, "contents": " ".join(words), "embedding": q / np.linalg.norm(q)}, g))
    cat.add_queries(q for q, _ in queries)
    for q, g in queries:
        cat.add_retrieval_gt(q["id"], and_all([int(g[0]), int(g[1])]))
    cat.close()


def leg_configs(pkg, mode):
    r = _mod(pkg, "pipelines.retrieval")
    return {
        "dense": r.VectorSearchConfig(name="dense", index_options={"mode": mode}),
        "bm25": r.BM25Config(name="bm25"),
    }


def hybrid_configs(pkg):
    r = _mod(pkg, "pipelines.retrieval")
    legs = dict(retrieval_pipeline_1_name="dense", retrieval_pipeline_2_name="bm25")
    return [
        r.HybridRRFConfig(name="rrf", **legs),
        *[r.HybridCCConfig(name=f"cc_{m}", normalize_method=m, weight=0.4, **legs)
          for m in ("mm", "tmm", "z", "dbsf")],
        r.GQRHybridConfig(name="gqr", **legs),
    ]


def run_package(pkg, db, mode):
    """Both legs and every hybrid through ``pkg``'s Executor -> (result,
    {pipeline: [(query, doc, score), ...]})."""
    config = _mod(pkg, "config")
    cat = _mod(pkg, "store.catalog").Catalog(db)
    registry = _mod(pkg, "index.registry")
    legs = leg_configs(pkg, mode)
    ctx = {"device": "cpu"} if pkg == TORCH else {}
    cfg = config.ExecutorConfig(
        pipelines=[*legs.values(), *hybrid_configs(pkg)],
        metrics=[config.BaseMetricConfig(name="recall"), config.BaseMetricConfig(name="ndcg")],
        health_check=False,
    )
    try:
        result = _mod(pkg, "executor").Executor(
            cat, cfg, config.BuildContext(pipeline_configs=dict(legs), **ctx)
        ).run()
        rows = {
            p.name: [
                (q, r["doc_id"], r["rel_score"])
                for q in cat.get_all_query_ids()
                for r in cat.get_retrieved(q, p.stats["pipeline_id"])
            ]
            for p in result.pipelines
        }
        return result, rows
    finally:
        registry.invalidate(cat)
        cat.close()


@pytest.fixture(scope="module", params=["verified", "exact"])
def runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"hybrid_{request.param}")
    build_catalog(tmp / "src.db")
    out = {}
    for pkg in (JAX, TORCH):
        (tmp / pkg).mkdir()
        shutil.copy(tmp / "src.db", tmp / pkg / "ws.db")
        out[pkg] = run_package(pkg, tmp / pkg / "ws.db", request.param)
    return out


def assert_rows_close(got, ref, rtol, atol):
    """Same (query, rank) slots; ids equal but where the two fused scores
    lie within the tolerance of each other (a near-tie the packages may
    order apart); scores within the tolerance."""
    assert len(got) == len(ref)
    for (qg, dg, sg), (qr, dr, sr) in zip(got, ref):
        assert qg == qr
        assert abs(sg - sr) <= atol + rtol * abs(sr), (qg, dg, sg, dr, sr)
        if dg != dr:
            swapped = [s for q, d, s in ref if q == qr and d == dg]
            assert swapped and abs(swapped[0] - sr) <= 2 * (atol + rtol * abs(sr)), (qg, dg, dr)


def test_executor_runs_succeed_with_equal_metrics(runs):
    (j_res, _), (t_res, _) = runs[JAX], runs[TORCH]
    assert j_res.success and t_res.success, t_res.report()
    assert [p.name for p in t_res.pipelines] == ["dense", "bm25", *HYBRIDS]
    for pj, pt in zip(j_res.pipelines, t_res.pipelines):
        assert pt.stats["total_results"] == pj.stats["total_results"] == 24 * 10
        assert [(m.metric_name, m.count) for m in pt.metrics] == [("recall", 24), ("ndcg", 24)]
        # the metrics read ids only; CC / GQR near-ties could move them, and
        # none does on this catalog
        assert [m.average for m in pt.metrics] == [m.average for m in pj.metrics], pt.name


def test_legs_match_jax(runs):
    (_, j_rows), (_, t_rows) = runs[JAX], runs[TORCH]
    for name, rtol in (("dense", 1e-5), ("bm25", 1e-6)):
        assert [r[:2] for r in t_rows[name]] == [r[:2] for r in j_rows[name]]
        np.testing.assert_allclose([r[2] for r in t_rows[name]], [r[2] for r in j_rows[name]],
                                   rtol=rtol)


def test_rrf_rows_equal_jax(runs):
    (_, j_rows), (_, t_rows) = runs[JAX], runs[TORCH]
    assert t_rows["rrf"] == j_rows["rrf"]


@pytest.mark.parametrize("name", ["cc_mm", "cc_tmm", "cc_z", "cc_dbsf", "gqr"])
def test_fused_rows_match_jax(runs, name):
    (_, j_rows), (_, t_rows) = runs[JAX], runs[TORCH]
    assert_rows_close(t_rows[name], j_rows[name], RTOL, ATOL)


@pytest.fixture
def tcat(tmp_path):
    build_catalog(tmp_path / "t.db")
    cat = _mod(TORCH, "store.catalog").Catalog(tmp_path / "t.db")
    yield cat
    _mod(TORCH, "index.registry").invalidate(cat)
    cat.close()


def _loader(pkg, cat, configs, **ctx):
    config = _mod(pkg, "config")
    return _mod(pkg, "pipelines.loader").PipelineLoader(
        cat, config.BuildContext(pipeline_configs=configs, **ctx)
    )


def test_hybrid_rows_equal_host_fusers_over_the_legs_lists(tcat):
    """The batch path asks each leg for top_k * fetch_k_multiplier through
    its own batched search and fuses with the host fusers: bitwise."""
    from autorag_research_tpu_torch.ops.fusion import cc_fuse, rrf_fuse

    configs = {**leg_configs(TORCH, "verified"), **{c.name: c for c in hybrid_configs(TORCH)}}
    loader = _loader(TORCH, tcat, configs, device="cpu")
    qids = tcat.get_all_query_ids()
    l1 = loader.load("dense")._retrieve_batch_by_ids(qids, 20)
    l2 = loader.load("bm25")._retrieve_batch_by_ids(qids, 20)
    rrf = loader.load("rrf")._retrieve_batch_by_ids(qids, 10)
    cc = loader.load("cc_tmm")._retrieve_batch_by_ids(qids, 10)
    for q in qids:
        assert rrf[q] == rrf_fuse(l1[q], l2[q], k=60, top_k=10, fetch_k=20)
        assert cc[q] == cc_fuse(l1[q], l2[q], weight=0.4, top_k=10, normalize_method="tmm",
                                pipeline_1_min=-1.0, pipeline_2_min=0.0)


class _Leg:
    def __init__(self, type_=None, unit="chunk"):
        self.retrieval_unit = unit
        if type_ is not None:
            self._get_pipeline_config = lambda: {"type": type_}


@pytest.mark.parametrize("leg_type,expected", [
    ("vector_search", -1.0), ("image_vector_search", -1.0), ("hyde", -1.0),
    ("bm25", 0.0), ("hybrid_rrf", 0.0), (None, 0.0),
])
def test_theoretical_min_per_leg_type(leg_type, expected):
    t = _mod(TORCH, "pipelines.retrieval.hybrid")._theoretical_min(_Leg(leg_type))
    j = _mod(JAX, "pipelines.retrieval.hybrid")._theoretical_min(_Leg(leg_type))
    assert t == j == expected


def test_theoretical_min_of_built_legs(tcat):
    from autorag_research_tpu_torch.pipelines.retrieval.hybrid import _theoretical_min

    loader = _loader(TORCH, tcat, leg_configs(TORCH, "exact"), device="cpu")
    assert _theoretical_min(loader.load("dense")) == -1.0
    assert _theoretical_min(loader.load("bm25")) == 0.0


@pytest.mark.parametrize("cls", ["HybridRRFPipeline", "HybridCCPipeline"])
def test_mixed_retrieval_units_refused(tcat, cls):
    hybrid = _mod(TORCH, "pipelines.retrieval.hybrid")
    with pytest.raises(ValueError, match="different units"):
        getattr(hybrid, cls)(tcat, "mixed", _Leg("vector_search"),
                             _Leg("image_vector_search", unit="image_chunk"))
    pipe = getattr(hybrid, cls)(tcat, "images", _Leg(unit="image_chunk"),
                                _Leg(unit="image_chunk"))
    assert pipe.retrieval_unit == "image_chunk"


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
def test_loader_cycle_error(tcat, pkg):
    r = _mod(pkg, "pipelines.retrieval")
    exc = _mod(pkg, "exceptions")
    a = r.HybridRRFConfig(name="a", retrieval_pipeline_1_name="b", retrieval_pipeline_2_name="b")
    b = r.HybridRRFConfig(name="b", retrieval_pipeline_1_name="a", retrieval_pipeline_2_name="a")
    with pytest.raises(exc.PipelineCycleError, match="a -> b -> a"):
        _loader(pkg, tcat, {"a": a, "b": b}).load("a")


def test_loader_not_found_error(tcat):
    from autorag_research_tpu_torch.exceptions import PipelineNotFoundError
    from autorag_research_tpu_torch.pipelines.retrieval import HybridRRFConfig

    h = HybridRRFConfig(name="h", retrieval_pipeline_1_name="dense",
                        retrieval_pipeline_2_name="missing")
    loader = _loader(TORCH, tcat, {**leg_configs(TORCH, "exact"), "h": h}, device="cpu")
    with pytest.raises(PipelineNotFoundError, match="missing"):
        loader.load("h")
    with pytest.raises(PipelineNotFoundError):
        loader.load("nowhere")


def test_loader_shares_legs_and_passes_the_device(tcat):
    configs = {**leg_configs(TORCH, "exact"), **{c.name: c for c in hybrid_configs(TORCH)}}
    loader = _loader(TORCH, tcat, configs, device="cpu")
    rrf, cc, gqr = loader.load("rrf"), loader.load("cc_z"), loader.load("gqr")
    assert rrf.pipeline_2 is cc.pipeline_2 is gqr.complementary is loader.load("bm25")
    assert rrf.pipeline_1 is cc.pipeline_1 is gqr.primary
    assert str(rrf.pipeline_1.device) == str(rrf.pipeline_2.device) == "cpu"
    assert loader.load("cc_z") is cc
    # load_config registers a config by its name first
    extra = _mod(TORCH, "pipelines.retrieval").BM25Config(name="bm25_b", k1=0.9)
    assert loader.load_config(extra) is loader.load("bm25_b")
    # and a context without a loader refuses a named leg
    with pytest.raises(ValueError, match="no pipeline loader"):
        _mod(TORCH, "config").BuildContext(device="cpu").load_pipeline("dense")


# ------------------------------------ tests/test_hybrid.py::TestHybridPipelines
def _mock_catalog(pkg, path):
    emb = _mod(pkg, "embeddings").MockEmbedding(dim=32)
    gt = _mod(pkg, "store.gt")
    docs = ["quick brown fox jumps", "lazy dog sleeps", "database of vectors",
            "fox and dog together", "tpu matrix hardware"]
    cat = _mod(pkg, "store.catalog").Catalog(path, embedding_dim=32)
    cat.add_chunks([{"id": i, "contents": d, "embedding": emb.embed_query(d)}
                    for i, d in enumerate(docs)])
    cat.add_queries([
        {"id": 0, "contents": "quick fox", "embedding": emb.embed_query("quick fox")},
        {"id": 1, "contents": "dog sleeping", "embedding": emb.embed_query("dog sleeping")},
    ])
    cat.add_retrieval_gt(0, gt.or_all([0, 3]))
    cat.add_retrieval_gt(1, 1)
    return cat


@pytest.mark.parametrize("hybrid_type,extra", [
    ("hybrid_rrf", {}),
    ("hybrid_cc", {"normalize_method": "mm"}),
    ("hybrid_cc", {"normalize_method": "tmm"}),
    ("hybrid_cc", {"normalize_method": "z"}),
    ("hybrid_cc", {"normalize_method": "dbsf"}),
])
def test_executor_with_hybrid(tmp_path, hybrid_type, extra):
    averages = {}
    for pkg in (JAX, TORCH):
        config = _mod(pkg, "config")
        r = _mod(pkg, "pipelines.retrieval")
        cat = _mock_catalog(pkg, tmp_path / f"{pkg}.db")
        sub = [r.VectorSearchConfig(name="vs"), r.BM25Config(name="bm25")]
        legs = dict(retrieval_pipeline_1_name="vs", retrieval_pipeline_2_name="bm25", top_k=3)
        if hybrid_type == "hybrid_rrf":
            hyb = r.HybridRRFConfig(name="hyb", **legs)
        else:
            hyb = r.HybridCCConfig(name=f"hyb_{extra['normalize_method']}", **legs, **extra)
        cfg = config.ExecutorConfig(
            pipelines=[hyb],
            metrics=[config.BaseMetricConfig(name="recall"), config.BaseMetricConfig(name="ndcg")],
            health_check=False,
        )
        ctx = {"device": "cpu"} if pkg == TORCH else {}
        try:
            result = _mod(pkg, "executor").Executor(
                cat, cfg, config.BuildContext(pipeline_configs={c.name: c for c in sub}, **ctx)
            ).run()
        finally:
            _mod(pkg, "index.registry").invalidate(cat)
        assert result.success, result.report()
        # the BM25 leg guarantees the lexical-match docs surface
        assert result.pipelines[0].metrics[0].average == 1.0
        averages[pkg] = [m.average for m in result.pipelines[0].metrics]
        cat.close()
    assert averages[TORCH] == averages[JAX]
