"""The port's Executor, configs and evaluation service, case by case with
``tests/test_executor.py`` and ``tests/test_evaluation_service.py``.

Each case runs the port (``BuildContext(device="cpu")``) on the seed
catalog of ``tests/conftest.py`` built with the port's ``Catalog``; where a
case reads numbers, the JAX package's Executor or service runs the same case
on its own catalog and the two must agree. Also: each package's config
registry resolves its own classes in one process, ``Executor`` without a
context builds for the card, and a generation metric is refused until the
generation metrics are ported.
"""

from dataclasses import dataclass

import numpy as np
import pytest

from autorag_research_tpu_torch.config import (
    BaseMetricConfig,
    BasePipelineConfig,
    BuildContext,
    ExecutorConfig,
)
from autorag_research_tpu_torch.evaluation.metrics.retrieval import retrieval_recall
from autorag_research_tpu_torch.evaluation.service import (
    GenerationEvaluationService,
    RetrievalEvaluationService,
)
from autorag_research_tpu_torch.exceptions import MetricNotFoundError, NoQueryInDBError
from autorag_research_tpu_torch.executor import Executor
from autorag_research_tpu_torch.index import registry
from autorag_research_tpu_torch.pipelines.retrieval.base import BaseRetrievalPipeline
from autorag_research_tpu_torch.pipelines.retrieval.bm25 import BM25Config
from autorag_research_tpu_torch.pipelines.retrieval.vector_search import VectorSearchConfig
from autorag_research_tpu_torch.store.catalog import Catalog
from autorag_research_tpu_torch.store.gt import and_all, or_all

CPU = BuildContext(device="cpu")


def seed_catalog(path):
    """``tests/conftest.py::catalog`` built with the port's Catalog."""
    cat = Catalog(path, embedding_dim=8)
    rng = np.random.default_rng(42)
    cat.add_chunks([
        {"id": i, "contents": f"chunk number {i} about topic {i % 3}",
         "embedding": rng.normal(size=8).astype(np.float32)}
        for i in range(1, 6)
    ])
    cat.add_queries([
        {"id": 1, "contents": "what is topic zero", "generation_gt": ["topic zero"]},
        {"id": 2, "contents": "tell me about topic one", "generation_gt": ["topic one"]},
        {"id": 3, "contents": "explain topic two", "generation_gt": ["topic two"]},
    ])
    cat.add_retrieval_gt(1, or_all([1, 4]))
    cat.add_retrieval_gt(2, and_all([2, 5]))
    cat.add_retrieval_gt(3, 3)
    ids, mat = cat.get_embeddings_matrix("chunk")
    cat.set_embeddings("query", [(1, mat[0]), (2, mat[1]), (3, mat[2])])
    return cat


@pytest.fixture
def tcat(tmp_path):
    cat = seed_catalog(tmp_path / "port.db")
    yield cat
    registry.invalidate()
    cat.close()


@pytest.fixture(autouse=True)
def clear_index_cache():
    registry.invalidate()
    yield
    registry.invalidate()


def make_config(**kw):
    defaults = dict(
        pipelines=[VectorSearchConfig(name="vs", top_k=3)],
        metrics=[
            BaseMetricConfig(name="recall", metric_type="retrieval"),
            BaseMetricConfig(name="ndcg", metric_type="retrieval"),
        ],
        health_check_queries=2,
    )
    defaults.update(kw)
    return ExecutorConfig(**defaults)


def jax_run(catalog, **kw):
    """The same case through the JAX package (its conftest catalog)."""
    from autorag_research_tpu import config as jc
    from autorag_research_tpu.executor import Executor as JExecutor
    from autorag_research_tpu.index import registry as jreg
    from autorag_research_tpu.pipelines.retrieval.vector_search import (
        VectorSearchConfig as JVS,
    )

    cfg = jc.ExecutorConfig(
        pipelines=[JVS(name="vs", top_k=3, **kw)],
        metrics=[jc.BaseMetricConfig(name="recall"), jc.BaseMetricConfig(name="ndcg")],
        health_check_queries=2,
    )
    try:
        return JExecutor(catalog, cfg).run()
    finally:
        jreg.invalidate()


# ----------------------------------------------------- tests/test_executor.py
def test_executor_end_to_end(tcat, catalog):
    result = Executor(tcat, make_config(), CPU).run()
    assert result.success, result.report()
    pres = result.pipelines[0]
    assert pres.stats["total_queries"] == 3
    assert pres.stats["failed_queries"] == []
    recalls = {m.metric_name: m for m in pres.metrics}
    assert recalls["recall"].count == 3
    assert recalls["recall"].average is not None and recalls["recall"].average > 0.4
    assert recalls["ndcg"].average is not None
    assert tcat.get_pipeline("vs_health_check") is None
    ref = jax_run(catalog)
    assert [(m.metric_name, m.count, m.average) for m in pres.metrics] == [
        (m.metric_name, m.count, m.average) for m in ref.pipelines[0].metrics
    ]
    assert set(result.spans) == set(ref.spans) == {
        "vs/health_check", "vs/run", "vs/metric/recall", "vs/metric/ndcg"
    }


def test_executor_resume_skips_done(tcat):
    assert Executor(tcat, make_config(), CPU).run().success
    registry.invalidate()
    r2 = Executor(tcat, make_config(), CPU).run()
    assert r2.success
    assert r2.pipelines[0].stats["total_queries"] == 0


def test_executor_no_queries(tmp_path):
    with pytest.raises(NoQueryInDBError):
        Executor(Catalog(tmp_path / "empty.db"), make_config(), CPU).run()


def test_health_check_failure_on_missing_embeddings(tcat):
    with tcat.connect() as conn:
        conn.execute("UPDATE query SET embedding=NULL")
    result = Executor(tcat, make_config(), CPU).run()
    assert not result.success
    assert "HealthCheck" in (result.pipelines[0].error or "")
    # the failed health check leaves no artifacts behind either
    assert tcat.get_pipeline("vs_health_check") is None


def test_executor_without_health_check(tcat):
    result = Executor(tcat, make_config(health_check=False), CPU).run()
    assert result.success
    assert "vs/health_check" not in result.spans


def test_report_format(tcat):
    text = Executor(tcat, make_config(), CPU).run().report()
    assert "vs [retrieval]" in text
    assert "retrieval/recall" in text


def test_query_limit(tcat):
    cfg = make_config(
        pipelines=[VectorSearchConfig(name="vs_lim", top_k=2, query_limit=2)], health_check=False
    )
    result = Executor(tcat, cfg, CPU).run()
    assert result.success, result.report()
    assert result.pipelines[0].stats["total_queries"] == 2
    assert [m.count for m in result.pipelines[0].metrics] == [2, 2]


class ExplodingPipeline(BaseRetrievalPipeline):
    retrieval_unit = "chunk"

    def _get_pipeline_config(self):
        return {"type": "exploding"}

    async def _retrieve_by_id(self, query_id, top_k):
        raise RuntimeError("search backend down")

    async def _retrieve_by_text(self, query_text, top_k):
        raise RuntimeError("search backend down")


@dataclass(kw_only=True)
class ExplodingConfig(BasePipelineConfig):
    config_type = "exploding_test"
    kind = "retrieval"

    def build(self, cat, context):
        return ExplodingPipeline(cat, self.name)


def test_retrieval_fault_injection(tcat):
    cfg = make_config(
        pipelines=[ExplodingConfig(name="boom", max_retries=1, retry_delay=0.0)],
        health_check=False,
        max_retries=0,
    )
    pres = Executor(tcat, cfg, CPU).run().pipelines[0]
    assert not pres.success
    assert len(pres.stats["failed_queries"]) == 3
    assert pres.error is not None


def test_retry_of_a_config_that_raises(tcat):
    """A build that raises is retried ``max_retries`` times, then the pipeline
    fails with the last error; the other pipelines still run."""
    calls = []

    @dataclass(kw_only=True)
    class FlakyConfig(BasePipelineConfig):
        config_type = "flaky_build_test"

        def build(self, cat, context):
            calls.append(1)
            raise RuntimeError(f"build failed ({len(calls)})")

    cfg = make_config(
        pipelines=[FlakyConfig(name="flaky"), VectorSearchConfig(name="vs_ok", top_k=3)],
        health_check=False, max_retries=2,
    )
    result = Executor(tcat, cfg, CPU).run()
    flaky, ok = result.pipelines
    assert len(calls) == 3 and flaky.attempts == 3
    assert not flaky.success and flaky.error == "RuntimeError: build failed (3)"
    assert ok.success and not result.success


def test_zero_hit_query_passes_verification(tcat):
    tcat.add_queries([{"id": 50, "contents": "xylophone zygote quux"}])
    cfg = make_config(pipelines=[BM25Config(name="bm25_zero", top_k=3)], health_check=False)
    result = Executor(tcat, cfg, CPU).run()
    assert result.success, result.report()
    stats = result.pipelines[0].stats
    assert 50 in stats["empty_queries"]
    assert stats["failed_queries"] == []


def test_query_limit_is_fixed_window(tcat):
    def cfg():
        return make_config(
            pipelines=[VectorSearchConfig(name="vs_win", top_k=2, query_limit=2)],
            health_check=False,
        )

    r1 = Executor(tcat, cfg(), CPU).run()
    assert r1.success
    window = set(tcat.get_all_query_ids()[:2])
    pid = r1.pipelines[0].stats["pipeline_id"]
    assert tcat.get_queries_with_results(pid) == window
    registry.invalidate()
    r2 = Executor(tcat, cfg(), CPU).run()
    assert r2.success and r2.pipelines[0].stats["total_queries"] == 0
    assert tcat.get_queries_with_results(pid) == window


def test_executor_fast_mode_index_options(tcat, catalog):
    opts = {"mode": "approx", "dtype": "bfloat16"}
    cfg = make_config(pipelines=[VectorSearchConfig(name="vs", top_k=3, index_options=opts)])
    result = Executor(tcat, cfg, CPU).run()
    assert result.success, result.report()
    idx = registry.get_or_build(tcat, "dense", "chunk", builder=lambda: None, device="cpu",
                                dtype="bfloat16", mode="approx")
    assert idx is not None and idx.mode == "approx" and idx.dtype == "bfloat16"
    ref = jax_run(catalog, index_options=opts)
    assert [m.average for m in result.pipelines[0].metrics] == [
        m.average for m in ref.pipelines[0].metrics
    ]


def test_health_check_removes_stale_artifacts(tcat):
    """Artifacts of a run killed mid-health-check are purged first."""
    stale = tcat.get_or_create_pipeline("vs_health_check")
    tcat.add_retrieved_results(stale, [(1, 1, 0.5)])
    result = Executor(tcat, make_config(), CPU).run()
    assert result.success, result.report()
    assert tcat.get_pipeline("vs_health_check") is None


def test_executor_without_context_builds_for_the_card(tcat):
    ex = Executor(tcat, make_config())
    assert ex.context.device == "cuda"
    pipe = ex.loader.load_config(BM25Config(name="bm25_card"))
    assert str(pipe.device) == "cuda"


# -------------------------------------------------------- configs and registry
def test_each_package_resolves_its_own_config_types():
    import autorag_research_tpu.pipelines.retrieval as jr
    from autorag_research_tpu.config import BasePipelineConfig as JBase

    import autorag_research_tpu_torch.pipelines.retrieval as tr

    assert JBase.registry is not BasePipelineConfig.registry
    for type_name, cls in [
        ("bm25", "BM25Config"), ("vector_search", "VectorSearchConfig"),
        ("image_vector_search", "ImageVectorSearchConfig"),
        ("hybrid_rrf", "HybridRRFConfig"), ("hybrid_cc", "HybridCCConfig"),
        ("gqr_hybrid", "GQRHybridConfig"),
    ]:
        extra = {}
        if type_name.startswith(("hybrid", "gqr")):
            extra = {"retrieval_pipeline_1_name": "a", "retrieval_pipeline_2_name": "b"}
        data = {"type": type_name, "name": "p", **extra}
        assert type(BasePipelineConfig.from_dict(data)) is getattr(tr, cls)
        assert type(JBase.from_dict(data)) is getattr(jr, cls)
    assert "heaven" in JBase.registry and "heaven" not in BasePipelineConfig.registry


def test_from_dict_refusals():
    with pytest.raises(KeyError, match="unknown pipeline type"):
        BasePipelineConfig.from_dict({"type": "nope", "name": "x"})
    with pytest.raises(TypeError, match="unknown keys"):
        BasePipelineConfig.from_dict({"type": "bm25", "name": "x", "mesh": 1})


def test_vector_search_config_refuses_ivf_until_ported(tcat):
    cfg = VectorSearchConfig(name="ivf", index_type="ivf")
    with pytest.raises(NotImplementedError, match="IVF"):
        cfg.build(tcat, CPU)


@pytest.mark.parametrize("name", ["faithfulness", "bleu"])
def test_generation_metric_refused(name):
    with pytest.raises(MetricNotFoundError, match="generation-side slice"):
        BaseMetricConfig(name=name, metric_type="generation").metric_func(CPU)


def test_metric_func_kwargs_and_unknown_metric():
    from autorag_research_tpu_torch.schema import MetricInput

    with pytest.raises(MetricNotFoundError):
        BaseMetricConfig(name="nope").metric_func(CPU)
    fn = BaseMetricConfig(name="recall").metric_func(CPU)
    mi = MetricInput(retrieval_gt=[["chunk_1"]], retrieved_ids=["chunk_1"])
    assert fn([mi]) == [1.0]


def test_build_context_models_contract():
    ctx = BuildContext(device="cpu")
    obj = object()
    assert ctx.load_embedding(obj) is obj and ctx.load_embedding(None) is None
    for load in (ctx.load_embedding, ctx.load_llm, ctx.load_reranker):
        with pytest.raises(ValueError, match="no model registry"):
            load("some-model")

    class Models:
        def load_embedding(self, name):
            return ("emb", name)

        def load_llm(self, name):
            return ("llm", name)

        def load_reranker(self, name):
            return ("rr", name)

    ctx = BuildContext(device="cpu", models=Models())
    assert ctx.load_llm("m") == ("llm", "m")
    assert ctx.metric_extras(BaseMetricConfig(name="x", kwargs={"llm": "m", "k": 1})) == {
        "llm": ("llm", "m")
    }


# ------------------------------------------- tests/test_evaluation_service.py
@pytest.fixture
def evaluated(tcat):
    pid = tcat.get_or_create_pipeline("p_eval")
    tcat.add_retrieved_results(pid, [(1, 1, 0.9), (2, 5, 0.8), (3, 3, 0.7)])
    return tcat, pid


def test_query_granularity_incremental_and_resume(evaluated):
    cat, pid = evaluated
    service = RetrievalEvaluationService(cat)
    summary = service.evaluate(pid, "recall", retrieval_recall)
    assert summary.count == 3
    cat.add_evaluation_results(pid, summary.metric_id, [(1, 0.123)])
    summary2 = service.evaluate(pid, "recall", retrieval_recall)
    assert 0.123 in cat.get_evaluation_values(pid, summary.metric_id)
    assert summary2.count == 3


def test_verify_completion(evaluated):
    cat, pid = evaluated
    service = RetrievalEvaluationService(cat)
    summary = service.evaluate(pid, "recall", retrieval_recall)
    assert service.verify_completion(pid, summary.metric_id)
    cat.add_queries([{"id": 99, "contents": "new query"}])
    assert not service.verify_completion(pid, summary.metric_id)


def test_dataset_granularity_delete_and_recompute(evaluated):
    cat, pid = evaluated
    service = RetrievalEvaluationService(cat)
    calls = []

    def whole_set_metric(inputs):
        calls.append(len(inputs))
        return [0.5] * len(inputs)

    s1 = service.evaluate(pid, "whole_set", whole_set_metric, granularity="dataset")
    assert s1.count == 3 and calls == [3]
    service.evaluate(pid, "whole_set", whole_set_metric, granularity="dataset")
    assert calls == [3, 3]


def test_dataset_granularity_windowed_call_keeps_full_set(evaluated):
    cat, pid = evaluated
    service = RetrievalEvaluationService(cat)

    def whole_set_metric(inputs):
        return [0.5] * len(inputs)

    assert service.evaluate(pid, "ws2", whole_set_metric, granularity="dataset").count == 3
    all_ids = sorted(cat.get_all_query_ids(), key=str)
    windowed = service.evaluate(pid, "ws2", whole_set_metric, granularity="dataset",
                                query_ids=all_ids[:1])
    assert windowed.count == 1
    mid = cat.get_or_create_metric("ws2", service.metric_type)
    assert len(cat.get_evaluation_values(pid, mid)) == 3


def test_none_scores_are_retried_not_persisted(tcat):
    pid = tcat.get_or_create_pipeline("retry_none")
    tcat.add_retrieved_results(pid, [(1, 1, 0.9)])
    service = RetrievalEvaluationService(tcat)
    state = {"ready": False}

    def flaky_metric(inputs):
        return [1.0 if state["ready"] else None] * len(inputs)

    assert service.evaluate(pid, "flaky", flaky_metric).count == 0
    state["ready"] = True
    assert service.evaluate(pid, "flaky", flaky_metric).count == 3


def test_mixed_gt_satisfied_by_either_table(tmp_path):
    from autorag_research_tpu_torch.store.gt import image as image_gt
    from autorag_research_tpu_torch.store.gt import or_all_mixed
    from autorag_research_tpu_torch.store.gt import text as text_gt

    cat = Catalog(tmp_path / "mixed.db")
    cat.add_chunks([{"id": 1, "contents": "text evidence"}])
    cat.add_image_chunks([{"id": "p1", "image": b"\x89PNG fake", "mimetype": "image/png"}])
    cat.add_queries([{"id": 10, "contents": "q text hit"}, {"id": 11, "contents": "q image hit"},
                     {"id": 12, "contents": "q no hit"}])
    for qid in (10, 11, 12):
        cat.add_retrieval_gt(qid, or_all_mixed([text_gt(1), image_gt("p1")]))
    pid = cat.get_or_create_pipeline("p_mixed")
    cat.add_retrieved_results(pid, [(10, 1, 0.9)], unit="chunk")
    cat.add_retrieved_results(pid, [(11, "p1", 0.8)], unit="image_chunk")
    cat.add_retrieved_results(pid, [(12, 1, 0.0)], unit="chunk")
    summary = RetrievalEvaluationService(cat).evaluate(pid, "recall", retrieval_recall)
    rows = cat.connect().execute(
        "SELECT query_id, value FROM evaluation_result WHERE pipeline_id=? AND metric_id=?",
        (pid, summary.metric_id),
    ).fetchall()
    assert {r["query_id"]: r["value"] for r in rows} == {10: 1.0, 11: 1.0, 12: 1.0}


def test_kill_between_batches_resumes_exactly_once(tmp_path):
    cat = Catalog(tmp_path / "cr.db", embedding_dim=8)
    n = 10
    cat.add_chunks([{"id": i, "contents": f"c{i}"} for i in range(1, n + 1)])
    cat.add_queries([{"id": i, "contents": f"q{i}"} for i in range(1, n + 1)])
    for i in range(1, n + 1):
        cat.add_retrieval_gt(i, i)
    pid = cat.get_or_create_pipeline("crash_eval")
    cat.add_retrieved_results(pid, [(i, i, 0.9) for i in range(1, n + 1)])
    calls = {"batches": 0}

    def crashing_metric(inputs):
        calls["batches"] += 1
        if calls["batches"] == 2:
            raise RuntimeError("simulated crash mid-evaluate")
        return [1.0] * len(inputs)

    with pytest.raises(RuntimeError):
        RetrievalEvaluationService(cat).evaluate(pid, "crash_recall", crashing_metric,
                                                 batch_size=4)
    mid = cat.get_or_create_metric("crash_recall", "retrieval")
    persisted = cat.get_evaluated_query_ids(pid, mid)
    assert len(persisted) == 4
    seen = []

    def recording_metric(inputs):
        seen.extend(mi.retrieved_ids[0] for mi in inputs)
        return [1.0] * len(inputs)

    fresh = RetrievalEvaluationService(Catalog(tmp_path / "cr.db"))
    summary = fresh.evaluate(pid, "crash_recall", recording_metric, batch_size=4)
    assert summary.count == n and summary.average == 1.0
    assert len(seen) == n - len(persisted) == len(set(seen))


def test_retrieval_metric_inputs_equal_jax(evaluated, catalog):
    """Both result tables prefixed and merged by score, AND/OR GT and graded
    relevance: the same MetricInput from both packages."""
    from autorag_research_tpu.evaluation.service import (
        RetrievalEvaluationService as JService,
    )

    cat, pid = evaluated
    cat.add_retrieved_results(pid, [(1, 4, 0.95), (2, 2, 0.1)])
    jpid = catalog.get_or_create_pipeline("p_eval")
    catalog.add_retrieved_results(jpid, [(1, 1, 0.9), (2, 5, 0.8), (3, 3, 0.7),
                                         (1, 4, 0.95), (2, 2, 0.1)])
    for qid in (1, 2, 3):
        got = RetrievalEvaluationService(cat).build_metric_input(cat.get_query(qid), pid)
        ref = JService(catalog).build_metric_input(catalog.get_query(qid), jpid)
        assert got.__dict__ == ref.__dict__


def test_generation_evidence_resolution_order(tcat):
    pid = tcat.get_or_create_pipeline("gen_eval")
    service = GenerationEvaluationService(tcat)
    tcat.add_retrieved_results(pid, [(1, 5, 0.9)])
    tcat.add_executor_result(1, pid, "answer", result_metadata={"context_chunk_ids": [2]})
    mi = service.build_metric_input(tcat.get_query(1), pid)
    assert mi.retrieved_contents == [tcat.get_chunk_contents([2])[2]]
    tcat.add_executor_result(2, pid, "answer2", result_metadata={})
    tcat.add_retrieved_results(pid, [(2, 4, 0.9)])
    mi2 = service.build_metric_input(tcat.get_query(2), pid)
    assert mi2.retrieved_contents == [tcat.get_chunk_contents([4])[4]]
    tcat.add_executor_result(3, pid, "answer3", result_metadata={"retrieved_chunk_ids": [1]})
    mi3 = service.build_metric_input(tcat.get_query(3), pid)
    assert mi3.retrieved_contents == [tcat.get_chunk_contents([1])[1]]


def test_generation_gt_parsed(tcat):
    pid = tcat.get_or_create_pipeline("gen_eval2")
    tcat.add_executor_result(1, pid, "topic zero answer")
    mi = GenerationEvaluationService(tcat).build_metric_input(tcat.get_query(1), pid)
    assert mi.generation_gt == ["topic zero"]
    assert mi.generated_texts == "topic zero answer"


def test_scalar_generation_gt_wraps_as_single_answer(tcat):
    pid = tcat.get_or_create_pipeline("gt_scalar")
    service = GenerationEvaluationService(tcat)
    for qid, raw in ((1, "2019"), (2, "0"), (3, '"Paris"')):
        tcat.connect().execute("UPDATE query SET generation_gt=? WHERE id=?", (raw, qid))
        tcat.add_executor_result(qid, pid, "an answer", result_metadata={})
    assert service.build_metric_input(tcat.get_query(1), pid).generation_gt == ["2019"]
    assert service.build_metric_input(tcat.get_query(2), pid).generation_gt == ["0"]
    assert service.build_metric_input(tcat.get_query(3), pid).generation_gt == ['"Paris"']


def test_empty_context_chunk_ids_is_no_evidence(tcat):
    pid = tcat.get_or_create_pipeline("empty_ev")
    tcat.add_retrieved_results(pid, [(1, 5, 0.9)])
    tcat.add_executor_result(1, pid, "no-context answer", result_metadata={"context_chunk_ids": []})
    mi = GenerationEvaluationService(tcat).build_metric_input(tcat.get_query(1), pid)
    assert mi.retrieved_contents is None


def test_stringified_int_ids_resolve_and_dedup(tcat):
    pid = tcat.get_or_create_pipeline("str_ids")
    tcat.add_executor_result(1, pid, "a",
                             result_metadata={"context_chunk_ids": ["2", "1", "2", None]})
    mi = GenerationEvaluationService(tcat).build_metric_input(tcat.get_query(1), pid)
    lookup = tcat.get_chunk_contents([2, 1])
    assert mi.retrieved_contents == [lookup[2], lookup[1]]


def test_generation_metric_inputs_equal_jax(tcat, catalog):
    from autorag_research_tpu.evaluation.service import (
        GenerationEvaluationService as JService,
    )

    meta = {1: {"context_chunk_ids": ["3", 1]}, 2: {}, 3: {"retrieved_chunk_ids": [5]}}
    for cat, service in ((tcat, GenerationEvaluationService), (catalog, JService)):
        pid = cat.get_or_create_pipeline("gen_eq")
        cat.add_retrieved_results(pid, [(2, 4, 0.9), (2, 1, 0.4)])
        for qid, m in meta.items():
            cat.add_executor_result(qid, pid, f"answer {qid}", result_metadata=m)
    got = [GenerationEvaluationService(tcat).build_metric_input(
        tcat.get_query(q), tcat.get_pipeline("gen_eq")["id"]) for q in meta]
    ref = [JService(catalog).build_metric_input(
        catalog.get_query(q), catalog.get_pipeline("gen_eq")["id"]) for q in meta]
    assert [g.__dict__ for g in got] == [r.__dict__ for r in ref]
