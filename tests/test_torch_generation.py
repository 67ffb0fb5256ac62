"""``basic_rag`` through both packages on copies of one SQLite catalog.

``tests/test_generation_pipeline.py``'s four cases (rows, resume, failure
isolation, a crash between inserts), both ``Executor``s with generation
metrics over real decoders (``JaxLM`` and ``TorchLM`` on the same weights,
carried by a ``JaxLM.save`` checkpoint), the CLI's ``run`` with the
``basic_rag`` template and a ``torch_lm`` / ``jax_lm`` model file, and both
``ServingHandle``s on ``/generate`` (``tests/test_serving.py``'s generation
cases). The port runs on the CPU (``BuildContext(device="cpu")``,
``device="cpu"``). Result rows, texts, token usage, evidence ids and metric
averages must be equal: the decoders here are small enough (hidden 32, f32)
that their greedy texts agree exactly on these prompts, which
``tests/test_torch_llm.py`` checks step by step with its near-tie rule.
Every HTTP call and batcher wait times out in 10 s.
"""

import importlib
import json
import shutil
import sqlite3
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import yaml

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)
TIMEOUT = 10
SMALL = dict(hidden=32, layers=2, heads=2, max_len=256)
DOCS = [
    "Paris is the capital of France",
    "Berlin is the capital of Germany",
    "GPUs accelerate matrix multiplication",
    "BM25 ranks by term rarity",
]
GEN_METRICS = ("exact_match", "token_f1", "bleu", "rouge", "meteor")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _kw(pkg):
    return {"device": "cpu"} if pkg == TORCH else {}


def _ctx(pkg, **kw):
    return _mod(pkg, "config").BuildContext(**_kw(pkg), **kw)


@pytest.fixture(autouse=True)
def clear_cache():
    for pkg in PKGS:
        _mod(pkg, "index.registry").invalidate()
    yield
    for pkg in PKGS:
        _mod(pkg, "index.registry").invalidate()


def copies(tmp_path, build):
    """``build(Catalog)`` once with the port's catalog, then one copy of the
    file per package, opened by that package's ``Catalog``."""
    src = tmp_path / "src.db"
    cat = _mod(TORCH, "store.catalog").Catalog(src)
    build(cat)
    cat.close()
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir(exist_ok=True)
        shutil.copy(src, tmp_path / pkg / "gen.db")
        out[pkg] = _mod(pkg, "store.catalog").Catalog(tmp_path / pkg / "gen.db")
    return out


def _gen_catalog(cat):
    """``tests/test_generation_pipeline.py``'s catalog."""
    cat.add_chunks([
        {"id": 0, "contents": "Paris is the capital of France."},
        {"id": 1, "contents": "Berlin is the capital of Germany."},
        {"id": 2, "contents": "The mitochondria is the powerhouse of the cell."},
    ])
    cat.add_queries([
        {"id": 0, "contents": "capital of France", "generation_gt": ["Paris"]},
        {"id": 1, "contents": "capital of Germany", "generation_gt": ["Berlin"]},
    ])
    cat.add_retrieval_gt(0, 0)
    cat.add_retrieval_gt(1, 1)


def answering_llm(prompt: str) -> str:
    question = prompt.split("Question:")[-1]
    if "France" in question:
        return "Paris"
    if "Germany" in question:
        return "Berlin"
    return "unknown"


def executor_rows(cat, pipeline_id):
    """Every executor row of a pipeline, by query, as stored."""
    with sqlite3.connect(cat.path) as conn:
        rows = conn.execute(
            "SELECT query_id, generation_result, token_usage, result_metadata FROM executor_result "
            "WHERE pipeline_id = ? ORDER BY query_id", (pipeline_id,)).fetchall()
    return [(q, text, json.loads(usage), json.loads(meta)) for q, text, usage, meta in rows]


def retrieved_rows(cat, pipeline_id, qids):
    return {q: [(r["doc_id"], r["rel_score"]) for r in cat.get_retrieved(q, pipeline_id)]
            for q in qids}


def assert_retrieved_equal(got, ref):
    """Retrieved rows by query: ids and order equal, scores within 1e-5
    relative (BM25's within 1e-6, the dense legs' cosine within 1e-5, as in
    ``tests/test_torch_serving.py``)."""
    assert got.keys() == ref.keys()
    for q in ref:
        assert [d for d, _ in got[q]] == [d for d, _ in ref[q]], q
        np.testing.assert_allclose([s for _, s in got[q]], [s for _, s in ref[q]], rtol=1e-5)


def _config(pkg, llm, metrics=("recall", "exact_match", "token_f1"), **kw):
    cfg = _mod(pkg, "config")
    rag = _mod(pkg, "pipelines.generation.basic_rag").BasicRAGConfig(
        name="rag", retrieval_pipeline_name="bm25", llm=llm, **{"top_k": 2, **kw})
    return cfg.ExecutorConfig(
        pipelines=[rag],
        metrics=[cfg.BaseMetricConfig(name=m, metric_type="retrieval" if m == "recall"
                                      else "generation") for m in metrics],
        health_check=False,
    )


def _bm25(pkg):
    return {"bm25": _mod(pkg, "pipelines.retrieval.bm25").BM25Config(name="bm25")}


# ------------------------------------------- tests/test_generation_pipeline.py


def test_basic_rag_end_to_end(tmp_path):
    cats = copies(tmp_path, _gen_catalog)
    out = {}
    for pkg, cat in cats.items():
        llm = _mod(pkg, "llm").MockLLM(responder=answering_llm)
        result = _mod(pkg, "executor").Executor(
            cat, _config(pkg, llm), _ctx(pkg, pipeline_configs=_bm25(pkg))).run()
        assert result.success, result.report()
        pres = result.pipelines[0]
        metrics = {m.metric_name: (m.average, m.count) for m in pres.metrics}
        pid = pres.stats["pipeline_id"]
        out[pkg] = (metrics, executor_rows(cat, pid), retrieved_rows(cat, pid, [0, 1]))
    assert out[TORCH][:2] == out[JAX][:2]
    assert_retrieved_equal(out[TORCH][2], out[JAX][2])
    metrics, rows, _ = out[TORCH]
    assert set(metrics) == {"recall", "exact_match", "token_f1"}
    assert metrics["exact_match"][0] == 1.0 and metrics["recall"][0] == 1.0
    assert rows[0][1] == "Paris" and 0 in rows[0][3]["context_chunk_ids"]
    assert rows[0][2]["total_tokens"] > 0


def test_generation_resume(tmp_path):
    cats = copies(tmp_path, _gen_catalog)
    for pkg, cat in cats.items():
        Executor = _mod(pkg, "executor").Executor
        llm = _mod(pkg, "llm").MockLLM(responder=answering_llm)
        assert Executor(cat, _config(pkg, llm), _ctx(pkg, pipeline_configs=_bm25(pkg))).run().success
        _mod(pkg, "index.registry").invalidate()
        r2 = Executor(cat, _config(pkg, llm), _ctx(pkg, pipeline_configs=_bm25(pkg))).run()
        assert r2.pipelines[0].stats["total_queries"] == 0  # all resumed


def test_generation_failure_isolation(tmp_path):
    cats = copies(tmp_path, _gen_catalog)
    out = {}
    for pkg, cat in cats.items():
        cfg = _mod(pkg, "config")
        llm = _mod(pkg, "llm").ScriptedLLM(responses=["only one answer"])
        config = cfg.ExecutorConfig(
            pipelines=[_mod(pkg, "pipelines.generation.basic_rag").BasicRAGConfig(
                name="rag_fail", retrieval_pipeline_name="bm25", llm=llm, top_k=1,
                max_retries=1)],
            metrics=[], health_check=False, max_retries=0)
        pres = _mod(pkg, "executor").Executor(
            cat, config, _ctx(pkg, pipeline_configs=_bm25(pkg))).run().pipelines[0]
        assert not pres.success
        out[pkg] = (pres.stats["failed_queries"], pres.stats["total_queries"],
                    executor_rows(cat, pres.stats["pipeline_id"]))
    assert out[TORCH] == out[JAX]
    assert len(out[TORCH][0]) == 1 and out[TORCH][1] == 1  # the good one persisted


def test_crash_between_inserts_does_not_contaminate_resume(tmp_path):
    """A crash after the retrieved rows commit but before the executor
    result leaves the query pending; the resumed attempt's doc set replaces
    the stale rows in both packages."""
    cats = copies(tmp_path, _gen_catalog)
    for pkg, cat in cats.items():
        bm25 = _mod(pkg, "pipelines.retrieval.bm25").BM25Pipeline(cat, "bm25_crash", **_kw(pkg))
        rag = _mod(pkg, "pipelines.generation.basic_rag").BasicRAGPipeline(
            cat, "rag_crash", retrieval_pipeline=bm25,
            llm=_mod(pkg, "llm").MockLLM(responder=lambda p: "Paris"))
        pid = rag.pipeline_id
        cat.add_retrieved_results(pid, [(0, 2, 0.9), (0, 1, 0.8)])
        assert cat.get_executor_result(0, pid) is None
        assert rag.run(top_k=1)["failed_queries"] == []
        assert [r["doc_id"] for r in cat.get_retrieved(0, pid, "chunk")] == [0]


# ------------------------------------------- real decoders through the Executor


@pytest.fixture
def lm_checkpoint(tmp_path):
    """A ``JaxLM.save`` checkpoint at ``SMALL``: the weights both decoders run."""
    from autorag_research_tpu.llm import JaxLM
    from autorag_research_tpu.models.decoder import DecoderConfig

    path = str(tmp_path / "lm.npz")
    JaxLM(config=DecoderConfig(**SMALL), max_prompt_len=192, max_new_tokens=24, seed=3).save(path)
    return path


def make_lm(pkg, checkpoint, prompt=192, new=24):
    if pkg == JAX:
        from autorag_research_tpu.llm import JaxLM
        from autorag_research_tpu.models.decoder import DecoderConfig

        return JaxLM(config=DecoderConfig(**SMALL), max_prompt_len=prompt, max_new_tokens=new,
                     checkpoint=checkpoint)
    from autorag_research_tpu_torch.llm import TorchLM
    from autorag_research_tpu_torch.models.decoder import DecoderConfig

    return TorchLM(DecoderConfig(**SMALL), max_prompt_len=prompt, max_new_tokens=new,
                   checkpoint=checkpoint, device="cpu")


def _synthetic(cat, n_docs=60, n_queries=8):
    ing = _mod(TORCH, "data.synthetic").SyntheticIngestor(
        embedding_model=_mod(TORCH, "embeddings").MockEmbedding(dim=16), n_docs=n_docs,
        n_queries=n_queries, seed=5)
    ing.set_service(_mod(TORCH, "store.ingestion").IngestionService(cat))
    ing.ingest()
    ing.embed_all()


@pytest.mark.parametrize("leg", ["bm25", "vector_search"])
def test_executors_with_generation_metrics_on_real_decoders(tmp_path, lm_checkpoint, leg):
    """``basic_rag`` with ``TorchLM`` / ``JaxLM`` on one checkpoint through
    both ``Executor``s, health check on: rows, texts, token usage, evidence,
    retrieval rows and every metric average equal."""
    cats = copies(tmp_path, _synthetic)
    out = {}
    for pkg, cat in cats.items():
        cfg = _mod(pkg, "config")
        legs = {
            "bm25": _mod(pkg, "pipelines.retrieval.bm25").BM25Config(name="bm25"),
            "vector_search": _mod(pkg, "pipelines.retrieval.vector_search").VectorSearchConfig(
                name="vector_search",
                embedding_model=_mod(pkg, "embeddings").MockEmbedding(dim=16)),
        }
        rag = _mod(pkg, "pipelines.generation.basic_rag").BasicRAGConfig(
            name="rag", retrieval_pipeline_name=leg, llm=make_lm(pkg, lm_checkpoint), top_k=3,
            max_concurrency=4)
        config = cfg.ExecutorConfig(
            pipelines=[rag],
            metrics=[cfg.BaseMetricConfig(name="recall"),
                     *[cfg.BaseMetricConfig(name=m, metric_type="generation")
                       for m in GEN_METRICS]],
            health_check=True, health_check_queries=2)
        result = _mod(pkg, "executor").Executor(
            cat, config, _ctx(pkg, pipeline_configs={leg: legs[leg]})).run()
        assert result.success, result.report()
        pres = result.pipelines[0]
        assert all(m.success for m in pres.metrics), result.report()
        pid = pres.stats["pipeline_id"]
        qids = cat.get_all_query_ids()
        out[pkg] = ({m.metric_name: (m.average, m.count) for m in pres.metrics},
                    executor_rows(cat, pid), retrieved_rows(cat, pid, qids), pres.stats)
        assert cat.get_pipeline("rag_health_check") is None
    assert out[TORCH][1] == out[JAX][1]  # texts, usage and evidence first
    assert out[TORCH][0] == out[JAX][0] and out[TORCH][3] == out[JAX][3]
    assert_retrieved_equal(out[TORCH][2], out[JAX][2])
    metrics, rows, _, stats = out[TORCH]
    assert set(metrics) == {"recall", *GEN_METRICS}
    assert len(rows) == stats["total_queries"] == 8
    for _, text, usage, meta in rows:
        assert usage["completion_tokens"] <= 24 and len(meta["context_chunk_ids"]) == 3


def test_basic_rag_batch_path_equals_single_path(tmp_path, lm_checkpoint):
    """``generate_batch_by_texts`` (the serving path: one batched retrieval,
    one batched decode) gives each query the text, usage and evidence of the
    single-query ``_generate``, in both packages and across them."""
    cats = copies(tmp_path, _synthetic)
    out = {}
    for pkg, cat in cats.items():
        bm25 = _mod(pkg, "pipelines.retrieval.bm25").BM25Pipeline(cat, "bm25", **_kw(pkg))
        rag = _mod(pkg, "pipelines.generation.basic_rag").BasicRAGPipeline(
            cat, "rag", retrieval_pipeline=bm25, llm=make_lm(pkg, lm_checkpoint))
        texts = [r["contents"] for r in cat.get_queries()]
        batch = rag.generate_batch_by_texts(texts, 3)
        run_async = _mod(pkg, "utils.concurrency").run_async
        single = [run_async(rag._generate(q, 3)) for q in cat.get_all_query_ids()]
        rows = [(r.text, r.token_usage, r.metadata["context_chunk_ids"]) for r in batch]
        assert rows == [(r.text, r.token_usage, r.metadata["context_chunk_ids"]) for r in single]
        out[pkg] = rows
    assert out[TORCH] == out[JAX]


# ----------------------------------------------------------------- the CLI


def test_cli_run_basic_rag_with_torch_lm(tmp_path, monkeypatch, lm_checkpoint):
    """``init``, ``ingest`` and ``run`` through both CLIs with the template's
    ``basic_rag.yaml`` pointed at ``llm: torch_lm`` (the JAX tree at
    ``jax_lm``), both model files loading the same checkpoint: the same
    executor rows and metric averages."""
    from autorag_research_tpu.cli.app import main as jax_main
    from autorag_research_tpu_torch.cli.app import main as torch_main

    mains = {JAX: jax_main, TORCH: lambda argv: torch_main(["--device", "cpu", *argv])}
    out = {}
    for pkg, main in mains.items():
        root = tmp_path / f"cli_{pkg}"
        root.mkdir()
        monkeypatch.chdir(root)
        assert main(["init"]) == 0
        configs = root / "configs"
        kind = "torch_lm" if pkg == TORCH else "jax_lm"
        spec = yaml.safe_load((configs / "llm" / f"{kind}.yaml").read_text())
        spec.update(SMALL, max_prompt_len=192, max_new_tokens=24, checkpoint=lm_checkpoint)
        (configs / "llm" / f"{kind}.yaml").write_text(yaml.safe_dump(spec))
        rag = yaml.safe_load((configs / "pipelines" / "generation" / "basic_rag.yaml").read_text())
        assert rag == {"type": "basic_rag", "retrieval_pipeline_name": "vector_search",
                       "llm": "mock", "top_k": 5}
        rag["llm"] = kind
        (configs / "pipelines" / "generation" / "basic_rag.yaml").write_text(yaml.safe_dump(rag))
        (configs / "experiment.yaml").write_text(yaml.safe_dump({
            "pipelines": {"retrieval": ["vector_search"], "generation": ["basic_rag"]},
            "metrics": {"retrieval": ["recall"], "generation": list(GEN_METRICS)},
            "executor": {"health_check": True, "health_check_queries": 2},
        }))
        assert main(["ingest", "--name", "synthetic", "--db", "ws", "--extra", "n_docs=60",
                     "--extra", "n_queries=6", "--embedding-model", "mock"]) == 0
        assert main(["run", "--db", "ws"]) == 0
        cat = _mod(pkg, "store.catalog").Catalog(root / "ws" / "catalog.db")
        pid = cat.get_pipeline("basic_rag")["id"]
        with sqlite3.connect(cat.path) as conn:
            avgs = conn.execute(
                "SELECT p.name, m.name, AVG(e.value), COUNT(e.value) FROM evaluation_result e "
                "JOIN pipeline p ON p.id = e.pipeline_id JOIN metric m ON m.id = e.metric_id "
                "GROUP BY p.name, m.name ORDER BY p.name, m.name").fetchall()
        out[pkg] = (executor_rows(cat, pid), avgs)
        cat.close()
    assert out[TORCH] == out[JAX]
    rows, avgs = out[TORCH]
    assert len(rows) == 6
    assert {m for p, m, _, _ in avgs if p == "basic_rag"} == {"recall", *GEN_METRICS}


# ----------------------------------------------------------------- serving


def post(handle, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{handle.port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def both(hs, path, payload):
    """The same request to both handles; equal codes and bodies."""
    (cj, dj), (ct, dt) = post(hs[JAX], path, payload), post(hs[TORCH], path, payload)
    assert (ct, dt) == (cj, dj)
    return ct, dt


def _docs(cat):
    cat.add_chunks([{"id": i, "contents": d} for i, d in enumerate(DOCS)])
    cat.add_queries([{"id": 0, "contents": "capital of France"}])


def rag_handles(cats, llm_for, window=10, name="basic_rag", retriever="bm25"):
    out = {}
    for pkg, cat in cats.items():
        if retriever == "bm25":
            leg = _mod(pkg, "pipelines.retrieval.bm25").BM25Pipeline(cat, "bm25_serve",
                                                                     **_kw(pkg))
        else:
            leg = _mod(pkg, "pipelines.retrieval.vector_search").VectorSearchPipeline(
                cat, "vs_serve", embedding_model=_mod(pkg, "embeddings").MockEmbedding(dim=16),
                **_kw(pkg))
        rag = _mod(pkg, "pipelines.generation.basic_rag").BasicRAGPipeline(
            cat, "rag_serve", retrieval_pipeline=leg, llm=llm_for(pkg))
        out[pkg] = _mod(pkg, "serving.server").ServingHandle(
            cat, {retriever: leg}, {name: rag}, batch_window_ms=window).start(port=0)
    return out


def warm(hs, name, queries, top_k):
    """One request's micro-batch, padded to its power-of-two bucket as the
    batcher pads it, through each handle's generation pipeline ``name``
    directly, before the HTTP calls: a fresh JAX pipeline compiles on its
    first search and decode of each shape (seconds on an idle host, past
    TIMEOUT on a loaded one), which no timed request should wait for."""
    bucket = 1 << (len(queries) - 1).bit_length()
    batch = list(queries) + [queries[-1]] * (bucket - len(queries))
    for h in hs.values():
        h.generation_pipelines[name].generate_batch_by_texts(batch, top_k)


def _answering(pkg):
    return _mod(pkg, "llm").MockLLM(responder=lambda p: "Paris" if "France" in p else "unknown")


@pytest.fixture
def handles(tmp_path):
    hs = rag_handles(copies(tmp_path, _docs), _answering)
    for h in hs.values():  # the JAX pipeline's first compiles, as in warm()
        h.warmup(max_bucket=2, top_k=5, gen_max_bucket=2, gen_top_k=5)
    yield hs
    for h in hs.values():
        h.stop()


def test_generate_known_and_adhoc(handles):
    code, data = both(handles, "/generate", {"query": "capital of France"})
    assert code == 200 and data["text"] == "Paris"
    for h in handles.values():
        before = h.catalog.count("query")
    code, data = both(handles, "/generate", {"query": "what is the capital of France?"})
    assert code == 200 and data["text"] == "Paris"
    for h in handles.values():
        assert h.catalog.count("query") == before


def test_generate_batched_endpoint(handles):
    code, data = both(handles, "/generate",
                      {"queries": ["capital of France", "something else entirely"]})
    assert code == 200
    assert [r["text"] for r in data["results"]] == ["Paris", "unknown"]
    assert all("context_chunk_ids" in r["metadata"] for r in data["results"])


def test_generate_error_paths(handles):
    code, data = both(handles, "/generate", {"query": "x", "pipeline": "nope"})
    assert code == 400


def test_generate_batch_uses_batch_llm(tmp_path):
    """A batch-capable LLM gets one ``generate_batch`` call for a coalesced
    micro-batch, not one ``agenerate`` a query, in both packages."""
    cats = copies(tmp_path, _docs)
    calls = {pkg: [] for pkg in PKGS}

    def batch_llm(pkg):
        class BatchLLM(_mod(pkg, "llm").MockLLM):
            def generate_batch(self, prompts):
                calls[pkg].append(len(prompts))
                return ["ans"] * len(prompts)

        return BatchLLM()

    hs = rag_handles(cats, batch_llm, name="rag")
    try:
        for pkg, h in hs.items():
            out = h.generate_batch(["q one", "q two", "q three"], top_k=2)
            assert [r["text"] for r in out] == ["ans"] * 3
            assert sum(calls[pkg]) >= 3 and len(calls[pkg]) <= 2, calls
    finally:
        for h in hs.values():
            h.stop()


def test_adhoc_generate_with_dense_retriever(tmp_path):
    """Ad-hoc ``/generate`` with a dense leg: the staged query has no
    embedding, so the pipeline falls back to text retrieval."""

    def build(cat):
        emb = _mod(TORCH, "embeddings").MockEmbedding(dim=16)
        cat.add_chunks([{"id": i, "contents": d, "embedding": emb.embed_query(d)}
                        for i, d in enumerate(DOCS)])

    src = tmp_path / "src.db"
    cat = _mod(TORCH, "store.catalog").Catalog(src, embedding_dim=16)
    build(cat)
    cat.close()
    cats = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        shutil.copy(src, tmp_path / pkg / "gen.db")
        cats[pkg] = _mod(pkg, "store.catalog").Catalog(tmp_path / pkg / "gen.db", embedding_dim=16)
    hs = rag_handles(cats, lambda pkg: _mod(pkg, "llm").MockLLM(responder=lambda p: "ok"),
                     name="rag", retriever="vs")
    try:
        code, data = both(hs, "/generate", {"query": "brand new ad hoc question"})
        assert code == 200 and data["text"] == "ok"
    finally:
        for h in hs.values():
            h.stop()


def test_generate_mixed_top_k_not_coalesced(tmp_path):
    """Two concurrent ``/generate`` requests with different ``top_k`` run at
    their own k through ``basic_rag`` in both packages."""
    cats = copies(tmp_path, _docs)
    hs = rag_handles(cats, lambda pkg: _mod(pkg, "llm").MockLLM(), window=50, name="rag")
    try:
        for h in hs.values():
            h.generate_batch(["warm"], top_k=1)  # the first batch runs alone
            results = {}

            def call(k, h=h, results=results):
                results[k] = post(h, "/generate", {"query": "capital of France", "top_k": k})

            threads = [threading.Thread(target=call, args=(k,)) for k in (1, 3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            assert results[1][0] == 200 and results[3][0] == 200
            assert len(results[1][1]["metadata"]["context_chunk_ids"]) == 1
            assert len(results[3][1]["metadata"]["context_chunk_ids"]) >= 2
    finally:
        for h in hs.values():
            h.stop()


def test_generate_with_real_decoders(tmp_path, lm_checkpoint):
    """``/generate`` over ``TorchLM`` and ``JaxLM`` on one checkpoint: single
    and batched requests give the same bodies in both packages, and the
    served rows equal the pipeline's direct single-query calls (texts and
    token usage)."""
    cats = copies(tmp_path, _docs)
    hs = rag_handles(cats, lambda pkg: make_lm(pkg, lm_checkpoint), name="rag")
    try:
        queries = ["capital of France", "capital of Germany", "what ranks by rarity?"]
        for batch in (queries, *([q] for q in queries)):
            warm(hs, "rag", batch, 2)
        code, data = both(hs, "/generate", {"queries": queries, "top_k": 2})
        assert code == 200
        for q in queries:
            code, one = both(hs, "/generate", {"query": q, "top_k": 2})
            assert code == 200
        rag = hs[TORCH].generation_pipelines["rag"]
        for q, row in zip(queries, data["results"]):
            direct = rag.generate_batch_by_texts([q], 2)[0]
            assert (row["text"], row["token_usage"]) == (direct.text, direct.token_usage)
            assert row["token_usage"]["prompt_tokens"] <= 192
    finally:
        for h in hs.values():
            h.stop()


def test_serve_workspace_generation_from_config_tree(tmp_path, monkeypatch, lm_checkpoint):
    """``serve_workspace(..., generation=["basic_rag"])`` from an ``init``
    tree whose ``basic_rag`` names ``torch_lm`` (``jax_lm`` in the JAX tree):
    ``warmup`` covers the decode buckets and ``/generate`` answers as the
    JAX package's does."""
    from autorag_research_tpu.cli.app import main as jax_main
    from autorag_research_tpu_torch.cli.app import main as torch_main

    hs = {}
    try:
        for pkg, main in ((JAX, jax_main), (TORCH, lambda a: torch_main(["--device", "cpu", *a]))):
            root = tmp_path / f"serve_{pkg}"
            root.mkdir()
            monkeypatch.chdir(root)
            assert main(["init"]) == 0
            kind = "torch_lm" if pkg == TORCH else "jax_lm"
            configs = root / "configs"
            (configs / "llm" / f"{kind}.yaml").write_text(yaml.safe_dump({
                "type": kind, **SMALL, "max_prompt_len": 192, "max_new_tokens": 24,
                "checkpoint": lm_checkpoint}))
            (configs / "pipelines" / "generation" / "basic_rag.yaml").write_text(yaml.safe_dump({
                "type": "basic_rag", "retrieval_pipeline_name": "bm25", "llm": kind, "top_k": 3}))
            assert main(["ingest", "--name", "synthetic", "--db", "ws", "--extra", "n_docs=60",
                         "--extra", "n_queries=6"]) == 0
            hs[pkg] = _mod(pkg, "serving.server").serve_workspace(
                str(root / "ws"), config_path=str(configs), retrieval=["bm25"],
                generation=["basic_rag"], port=0, **_kw(pkg))
        hs[TORCH].warmup(max_bucket=2, gen_max_bucket=2, gen_top_k=3)
        cat = _mod(TORCH, "store.catalog").Catalog(tmp_path / f"serve_{TORCH}" / "ws" / "catalog.db")
        queries = [r["contents"] for r in cat.get_queries(limit=4)]
        cat.close()
        warm(hs, "basic_rag", queries, 3)
        code, data = both(hs, "/generate", {"queries": queries, "top_k": 3})
        assert code == 200 and len(data["results"]) == 4
        assert all(len(r["metadata"]["context_chunk_ids"]) <= 3 for r in data["results"])
    finally:
        for h in hs.values():
            h.stop()
