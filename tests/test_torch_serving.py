"""The port's serving layer against the JAX package's, case by case with
``tests/test_serving.py``'s retrieval and metrics cases.

Each case serves the same pipelines of both packages over copies of one
SQLite catalog (the port's on the CPU) and sends both handles the same
requests: the hits agree as JSON (ids, contents and order equal; BM25
scores within 1e-6 relative, cosine scores within 1e-5, as in
``tests/test_torch_slice_bm25.py`` and ``tests/test_torch_slice.py``), and
the status codes and error texts are the same. A stub pipeline with the
generation interface covers the generation batcher's grouping by ``top_k``
in the port. Every wait on a batcher or an HTTP call has a timeout of a few
seconds.

``test_serving_with_mesh_sharded_index`` serves a corpus sharded over 8
virtual CPU devices (JAX) and over the CPU listed 8 times (the port).

The generation cases (``test_generate_known_and_adhoc``,
``test_generate_batched_endpoint``, ``test_generate_batch_uses_batch_llm``,
``test_adhoc_generate_with_dense_retriever``, the LLM half of
``test_generate_mixed_top_k_not_coalesced``) run against both packages'
``basic_rag`` in ``tests/test_torch_generation.py``.
"""

import importlib
import json
import shutil
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass

import numpy as np
import pytest

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)
TIMEOUT = 10  # seconds for every HTTP call and every wait on a batcher
DOCS = [
    "Paris is the capital of France",
    "Berlin is the capital of Germany",
    "GPUs accelerate matrix multiplication",
    "BM25 ranks by term rarity",
]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _kw(pkg):
    """Constructor keywords of a port pipeline: the CPU."""
    return {"device": "cpu"} if pkg == TORCH else {}


@pytest.fixture(autouse=True)
def clear_cache():
    for pkg in PKGS:
        _mod(pkg, "index.registry").invalidate()
    yield
    for pkg in PKGS:
        _mod(pkg, "index.registry").invalidate()


def copies(tmp_path, build):
    """``build(Catalog, path)`` once, then one copy of the file per package."""
    src = tmp_path / "src.db"
    cat = _mod(TORCH, "store.catalog").Catalog(src)
    build(cat)
    cat.close()
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        shutil.copy(src, tmp_path / pkg / "serve.db")
        out[pkg] = _mod(pkg, "store.catalog").Catalog(tmp_path / pkg / "serve.db")
    return out


def _docs(cat):
    cat.add_chunks([{"id": i, "contents": d} for i, d in enumerate(DOCS)])
    cat.add_queries([{"id": 0, "contents": "capital of France"}])


def _embedded_docs(n, dim):
    def build(cat):
        cat.add_chunks([{"id": i, "contents": f"document {i}"} for i in range(n)])
        _mod(TORCH, "store.ingestion").IngestionService(cat).embed_all(
            _mod(TORCH, "embeddings").MockEmbedding(dim=dim), batch_size=16)

    return build


@dataclass
class _GenResult:
    text: str
    token_usage: dict
    metadata: dict


class StubGeneration:
    """The generation interface the batcher serves: answers name the k they
    were asked with, and every batched call is recorded."""

    def __init__(self):
        self.calls: list[tuple[int, int]] = []

    def generate_batch_by_texts(self, queries, top_k):
        self.calls.append((len(queries), top_k))
        return [_GenResult(f"{q}@{top_k}", {"total": 1}, {"context_chunk_ids": list(range(top_k))})
                for q in queries]


def serve(pkg, cat, retrieval, generation=None, **kw):
    return _mod(pkg, "serving.server").ServingHandle(cat, retrieval, generation, **kw).start(port=0)


def bm25_handles(cats, generation=None, **kw):
    out = {}
    for pkg, cat in cats.items():
        bm25 = _mod(pkg, "pipelines.retrieval.bm25").BM25Pipeline(cat, "bm25_serve", **_kw(pkg))
        out[pkg] = serve(pkg, cat, {"bm25": bm25}, generation if pkg == TORCH else None, **kw)
    return out


@pytest.fixture
def handles(tmp_path):
    hs = bm25_handles(copies(tmp_path, _docs), {"stub": StubGeneration()}, batch_window_ms=10)
    yield hs
    for h in hs.values():
        h.stop()


def post(handle, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{handle.port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(handle, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{handle.port}{path}", timeout=TIMEOUT) as r:
        return r.headers["Content-Type"], r.read().decode()


def warm(hs, name, queries, top_k):
    """One request's micro-batch, padded to its power-of-two bucket as the
    batcher pads it, through each handle's pipeline ``name`` directly, before
    the HTTP calls: a fresh JAX pipeline compiles on its first search of each
    shape (batch, query terms, k; 1-8 s on an idle host, past TIMEOUT on a
    loaded one), which no timed request should wait for."""
    bucket = 1 << (len(queries) - 1).bit_length()
    batch = list(queries) + [queries[-1]] * (bucket - len(queries))
    for h in hs.values():
        h.retrieval_pipelines[name]._retrieve_batch_by_texts(batch, top_k)


def assert_hits_equal(got, ref, rtol):
    """Two /search ``results`` lists: ids, contents and order equal, scores
    within ``rtol``."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert [(h["doc_id"], h.get("content")) for h in g] == [
            (h["doc_id"], h.get("content")) for h in r]
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in r], rtol=rtol,
                                   atol=1e-7)


def both(hs, path, payload, rtol=1e-6):
    """The same request to both handles: equal codes; equal hits (200) or
    equal errors; returns the port's response."""
    (cj, dj), (ct, dt) = post(hs[JAX], path, payload), post(hs[TORCH], path, payload)
    assert ct == cj, (dt, dj)
    if ct == 200 and "results" in dj:
        assert_hits_equal(dt["results"], dj["results"], rtol)
    else:
        assert dt == dj
    return ct, dt


def test_health(handles):
    for pkg, h in handles.items():
        data = json.loads(get(h, "/health")[1])
        assert data["status"] == "ok" and data["corpus"] == 4
        assert "bm25" in data["retrieval_pipelines"]
    assert json.loads(get(handles[TORCH], "/health")[1])["generation_pipelines"] == ["stub"]


def test_search_single_and_batch(handles):
    code, data = both(handles, "/search", {"query": "capital France", "top_k": 2})
    assert code == 200
    hits = data["results"][0]
    assert hits[0]["doc_id"] == 0 and "capital of France" in hits[0]["content"]
    code, data = both(handles, "/search", {"queries": ["GPU matrix", "term rarity"], "top_k": 1})
    assert code == 200
    assert data["results"][0][0]["doc_id"] == 2 and data["results"][1][0]["doc_id"] == 3


def test_concurrent_searches_microbatch(handles):
    queries = ["capital France", "capital Germany", "GPU matrix"] * 3
    results = {pkg: {} for pkg in PKGS}

    def worker(pkg, i, q):
        results[pkg][i] = post(handles[pkg], "/search", {"query": q, "top_k": 1})

    threads = [threading.Thread(target=worker, args=(pkg, i, q))
               for pkg in PKGS for i, q in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    for i in range(len(queries)):
        (cj, dj), (ct, dt) = results[JAX][i], results[TORCH][i]
        assert cj == ct == 200
        assert_hits_equal(dt["results"], dj["results"], 1e-6)
    assert results[TORCH][0][1]["results"][0][0]["doc_id"] == 0
    assert results[TORCH][1][1]["results"][0][0]["doc_id"] == 1


def test_error_paths(handles):
    code, data = both(handles, "/search", {"query": "x", "pipeline": "nope"})
    assert code == 400 and "unknown pipeline" in data["error"]
    code, _ = both(handles, "/nope", {})
    assert code == 404
    code, data = post(handles[TORCH], "/generate", {"query": "x", "pipeline": "nope"})
    assert code == 400


def test_microbatch_uses_single_batched_kernel_call(tmp_path):
    """One multi-query POST -> exactly one batched call with every query,
    padded to the power-of-two bucket (3 -> 4), in both packages."""
    cats = copies(tmp_path, _docs)
    calls = {pkg: [] for pkg in PKGS}
    hs = {}
    for pkg, cat in cats.items():
        base = _mod(pkg, "pipelines.retrieval.bm25").BM25Pipeline

        class CountingBM25(base):
            def _retrieve_batch_by_texts(self, texts, top_k, _calls=calls[pkg]):
                _calls.append(list(texts))
                return super()._retrieve_batch_by_texts(texts, top_k)

        hs[pkg] = serve(pkg, cat, {"bm25": CountingBM25(cat, "bm25_count", **_kw(pkg))},
                        batch_window_ms=50)
    try:
        code, data = both(hs, "/search",
                          {"queries": ["capital France", "GPU matrix", "term rarity"]})
        assert code == 200 and len(data["results"]) == 3
        for pkg in PKGS:
            assert len(calls[pkg]) == 1 and len(calls[pkg][0]) == 4
            assert calls[pkg][0][:3] == ["capital France", "GPU matrix", "term rarity"]
    finally:
        for h in hs.values():
            h.stop()


def test_serving_multi_vector_pipeline(tmp_path):
    """MaxSim behind the HTTP API: batched ``embed_texts_multi`` + one
    search per micro-batch; the self-match wins in both packages."""
    def build(cat):
        memb = _mod(TORCH, "embeddings").MockMultiVectorEmbedding(dim=16, max_tokens=4)
        cat.embedding_dim = 16
        cat.add_chunks([{"id": i, "contents": d} for i, d in enumerate(DOCS)])
        cat.set_multi_embeddings(
            "chunk", [(i, memb.embed_texts_multi([d])[0]) for i, d in enumerate(DOCS)])

    cats = copies(tmp_path, build)
    hs = {}
    for pkg, cat in cats.items():
        memb = _mod(pkg, "embeddings").MockMultiVectorEmbedding(dim=16, max_tokens=4)
        pipe = _mod(pkg, "pipelines.retrieval.vector_search").VectorSearchPipeline(
            cat, "mv_serve", search_mode="multi", embedding_model=memb, **_kw(pkg))
        hs[pkg] = serve(pkg, cat, {"maxsim": pipe}, batch_window_ms=10)
    try:
        code, data = both(hs, "/search",
                          {"queries": [DOCS[0], DOCS[2]], "top_k": 1, "pipeline": "maxsim"},
                          rtol=1e-5)
        assert code == 200
        assert data["results"][0][0]["doc_id"] == 0 and data["results"][1][0]["doc_id"] == 2
    finally:
        for h in hs.values():
            h.stop()


def test_serving_with_mesh_sharded_index(tmp_path):
    """``tests/test_serving.py``'s case: a dense corpus sharded over 8
    devices behind the HTTP API, single and batched requests, the same hits
    from both packages."""
    def build(cat):
        emb = _mod(TORCH, "embeddings").MockEmbedding(dim=16)
        cat.embedding_dim = 16
        docs = [f"unique document number {i}" for i in range(64)]
        cat.add_chunks([{"id": i, "contents": d, "embedding": emb.embed_query(d)}
                        for i, d in enumerate(docs)])

    cats = copies(tmp_path, build)
    meshes = {JAX: _mod(JAX, "parallel.mesh").corpus_mesh(n_corpus=8),
              TORCH: _mod(TORCH, "parallel.mesh").corpus_mesh(devices=["cpu"] * 8)}
    hs = {}
    for pkg, cat in cats.items():
        pipe = _mod(pkg, "pipelines.retrieval.vector_search").VectorSearchPipeline(
            cat, "vs_mesh", embedding_model=_mod(pkg, "embeddings").MockEmbedding(dim=16),
            mesh=meshes[pkg], **_kw(pkg))
        hs[pkg] = serve(pkg, cat, {"vs": pipe}, batch_window_ms=10)
    try:
        code, data = both(hs, "/search", {"query": "unique document number 42", "top_k": 3},
                          rtol=1e-5)
        assert code == 200 and data["results"][0][0]["doc_id"] == 42
        code, data = both(hs, "/search", {"queries": ["unique document number 1",
                                                      "unique document number 60"], "top_k": 1},
                          rtol=1e-5)
        assert [r[0]["doc_id"] for r in data["results"]] == [1, 60]
        assert hs[TORCH].retrieval_pipelines["vs"]._index()._sharded
    finally:
        for h in hs.values():
            h.stop()


def test_malformed_requests(handles):
    for h in handles.values():
        req = urllib.request.Request(
            f"http://127.0.0.1:{h.port}/search", data=b"{not json",
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert err.value.code == 400
    code, data = both(handles, "/search", {"top_k": 3})  # missing query field
    assert code == 400 and "error" in data
    code, _ = both(handles, "/search", {"query": "x", "top_k": "many"})
    assert code == 400
    code, _ = both(handles, "/search", {"query": "capital of France"})  # still alive
    assert code == 200


def test_zero_and_huge_top_k(handles):
    code, data = both(handles, "/search", {"query": "capital", "top_k": 0})
    assert code == 400 and "top_k" in data["error"]
    code, data = both(handles, "/search", {"query": "capital", "top_k": 10_000})
    assert code == 200 and len(data["results"][0]) <= len(DOCS)


def _dense_handles(cats, profiles, window=5):
    hs = {}
    for pkg, cat in cats.items():
        emb = _mod(pkg, "embeddings").MockEmbedding(dim=32)
        vs = _mod(pkg, "pipelines.retrieval.vector_search").VectorSearchPipeline
        pipes = {name: vs(cat, f"dense_{name}", embedding_model=emb, index_options=opts, **_kw(pkg))
                 for name, opts in profiles.items()}
        hs[pkg] = serve(pkg, cat, pipes, batch_window_ms=window)
    return hs


def test_fast_profile_serving(tmp_path):
    """The fast profile (approx + bf16): the top hit is the cosine-nearest
    document, in both packages."""
    hs = _dense_handles(copies(tmp_path, _embedded_docs(30, 32)),
                        {"fast": {"mode": "approx", "dtype": "bfloat16"}})
    try:
        for pkg, h in hs.items():
            code, data = post(h, "/search", {"query": "document 7", "top_k": 3})
            assert code == 200 and len(data["results"][0]) == 3
            assert data["results"][0][0]["doc_id"] == 7
    finally:
        for h in hs.values():
            h.stop()


def test_verified_profile_serves_identical_to_exact(tmp_path):
    """The verified profile returns the exact profile's hits (ids and
    scores), and both equal the JAX package's."""
    hs = _dense_handles(copies(tmp_path, _embedded_docs(60, 32)),
                        {"exact": None, "verified": {"mode": "verified"}})
    try:
        for q in ("document 7", "document 41", "unrelated words"):
            _, de = both(hs, "/search", {"query": q, "top_k": 5, "pipeline": "exact"}, rtol=1e-5)
            _, dv = both(hs, "/search", {"query": q, "top_k": 5, "pipeline": "verified"}, rtol=1e-5)
            assert [r["doc_id"] for r in de["results"][0]] == [r["doc_id"] for r in dv["results"][0]]
            np.testing.assert_allclose([r["score"] for r in de["results"][0]],
                                       [r["score"] for r in dv["results"][0]], rtol=1e-6, atol=1e-7)
    finally:
        for h in hs.values():
            h.stop()


def test_hybrid_pipeline_served_equal(tmp_path):
    """The hybrid RRF of a dense and a BM25 leg behind the HTTP API: hits
    equal to the JAX package's (RRF depends on ranks alone)."""
    def build(cat):
        _embedded_docs(40, 32)(cat)

    cats = copies(tmp_path, build)
    hs = {}
    for pkg, cat in cats.items():
        r = _mod(pkg, "pipelines.retrieval")
        emb = _mod(pkg, "embeddings").MockEmbedding(dim=32)
        dense = r.VectorSearchPipeline(cat, "dense", embedding_model=emb,
                                       index_options={"mode": "verified"}, **_kw(pkg))
        bm25 = r.BM25Pipeline(cat, "bm25", **_kw(pkg))
        rrf = r.HybridRRFPipeline(cat, "rrf", dense, bm25)
        hs[pkg] = serve(pkg, cat, {"rrf": rrf, "dense": dense, "bm25": bm25}, batch_window_ms=5)
    try:
        queries = ["document 3", "document 17 document", "nothing shared"]
        for name in ("rrf", "dense", "bm25"):
            warm(hs, name, queries, 5)
        for name in ("rrf", "dense", "bm25"):
            code, data = both(hs, "/search", {"queries": queries, "top_k": 5, "pipeline": name},
                              rtol=1e-5)
            assert code == 200 and len(data["results"]) == 3
    finally:
        for h in hs.values():
            h.stop()


def test_batcher_group_failure_is_isolated():
    """A non-truncatable batch split into per-k groups fails only the group
    that raised, in both packages."""
    for pkg in PKGS:
        server = _mod(pkg, "serving.server")

        def fn(queries, top_k):
            if top_k == 50:
                raise RuntimeError("boom at k=50")
            return [{"text": f"ok-{q}"} for q in queries]

        b = server._Batcher(fn, truncatable=False)
        b.stop()
        good, bad = server._SearchJob("a", 5), server._SearchJob("b", 50)
        b._run_batch([good, bad])
        assert good.result == {"text": "ok-a"} and good.error is None
        assert bad.result is None and "boom at k=50" in bad.error
        assert b._warmed.is_set()
        assert good.done.is_set() and bad.done.is_set()


def test_batcher_all_groups_failing_stays_cold():
    for pkg in PKGS:
        server = _mod(pkg, "serving.server")

        def fn(queries, top_k):
            raise ValueError("nothing works")

        b = server._Batcher(fn, truncatable=False)
        b.stop()
        j = server._SearchJob("a", 5)
        b._run_batch([j])
        assert "nothing works" in j.error
        assert not b._warmed.is_set()


def test_generation_batcher_groups_by_top_k(handles):
    """The generation batcher is not truncatable: two concurrent /generate
    requests with different ``top_k`` run as two groups, each at its own k
    (the grouping of ``test_generate_mixed_top_k_not_coalesced``, over a
    stub pipeline)."""
    h = handles[TORCH]
    stub = h.generation_pipelines["stub"]
    code, data = post(h, "/generate", {"query": "warm", "top_k": 1})  # first batch runs alone
    assert code == 200 and data["text"] == "warm@1"
    results = {}

    def call(k):
        results[k] = post(h, "/generate", {"query": "capital of France", "top_k": k})

    stub.calls.clear()
    threads = [threading.Thread(target=call, args=(k,)) for k in (1, 3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    for k in (1, 3):
        code, data = results[k]
        assert code == 200 and data["text"] == f"capital of France@{k}"
        assert len(data["metadata"]["context_chunk_ids"]) == k
    assert sorted(k for _, k in stub.calls) == [1, 3]
    code, data = post(h, "/generate", {"queries": ["a", "b"], "top_k": 2})
    assert code == 200 and [r["text"] for r in data["results"]] == ["a@2", "b@2"]


def test_metrics_label_escaping_and_bucket_guard():
    for pkg in PKGS:
        metrics = _mod(pkg, "serving.metrics")
        m = metrics.ServingMetrics()
        m.inc("autorag_requests_total", {"pipeline": 'we"ird\\name\nx'})
        line = next(l for l in m.render().splitlines() if l.startswith("autorag_requests_total{"))
        assert 'pipeline="we\\"ird\\\\name\\nx"' in line and line.endswith(" 1")
        m.observe("hist_guard", 1.0, buckets=metrics.BATCH_BUCKETS)
        with pytest.raises(ValueError, match="already registered"):
            m.observe("hist_guard", 1.0)


def test_metrics_collector_render_and_quantile():
    texts = {}
    for pkg in PKGS:
        metrics = _mod(pkg, "serving.metrics")
        m = metrics.ServingMetrics()
        m.inc("autorag_requests_total", {"endpoint": "/search", "code": "200"})
        m.inc("autorag_requests_total", {"endpoint": "/search", "code": "200"})
        m.inc("autorag_requests_total", {"endpoint": "/search", "code": "400"})
        for v in (0.004, 0.02, 0.02, 0.3):
            m.observe("autorag_request_latency_seconds", v, {"endpoint": "/search"})
        m.observe("autorag_batch_size", 3, {"pipeline": "bm25"}, buckets=metrics.BATCH_BUCKETS)
        m.set_gauge("autorag_uptime_seconds", 12.5)
        text = texts[pkg] = m.render()
        assert 'autorag_requests_total{code="200",endpoint="/search"} 2' in text
        assert 'autorag_request_latency_seconds_bucket{endpoint="/search",le="0.025"} 3' in text
        assert 'autorag_request_latency_seconds_bucket{endpoint="/search",le="+Inf"} 4' in text
        assert 'autorag_batch_size_bucket{pipeline="bm25",le="4"} 1' in text
        assert "autorag_uptime_seconds 12.5" in text
        assert m.latency_quantile(
            "autorag_request_latency_seconds", 0.5, {"endpoint": "/search"}) == 0.025
    assert texts[TORCH] == texts[JAX]
    assert _mod(TORCH, "serving.metrics").BATCH_BUCKETS == _mod(JAX, "serving.metrics").BATCH_BUCKETS
    assert (_mod(TORCH, "serving.metrics").LATENCY_BUCKETS
            == _mod(JAX, "serving.metrics").LATENCY_BUCKETS)


def _scrape_until(h, needle):
    text = ""
    for _ in range(40):
        ctype, text = get(h, "/metrics")
        assert ctype.startswith("text/plain")
        if needle in text:
            break
        time.sleep(0.05)
    return text


def test_metrics_endpoint_live(handles):
    h = handles[TORCH]
    post(h, "/search", {"query": "capital of France", "top_k": 2})
    post(h, "/search", {"query": "no such field", "top_k": -1})  # 400
    post(h, "/generate", {"query": "capital of France"})
    # counters record AFTER the response body is sent: poll briefly
    text = _scrape_until(h, 'code="200",endpoint="/generate"')
    assert 'autorag_requests_total{code="200",endpoint="/search"} 1' in text
    assert 'autorag_requests_total{code="400",endpoint="/search"} 1' in text
    assert 'autorag_requests_total{code="200",endpoint="/generate"} 1' in text
    assert 'autorag_batch_size_count{kind="search",pipeline="bm25"} 1' in text
    assert 'autorag_batch_size_count{kind="generate",pipeline="stub"} 1' in text
    assert 'autorag_batch_device_seconds_sum{kind="search",pipeline="bm25"}' in text
    assert f"autorag_corpus_docs {len(DOCS)}" in text
    assert 'autorag_queue_depth{kind="search",pipeline="bm25"} 0' in text
    assert "autorag_batches_inflight" in text
    text2 = _scrape_until(h, 'autorag_requests_total{code="200",endpoint="/metrics"}')
    assert 'autorag_requests_total{code="200",endpoint="/metrics"}' in text2
    for bad in ("/nope", "/nope2?q=1"):
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{h.port}{bad}", timeout=TIMEOUT)
        assert err.value.code == 404
    text3 = _scrape_until(h, 'autorag_requests_total{code="404",endpoint="other"} 2')
    assert 'autorag_requests_total{code="404",endpoint="other"} 2' in text3
    assert "/nope" not in text3


def test_search_string_queries_is_rejected(handles):
    code, data = both(handles, "/search", {"queries": "capital of France", "top_k": 2})
    assert code == 400 and "list" in data["error"]
    code, data = post(handles[TORCH], "/generate", {"queries": "capital of France"})
    assert code == 400 and "list" in data["error"]


def test_stop_fails_queued_jobs_instead_of_hanging():
    import queue

    server = _mod(TORCH, "serving.server")
    release = threading.Event()

    def slow_fn(queries, top_k):
        release.wait(timeout=TIMEOUT)
        return [[] for _ in queries]

    b = server._Batcher(slow_fn, batch_window_ms=1, max_inflight=1)
    b._warmed.set()
    first = server._SearchJob("a", 1)
    b.submit(first)  # occupies the single inflight slot
    time.sleep(0.3)
    queued = server._SearchJob("b", 1)
    b.jobs.put(queued)
    b.stop()  # ServingHandle.stop()'s drain on this batcher
    while True:
        try:
            job = b.jobs.get_nowait()
        except queue.Empty:
            break
        job.error = "server shutting down"
        job.done.set()
    assert queued.done.wait(timeout=5) and queued.error
    release.set()
    assert first.done.wait(timeout=5)


def test_handle_stop_returns_and_leaves_no_waiter(tmp_path):
    """``stop()`` shuts the listener and fails queued jobs: the port's
    handle leaves no search waiting."""
    cats = copies(tmp_path, _docs)
    h = bm25_handles({TORCH: cats[TORCH]}, batch_window_ms=5)[TORCH]
    assert post(h, "/search", {"query": "capital", "top_k": 1})[0] == 200
    port = h.port
    h.stop()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2)
    for b in h._batchers.values():
        assert b.jobs.qsize() == 0


def test_requests_served_counts_under_contention(tmp_path):
    """Concurrent handler threads add to ``requests_served`` without a lost
    update (32 clients, a short switch interval)."""
    import sys

    cats = copies(tmp_path, _docs)
    h = bm25_handles({TORCH: cats[TORCH]}, batch_window_ms=2)[TORCH]
    codes = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(i):
            for _ in range(4):
                codes.append(post(h, "/search", {"query": DOCS[i % 4], "top_k": 1})[0])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT * 3)
    finally:
        sys.setswitchinterval(old)
        h.stop()
    assert not any(t.is_alive() for t in threads)
    assert codes == [200] * 128 and h.requests_served == 128


def test_warmup_runs_every_bucket(tmp_path):
    cats = copies(tmp_path, _docs)
    calls = []
    base = _mod(TORCH, "pipelines.retrieval.bm25").BM25Pipeline

    class Counting(base):
        def _retrieve_batch_by_texts(self, texts, top_k):
            calls.append((len(texts), top_k))
            return super()._retrieve_batch_by_texts(texts, top_k)

    h = serve(TORCH, cats[TORCH], {"bm25": Counting(cats[TORCH], "bm25_w", device="cpu")},
              {"stub": StubGeneration()})
    try:
        h.warmup(max_bucket=8, top_k=3, gen_max_bucket=4, gen_top_k=2)
        assert calls == [(1, 3), (2, 3), (4, 3), (8, 3)]
        assert h.generation_pipelines["stub"].calls == [(1, 2), (2, 2), (4, 2)]
    finally:
        h.stop()


def test_serve_workspace_from_config_tree(tmp_path, monkeypatch):
    """``serve_workspace`` builds the named pipelines from an ``init`` tree
    on the CPU and serves them: the same hits as the JAX package's."""
    from autorag_research_tpu.cli.app import main as jax_main
    from autorag_research_tpu_torch.cli.app import main as torch_main

    hs = {}
    for pkg, main in ((JAX, jax_main), (TORCH, lambda a: torch_main(["--device", "cpu", *a]))):
        root = tmp_path / pkg
        root.mkdir()
        monkeypatch.chdir(root)
        assert main(["init"]) == 0
        assert main(["ingest", "--name", "synthetic", "--db", "ws", "--extra", "n_docs=300",
                     "--extra", "n_queries=20"]) == 0
        kw = {"device": "cpu"} if pkg == TORCH else {}
        hs[pkg] = _mod(pkg, "serving.server").serve_workspace(
            str(root / "ws"), config_path=str(root / "configs"), retrieval=["bm25"], port=0, **kw)
    try:
        cat = _mod(TORCH, "store.catalog").Catalog(tmp_path / TORCH / "ws" / "catalog.db")
        queries = [r["contents"] for r in cat.get_queries(limit=8)]
        cat.close()
        warm(hs, "bm25", queries, 10)
        code, data = both(hs, "/search", {"queries": queries, "top_k": 10})
        assert code == 200 and all(data["results"])
        assert json.loads(get(hs[TORCH], "/health")[1])["corpus"] == 300
    finally:
        for h in hs.values():
            h.stop()


def test_request_threads_leave_no_catalog_connections(tmp_path):
    """The HTTP server starts a thread per request, and each reads the
    catalog (contents, gauges): a finished thread's connection is closed when
    the next thread connects, so the open connections stay at the live
    threads' count (one each leaked before: three file descriptors a
    request in WAL mode)."""
    cats = copies(tmp_path, _docs)
    cat = cats[TORCH]
    h = bm25_handles({TORCH: cat}, batch_window_ms=2)[TORCH]
    try:
        for i in range(40):
            assert post(h, "/search", {"query": DOCS[i % 4], "top_k": 2})[0] == 200
            get(h, "/metrics")
        live = [t for t, _ in cat._all_conns if t.is_alive()]
        assert len(cat._all_conns) <= len(live) + 1  # the last request's thread may be ending
        assert len(cat._all_conns) < 10
    finally:
        h.stop()
        cat.close()


def test_concurrent_first_searches_upload_once():
    """Sixteen threads search fresh indexes at once (a short switch
    interval): each index uploads once and every thread gets the hits of a
    search made alone afterwards."""
    import sys

    from autorag_research_tpu_torch.index.dense import DenseIndex
    from autorag_research_tpu_torch.index.sparse import SparseIndex

    rng = np.random.default_rng(3)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 50, size=12)) for _ in range(300)]
    emb = rng.standard_normal((300, 16)).astype(np.float32)
    queries = texts[:4]
    built = {}

    def counting(idx, key):
        upload = idx.to_device

        def wrapped(*a, **kw):
            built[key] = built.get(key, 0) + 1
            return upload(*a, **kw)

        idx.to_device = wrapped
        return idx

    dense = counting(DenseIndex(list(range(300)), emb, mode="verified", device="cpu"), "dense")
    sparse = counting(SparseIndex(list(range(300)), texts, device="cpu"), "sparse")
    got = {"dense": [], "sparse": []}
    start = threading.Barrier(16)

    def worker(i):
        start.wait(timeout=TIMEOUT)
        if i % 2:
            got["dense"].append(dense.topk_rows(emb[:4], 5))
        else:
            got["sparse"].append(sparse.topk_rows(queries, 5))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT * 3)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert built == {"dense": 1, "sparse": 1}
    ref = {"dense": dense.topk_rows(emb[:4], 5), "sparse": sparse.topk_rows(queries, 5)}
    for key in ("dense", "sparse"):
        assert len(got[key]) == 8
        for s_, r_ in got[key]:
            np.testing.assert_array_equal(r_, ref[key][1])
            np.testing.assert_array_equal(s_, ref[key][0])
