"""The six LLM-driven / reranking retrieval wrappers of the port (``rerank``,
``hyde``, ``query_rewrite``, ``question_decomposition``, ``retro_star``,
``power_of_noise``) against the JAX package's, through both packages on
copies of one SQLite catalog (``tests/test_wrapper_pipelines.py``'s cases).

Each case runs both ``Executor``s (the port's with ``BuildContext(device=
"cpu")``) with the same mock models and compares the persisted rows: ids in
equal order, scores within 1e-5 relative (BM25's within 1e-6, the dense
legs' cosine within 1e-5, as in ``tests/test_torch_generation.py``), equal
metric averages, and equal LLM prompts. ``power_of_noise``'s noise ids are
the JAX package's, id for id. One case runs all six from the ``init``
templates, one the rewriting wrappers with ``TorchLM`` / ``JaxLM`` on one
checkpoint (the decoders at hidden 32, f32, whose greedy texts agree
exactly on these prompts).
"""

import importlib
import random
import shutil

import numpy as np
import pytest
import yaml

from autorag_research_tpu_torch.utils.concurrency import run_async

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)
DOCS = [
    "quick brown fox jumps over dog",
    "lazy dog sleeps in the sun",
    "vector database retrieval systems",
    "tpu hardware matrix acceleration",
    "fox hunting season regulations",
    "dogs and foxes in the wild",
]
DIM = 32


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _kw(pkg):
    return {"device": "cpu"} if pkg == TORCH else {}


@pytest.fixture(autouse=True)
def clear_cache():
    for pkg in PKGS:
        _mod(pkg, "index.registry").invalidate()
    yield
    for pkg in PKGS:
        _mod(pkg, "index.registry").invalidate()


def _wcat(cat):
    """``tests/test_wrapper_pipelines.py``'s catalog, with generation answers
    and one passage whose contents are missing (a partial ingest)."""
    emb = _mod(TORCH, "embeddings").MockEmbedding(dim=DIM)
    cat.add_chunks([{"id": i, "contents": d, "embedding": emb.embed_query(d)}
                    for i, d in enumerate(DOCS)])
    cat.add_chunks([{"id": 6, "contents": "", "embedding": emb.embed_query("quick fox")}])
    cat.add_queries([
        {"id": 0, "contents": "quick fox", "embedding": emb.embed_query("quick fox"),
         "generation_gt": ["fox"]},
        {"id": 1, "contents": "dog sleeping", "embedding": emb.embed_query("dog sleeping"),
         "generation_gt": ["sun"]},
    ])
    cat.add_retrieval_gt(0, _mod(TORCH, "store.gt").or_all([0, 4, 5]))
    cat.add_retrieval_gt(1, 1)


def copies(tmp_path, build=_wcat, embedding_dim=DIM):
    """``build(Catalog)`` once with the port's catalog, then one copy of the
    file per package, opened by that package's ``Catalog``."""
    src = tmp_path / "src.db"
    cat = _mod(TORCH, "store.catalog").Catalog(src, embedding_dim=embedding_dim)
    build(cat)
    cat.close()
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir(exist_ok=True)
        shutil.copy(src, tmp_path / pkg / "w.db")
        out[pkg] = _mod(pkg, "store.catalog").Catalog(tmp_path / pkg / "w.db",
                                                      embedding_dim=embedding_dim)
    return out


def subs(pkg):
    return {
        "vs": _mod(pkg, "pipelines.retrieval.vector_search").VectorSearchConfig(
            name="vs", embedding_model=_mod(pkg, "embeddings").MockEmbedding(dim=DIM)),
        "bm25": _mod(pkg, "pipelines.retrieval.bm25").BM25Config(name="bm25"),
    }


def run_both(tmp_path, make_config, sub_names=(), metrics=("recall",), cats=None):
    """``make_config(pkg)`` -> a pipeline config through each package's
    Executor on its copy. Returns {pkg: (rows by query, metric averages,
    stats, catalog)}."""
    cats = cats or copies(tmp_path)
    out = {}
    for pkg, cat in cats.items():
        cfg = _mod(pkg, "config")
        base = subs(pkg)
        ctx = cfg.BuildContext(pipeline_configs={k: base[k] for k in sub_names}, **_kw(pkg))
        config = cfg.ExecutorConfig(pipelines=[make_config(pkg)],
                                    metrics=[cfg.BaseMetricConfig(name=m) for m in metrics],
                                    health_check=False)
        result = _mod(pkg, "executor").Executor(cat, config, ctx).run()
        assert result.success, result.report()
        pres = result.pipelines[0]
        pid = pres.stats["pipeline_id"]
        rows = {q: [(r["doc_id"], r["rel_score"]) for r in cat.get_retrieved(q, pid)]
                for q in cat.get_all_query_ids()}
        out[pkg] = (rows, {m.metric_name: m.average for m in pres.metrics}, pres.stats, cat)
    return out


def assert_rows_equal(out, rtol=1e-5):
    got, ref = out[TORCH], out[JAX]
    assert got[1] == ref[1]  # metric averages
    assert got[2]["total_queries"] == ref[2]["total_queries"]
    assert got[0].keys() == ref[0].keys()
    for q in ref[0]:
        assert [d for d, _ in got[0][q]] == [d for d, _ in ref[0][q]], q
        np.testing.assert_allclose([s for _, s in got[0][q]], [s for _, s in ref[0][q]], rtol=rtol)
    return got[0]


def llm(pkg, responder=None, responses=None):
    if responses is not None:
        return _mod(pkg, "llm").ScriptedLLM(responses=list(responses))
    return _mod(pkg, "llm").MockLLM(responder=responder)


# ---------------------------------------------------------------- HyDE


def test_hyde_uses_hypothetical_doc(tmp_path):
    llms = {}

    def make(pkg):
        llms[pkg] = llm(pkg, lambda p: "quick brown fox jumps over dog")
        return _mod(pkg, "pipelines.retrieval.hyde").HyDEConfig(
            name="hyde", llm=llms[pkg], embedding_model=_mod(pkg, "embeddings").MockEmbedding(dim=DIM),
            top_k=3)

    rows = assert_rows_equal(run_both(tmp_path, make))
    # hypothetical doc == doc 0 -> doc 0 ranks first for both queries
    assert rows[0][0][0] == 0 and rows[1][0][0] == 0
    assert llms[TORCH].calls == llms[JAX].calls and len(llms[TORCH].calls) == 2


def test_hyde_hits_equal_search_by_embedding(tmp_path):
    """The port's hits are ``search_by_embedding`` of the passage's embedding,
    and ``index_options`` selects the inner index's mode (verified: the same
    hits as exact here)."""
    cat = copies(tmp_path)[TORCH]
    emb = _mod(TORCH, "embeddings").MockEmbedding(dim=DIM)
    hyde_mod = _mod(TORCH, "pipelines.retrieval.hyde")
    for opts in (None, {"mode": "verified"}):
        pipe = hyde_mod.HyDEPipeline(
            cat, name=f"hyde_{bool(opts)}", llm=llm(TORCH, lambda p: "lazy dog in the sun"),
            embedding_model=emb, index_options=opts, device="cpu")
        got = run_async(pipe._retrieve_by_text("where do dogs sleep", 4))
        ref = pipe._dense.search_by_embedding(emb.embed_query("lazy dog in the sun"), 4)
        assert got == ref and len(got) == 4
        assert ("index_options" in pipe._get_pipeline_config()) == bool(opts)
    # an empty passage falls back to the query text
    pipe = hyde_mod.HyDEPipeline(cat, name="hyde_empty", llm=llm(TORCH, lambda p: "  "),
                                 embedding_model=emb, device="cpu")
    assert run_async(pipe._retrieve_by_text("vector database", 2)) == \
        pipe._dense.search_by_embedding(emb.embed_query("vector database"), 2)


def test_hyde_validation(tmp_path):
    cats = copies(tmp_path)
    for pkg in PKGS:
        with pytest.raises(ValueError, match="query"):
            _mod(pkg, "pipelines.retrieval.hyde").HyDEPipeline(
                cats[pkg], prompt_template="no placeholder", **_kw(pkg))
    # a mesh goes to the dense search (sharded search: tests/test_torch_parallel.py)
    mesh = _mod(TORCH, "parallel.mesh").corpus_mesh(devices=["cpu"] * 2)
    pipe = _mod(TORCH, "pipelines.retrieval.hyde").HyDEPipeline(cats[TORCH], mesh=mesh, device="cpu")
    assert pipe._dense.mesh is mesh


# ---------------------------------------------------------- query rewrite


@pytest.mark.parametrize("reply", ["vector database retrieval", '"lazy dog"', "   "])
def test_rewrite_delegates(tmp_path, reply):
    llms = {}

    def make(pkg):
        llms[pkg] = llm(pkg, lambda p: reply)
        return _mod(pkg, "pipelines.retrieval.query_rewrite").QueryRewriteConfig(
            name="qr", inner_retrieval_pipeline_name="bm25", llm=llms[pkg], top_k=2)

    out = run_both(tmp_path, make, ("bm25",))
    rows = assert_rows_equal(out, rtol=1e-6)
    assert llms[TORCH].calls == llms[JAX].calls
    if reply.startswith("vector"):
        assert rows[0][0][0] == 2  # the rewritten query is about vector databases
    # the hits equal the inner search of the rewritten text
    cat = out[TORCH][3]
    bm25 = _mod(TORCH, "pipelines.retrieval.bm25").BM25Pipeline(cat, "bm25_direct", device="cpu")
    text = reply.strip().strip('"') or "quick fox"
    direct = run_async(bm25._retrieve_by_text(text, 2))
    assert [(h["doc_id"], pytest.approx(h["score"])) for h in direct] == rows[0]


# ------------------------------------------------- question decomposition


@pytest.mark.parametrize("text", [
    "1. What is A?\n2. What is B?", "- alpha\n- beta", "What is A? What is B?",
    "1) first 2) second 3) third", "* one;\n\n• two", "single question", "", "  \n  ",
])
def test_parse_subquestions(text):
    got = _mod(TORCH, "pipelines.retrieval.question_decomposition").parse_subquestions(text)
    assert got == _mod(JAX, "pipelines.retrieval.question_decomposition").parse_subquestions(text)


@pytest.mark.parametrize("reply,cap", [("lazy dog sun\nfox hunting rules", 3),
                                       ("quick fox\nQUICK  fox\nvector\ndogs\nsun", 2)])
def test_decomposition_merges_max_score(tmp_path, reply, cap):
    llms = {}

    def make(pkg):
        llms[pkg] = llm(pkg, lambda p: reply)
        return _mod(pkg, "pipelines.retrieval.question_decomposition").QuestionDecompositionConfig(
            name="qd", inner_retrieval_pipeline_name="bm25", llm=llms[pkg], top_k=4,
            max_subquestions=cap)

    out = run_both(tmp_path, make, ("bm25",))
    rows = assert_rows_equal(out, rtol=1e-6)
    assert llms[TORCH].calls == llms[JAX].calls
    assert {d for d, _ in rows[0]} & {1, 4}  # sub-question hits merged in
    # the merge equals the max-score merge of the sub-searches
    cat = out[TORCH][3]
    qd = _mod(TORCH, "pipelines.retrieval.question_decomposition")
    bm25 = _mod(TORCH, "pipelines.retrieval.bm25").BM25Pipeline(cat, "bm25_direct", device="cpu")
    pipe = qd.QuestionDecompositionPipeline(cat, "qd_direct", llm=llm(TORCH, lambda p: reply),
                                            inner_retrieval_pipeline=bm25, max_subquestions=cap)
    subs_ = run_async(pipe._decompose("quick fox"))
    assert len(subs_) <= cap and "quick fox" not in [" ".join(s.lower().split()) for s in subs_]
    merged = {}
    for q in ["quick fox", *subs_]:
        for h in run_async(bm25._retrieve_by_text(q, 8)):
            merged[h["doc_id"]] = max(merged.get(h["doc_id"], -np.inf), h["score"])
    want = sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))[:4]
    assert [d for d, _ in want] == [d for d, _ in rows[0]]


def test_decomposition_with_reranker(tmp_path):
    def make(pkg):
        return _mod(pkg, "pipelines.retrieval.question_decomposition").QuestionDecompositionConfig(
            name="qd_rr", inner_retrieval_pipeline_name="bm25", top_k=2,
            llm=llm(pkg, lambda p: "dogs in the wild\nfox season"),
            reranker=_mod(pkg, "rerankers").MockReranker())

    assert_rows_equal(run_both(tmp_path, make, ("bm25",)))


# ---------------------------------------------------------------- rerank


@pytest.mark.parametrize("inner,top_k", [("vs", 3), ("vs", 7), ("bm25", 2)])
def test_rerank_reorders_and_tops_up(tmp_path, inner, top_k):
    """MockReranker scores token overlap; the passage with missing contents
    (id 6, retrieved by the dense leg) tops the list up after the ranked ones
    at ``floor - 1.0 - i``."""
    def make(pkg):
        return _mod(pkg, "pipelines.retrieval.rerank").RerankConfig(
            name="rr", inner_retrieval_pipeline_name=inner,
            reranker=_mod(pkg, "rerankers").MockReranker(), top_k=top_k)

    rows = assert_rows_equal(run_both(tmp_path, make, (inner,)))
    assert rows[0][0][0] in (0, 4, 5)
    if inner == "vs" and top_k == 7:
        ids = [d for d, _ in rows[0]]
        assert 6 in ids and len(ids) == 7
        floor = min(s for d, s in rows[0] if d != 6)
        assert dict(rows[0])[6] < floor


def test_rerank_listwise_llm_through_the_registry(tmp_path):
    """``rerank`` with ``llm_listwise`` (its ``llm: mock`` resolved by the
    registry) over ``bm25``, from YAML in both packages."""
    (tmp_path / "configs" / "reranker").mkdir(parents=True)
    (tmp_path / "configs" / "reranker" / "lw.yaml").write_text("type: llm_listwise\nllm: mock\nwindow: 2\n")
    cats = copies(tmp_path)
    out = {}
    for pkg, cat in cats.items():
        cfg = _mod(pkg, "config")
        ctx = cfg.BuildContext(
            models=_mod(pkg, "injection").ModelRegistry(tmp_path / "configs", **_kw(pkg)),
            pipeline_configs={"bm25": subs(pkg)["bm25"]}, **_kw(pkg))
        config = cfg.ExecutorConfig(
            pipelines=[_mod(pkg, "pipelines.retrieval.rerank").RerankConfig(
                name="rr_lw", inner_retrieval_pipeline_name="bm25", reranker="lw", top_k=3)],
            metrics=[cfg.BaseMetricConfig(name="recall")], health_check=False)
        result = _mod(pkg, "executor").Executor(cat, config, ctx).run()
        assert result.success, result.report()
        pid = result.pipelines[0].stats["pipeline_id"]
        out[pkg] = [[(r["doc_id"], r["rel_score"]) for r in cat.get_retrieved(q, pid)]
                    for q in (0, 1)]
    assert out[TORCH] == out[JAX]


def test_rerank_unit_follows_the_inner_pipeline(tmp_path):
    """``tests/test_wrapper_pipelines.py:417``: a rerank over an image
    pipeline persists in the image table."""
    for pkg in PKGS:
        cat = _mod(pkg, "store.catalog").Catalog(tmp_path / f"{pkg}_u.db", embedding_dim=DIM)
        emb = _mod(pkg, "embeddings").MockEmbedding(dim=DIM)
        cat.add_image_chunks([{"id": "p1", "image": b"\x89PNG", "mimetype": "image/png",
                               "embedding": emb.embed_query("img")}])
        img = _mod(pkg, "pipelines.retrieval.image_vector_search").ImageVectorSearchPipeline(
            cat, "i1", embedding_model=emb, **_kw(pkg))
        rr = _mod(pkg, "pipelines.retrieval.rerank").RerankPipeline(
            cat, "rr_img", inner_retrieval_pipeline=img, reranker=_mod(pkg, "rerankers").MockReranker())
        assert rr.retrieval_unit == "image_chunk"
        assert rr._get_pipeline_config()["retrieval_unit"] == "image_chunk"


# ---------------------------------------------------------- power of noise


@pytest.mark.parametrize("order", ["retrieved_first", "noise_first", "interleave"])
@pytest.mark.parametrize("mode", ["random", "answer_aware_random"])
def test_noise_ids_and_order_equal_jax(tmp_path, order, mode):
    def make(pkg):
        return _mod(pkg, "pipelines.retrieval.power_of_noise").PowerOfNoiseConfig(
            name="pon", base_retrieval_pipeline_name="vs", noise_count=2, noise_order=order,
            noise_mode=mode, top_k=5, seed=1)

    out = run_both(tmp_path, make, ("vs",))
    rows = assert_rows_equal(out)
    for q, hits in rows.items():
        assert len(hits) == 5 and [s for _, s in hits] == [5.0, 4.0, 3.0, 2.0, 1.0]
    # the noise equals a host recomputation with random.Random(f"{seed}:{qid}")
    cat = out[TORCH][3]
    vs = _mod(TORCH, "pipelines.retrieval.vector_search").VectorSearchPipeline(
        cat, "vs_direct", embedding_model=_mod(TORCH, "embeddings").MockEmbedding(dim=DIM), device="cpu")
    for q, hits in rows.items():
        retrieved = [h["doc_id"] for h in run_async(vs._retrieve_by_id(q, 3))]
        exclude = set(retrieved)
        if mode == "answer_aware_random":
            exclude |= {r["chunk_id"] for r in cat.get_relations_by_query(q)}
            answer = {0: "fox", 1: "sun"}[q]
            exclude |= {i for i, d in enumerate(DOCS) if answer in d}
        pool = [i for i in range(7) if i not in exclude]
        noise = random.Random(f"1:{q}").sample(pool, 2)
        ids = [d for d, _ in hits]
        want = {"retrieved_first": retrieved + noise, "noise_first": noise + retrieved,
                "interleave": [retrieved[0], noise[0], retrieved[1], noise[1], retrieved[2]]}[order]
        assert ids == want and not set(noise) & set(retrieved)


def test_noise_is_deterministic_across_runs(tmp_path):
    def make(pkg):
        return _mod(pkg, "pipelines.retrieval.power_of_noise").PowerOfNoiseConfig(
            name="pon", base_retrieval_pipeline_name="vs", noise_count=2,
            noise_order="noise_first", top_k=5, seed=1)

    cats = copies(tmp_path)
    first = run_both(tmp_path, make, ("vs",), cats=cats)
    for pkg, (_, _, stats, cat) in first.items():
        cat.delete_retrieved_by_pipeline(stats["pipeline_id"])
        _mod(pkg, "index.registry").invalidate()
    second = run_both(tmp_path, make, ("vs",), cats=cats)
    assert first[TORCH][0] == second[TORCH][0] and first[JAX][0] == second[JAX][0]


@pytest.mark.parametrize("count,ratio,top_k", [(20, None, 5), (0, 0.4, 5), (0, None, 3), (2, 0.9, 4)])
def test_noise_capped_at_top_k_and_base_skipped(tmp_path, count, ratio, top_k):
    cats = copies(tmp_path)
    out = {}
    for pkg, cat in cats.items():
        base = _mod(pkg, "pipelines.retrieval.bm25").BM25Pipeline(cat, "b_pon", **_kw(pkg))
        calls = []
        orig = base._retrieve_by_id

        async def spy(qid, k, orig=orig, calls=calls):
            calls.append(k)
            return await orig(qid, k)

        base._retrieve_by_id = spy
        pipe = _mod(pkg, "pipelines.retrieval.power_of_noise").PowerOfNoisePipeline(
            cat, "pon_cap", base_retrieval_pipeline=base, noise_count=count, noise_ratio=ratio)
        out[pkg] = (run_async(pipe._retrieve_by_id(0, top_k)), calls, pipe._n_noise(top_k))
    assert out[TORCH] == out[JAX]
    hits, calls, n_noise = out[TORCH]
    if count >= top_k:
        assert len(hits) == top_k and calls == []  # base skipped at base_k == 0


def test_text_path_noise_varies_by_query_text(tmp_path):
    cats = copies(tmp_path)
    out = {}
    for pkg, cat in cats.items():
        pipe = _mod(pkg, "pipelines.retrieval.power_of_noise").PowerOfNoisePipeline(
            cat, "pon_seed", noise_count=3,
            base_retrieval_pipeline=_mod(pkg, "pipelines.retrieval.bm25").BM25Pipeline(
                cat, "b_seed", **_kw(pkg)))
        out[pkg] = [run_async(pipe._retrieve_by_text(t, 4))
                    for t in ("alpha question", "beta question", "gamma question")]
    assert out[TORCH] == out[JAX]
    assert len({frozenset(h["doc_id"] for h in hits) for hits in out[TORCH]}) > 1


@pytest.mark.parametrize("kw", [{"noise_count": -1}, {"noise_ratio": 1.5},
                                {"noise_order": "middle"}, {"noise_mode": "adversarial"}])
def test_noise_validation(tmp_path, kw):
    cats = copies(tmp_path)
    for pkg in PKGS:
        with pytest.raises(ValueError):
            _mod(pkg, "pipelines.retrieval.power_of_noise").PowerOfNoisePipeline(cats[pkg], **kw)


# ------------------------------------------------------------- RETRO*


@pytest.mark.parametrize("text", [
    "reasoning... <score>87</score>", "<score>10</score> draft <score>92</score>",
    "<score>150</score>", "<SCORE> -5 </SCORE>", "I rate this 7", "no score", "12.5 then words",
    "", "<score>abc</score> 40",
])
def test_retro_star_score_tag_contract(text):
    got = _mod(TORCH, "pipelines.retrieval.retro_star")._parse_score(text)
    assert got == _mod(JAX, "pipelines.retrieval.retro_star")._parse_score(text)
    assert 0.0 <= got <= 100.0


@pytest.mark.parametrize("samples,weights", [(1, None), (2, [3.0, 1.0])])
def test_rubric_scores_rank(tmp_path, samples, weights):
    llms = {}

    def scorer(prompt):
        # 10 to the doc about dogs sleeping, 2 otherwise; ties break by the
        # inner score, then doc id
        return "<score>10</score>" if "lazy dog sleeps" in prompt else "2"

    def make(pkg):
        llms[pkg] = llm(pkg, scorer)
        return _mod(pkg, "pipelines.retrieval.retro_star").RetroStarConfig(
            name="rs", retrieval_pipeline_name="bm25", llm=llms[pkg], candidate_top_k=6,
            top_k=3, num_samples=samples, sample_weights=weights)

    out = run_both(tmp_path, make, ("bm25",))
    rows = assert_rows_equal(out, rtol=0)
    assert sorted(llms[TORCH].calls) == sorted(llms[JAX].calls)
    for hits in rows.values():
        if any(d == 1 for d, _ in hits):
            assert hits[0] == (1, 10.0)  # the rubric winner ranks first
    # the order equals the sort by (-rubric, -inner score, doc id)
    cat = out[TORCH][3]
    bm25 = _mod(TORCH, "pipelines.retrieval.bm25").BM25Pipeline(cat, "bm25_direct", device="cpu")
    for q, text in ((0, "quick fox"), (1, "dog sleeping")):
        cands = run_async(bm25._retrieve_by_text(text, 6))
        contents = cat.get_chunk_contents([h["doc_id"] for h in cands])
        rubric = {h["doc_id"]: 10.0 if "lazy dog sleeps" in contents[h["doc_id"]] else 2.0
                  for h in cands}
        want = sorted(cands, key=lambda h: (-rubric[h["doc_id"]], -h["score"], h["doc_id"]))[:3]
        assert [h["doc_id"] for h in want] == [d for d, _ in rows[q]]


def test_retro_star_validation(tmp_path):
    cats = copies(tmp_path)
    for pkg in PKGS:
        rs = _mod(pkg, "pipelines.retrieval.retro_star").RetroStarPipeline
        with pytest.raises(ValueError, match="doc"):
            rs(cats[pkg], prompt_template="{query} only")
        with pytest.raises(ValueError, match="sample_weights"):
            rs(cats[pkg], num_samples=2, sample_weights=[1.0])


# ------------------------------------------------------- from the templates


SIX = ("rerank", "hyde", "query_rewrite", "question_decomposition", "retro_star", "power_of_noise")


def test_all_six_from_the_init_templates(tmp_path, monkeypatch):
    """``init``'s six wrapper templates (mock models, the ``bm25`` and
    ``vector_search`` templates underneath) through both Executors: each
    resolves to its package's config, and the rows and recall are equal."""
    from autorag_research_tpu_torch.cli.app import main as torch_main

    monkeypatch.chdir(tmp_path)
    assert torch_main(["init"]) == 0
    cfg_dir = tmp_path / "configs"
    cats = copies(tmp_path, embedding_dim=64, build=lambda cat: _template_catalog(cat))
    out = {}
    for pkg, cat in cats.items():
        resolver = _mod(pkg, "cli.config_resolver").ConfigResolver(cfg_dir)
        configs = [resolver.resolve_pipeline("retrieval", n) for n in SIX]
        assert [type(c).__module__.split(".")[0] for c in configs] == [pkg] * 6
        extra = resolver.resolve_transitive_dependencies(configs)
        assert sorted(extra) == ["bm25"]
        cfg = _mod(pkg, "config")
        ctx = cfg.BuildContext(models=_mod(pkg, "injection").ModelRegistry(cfg_dir, **_kw(pkg)),
                               pipeline_configs=dict(extra), **_kw(pkg))
        result = _mod(pkg, "executor").Executor(
            cat, cfg.ExecutorConfig(pipelines=configs, metrics=[cfg.BaseMetricConfig(name="recall")],
                                    health_check=True, health_check_queries=1), ctx).run()
        assert result.success, result.report()
        out[pkg] = {}
        for pres in result.pipelines:
            pid = pres.stats["pipeline_id"]
            out[pkg][pres.name] = (
                [[(r["doc_id"], r["rel_score"]) for r in cat.get_retrieved(q, pid)]
                 for q in cat.get_all_query_ids()],
                pres.metrics[0].average)
            assert cat.get_pipeline(f"{pres.name}_health_check") is None
    for name in SIX:
        (got, recall), (ref, jrecall) = out[TORCH][name], out[JAX][name]
        assert recall == jrecall, name
        for g, r in zip(got, ref):
            assert [d for d, _ in g] == [d for d, _ in r], name
            np.testing.assert_allclose([s for _, s in g], [s for _, s in r], rtol=1e-5)
        # the mock LLM's rewrite shares no term with the corpus: empty rows
        assert all(len(g) <= 10 for g in got) and (name == "query_rewrite" or all(got)), name


def _template_catalog(cat):
    """A 40-passage catalog embedded by the mock embedding (dim 64, the
    ``hyde`` template's model)."""
    emb = _mod(TORCH, "embeddings").MockEmbedding()
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(60)]
    docs = [" ".join(rng.choice(words, size=8)) for _ in range(40)]
    cat.add_chunks([{"id": i, "contents": d, "embedding": emb.embed_query(d)}
                    for i, d in enumerate(docs)])
    queries = [" ".join(docs[3 * j].split()[:3]) for j in range(4)]
    cat.add_queries([{"id": j, "contents": q, "embedding": emb.embed_query(q)}
                     for j, q in enumerate(queries)])
    for j in range(4):
        cat.add_retrieval_gt(j, 3 * j)


# ------------------------------------------------------- real decoders


def test_llm_wrappers_with_real_decoders(tmp_path):
    """``query_rewrite``, ``question_decomposition`` and ``retro_star`` with
    ``TorchLM`` / ``JaxLM`` on one ``JaxLM.save`` checkpoint: equal prompts,
    equal generated texts and equal rows."""
    from autorag_research_tpu.llm import JaxLM
    from autorag_research_tpu.models.decoder import DecoderConfig as JCfg
    from autorag_research_tpu_torch.llm import TorchLM
    from autorag_research_tpu_torch.models.decoder import DecoderConfig

    small = dict(hidden=32, layers=2, heads=2, max_len=256)
    path = str(tmp_path / "lm.npz")
    JaxLM(config=JCfg(**small), max_prompt_len=192, max_new_tokens=16, seed=3).save(path)
    lms = {JAX: JaxLM(config=JCfg(**small), max_prompt_len=192, max_new_tokens=16, checkpoint=path),
           TORCH: TorchLM(DecoderConfig(**small), max_prompt_len=192, max_new_tokens=16,
                          checkpoint=path, device="cpu")}
    configs = {
        "qr": lambda pkg: _mod(pkg, "pipelines.retrieval.query_rewrite").QueryRewriteConfig(
            name="qr", inner_retrieval_pipeline_name="bm25", llm=lms[pkg], top_k=3),
        "qd": lambda pkg: _mod(pkg, "pipelines.retrieval.question_decomposition")
        .QuestionDecompositionConfig(name="qd", inner_retrieval_pipeline_name="bm25",
                                     llm=lms[pkg], top_k=3),
        "rs": lambda pkg: _mod(pkg, "pipelines.retrieval.retro_star").RetroStarConfig(
            name="rs", retrieval_pipeline_name="bm25", llm=lms[pkg], candidate_top_k=4, top_k=3,
            max_rerank_concurrency=1),
    }
    cats = copies(tmp_path)
    for name, make in configs.items():
        for pkg in PKGS:
            lms[pkg].calls.clear()
        out = run_both(tmp_path, make, ("bm25",), cats=cats)
        assert_rows_equal(out, rtol=1e-6)
        assert lms[TORCH].calls == lms[JAX].calls, name
        texts = {pkg: [lms[pkg].generate(p).text for p in lms[pkg].calls[:4]] for pkg in PKGS}
        assert texts[TORCH] == texts[JAX], name
