"""The port's ``heaven`` (two-stage visual retrieval) against the JAX package's.

``estimate_key_vector_count`` and ``maxsim_subset`` are host numpy in both
packages: equal outputs (``maxsim_subset`` bitwise) on seeded inputs. The
whole pipeline runs through both packages' ``Executor``s (the port's on the
CPU, ``BuildContext(device="cpu")``) on copies of one SQLite catalog of
seeded page embeddings (single- and multi-vector, some pages without a
multi-vector), at several stage-1 sizes, refine ratios and weights: the
persisted lists have the same ids in the same order and scores within 1e-6
(stage 1 is the exact dense cosine of each package, f32; the rest is the
same numpy). The edge cases of the JAX pipeline hold in both: an empty
stage 1 (no hits), candidates without multi-vectors and a query without
one (the stage-1 hits returned), text queries through both embedding
models, and the parameter and mesh refusals. Stage 1 shares the dense index
an ``image_vector_search`` in single mode builds.
"""

import importlib
import shutil

import numpy as np
import pytest

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)
DIM, N_PAGES = 16, 40
WORDS = ["revenue", "table", "of", "figure", "in", "chart", "at", "growth", "q3", "sales"]


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


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _build(cat, seed=0, n_queries=12):
    """Pages with seeded embeddings (every 7th without a multi-vector);
    queries drawn from a gold page's tokens plus noise, with 1-9 words."""
    rng = np.random.default_rng(seed)
    mats = [_unit(rng.standard_normal((int(rng.integers(3, 9)), DIM))) for _ in range(N_PAGES)]
    cat.add_image_chunks([{"id": f"pg{i}", "image": f"page {i}".encode(), "mimetype": "image/png"}
                          for i in range(N_PAGES)])
    cat.set_embeddings("image_chunk", [(f"pg{i}", _unit(m.mean(axis=0))) for i, m in enumerate(mats)])
    cat.set_multi_embeddings("image_chunk", [(f"pg{i}", m) for i, m in enumerate(mats) if i % 7])
    gold = rng.choice(N_PAGES, size=n_queries, replace=False)
    rows, singles, multis = [], [], []
    for j, g in enumerate(gold):
        n_words = int(rng.integers(1, 10))
        rows.append({"id": f"q{j}", "contents": " ".join(rng.choice(WORDS, size=n_words))})
        q = _unit(mats[g][rng.integers(0, len(mats[g]), size=6)] + 0.3 * rng.standard_normal((6, DIM)))
        singles.append((f"q{j}", _unit(q.mean(axis=0))))
        multis.append((f"q{j}", q))
    cat.add_queries(rows)
    cat.set_embeddings("query", singles)
    cat.set_multi_embeddings("query", multis)
    for j, g in enumerate(gold):
        cat.add_retrieval_gt(f"q{j}", f"pg{g}", chunk_type="image_chunk")


def copies(tmp_path, **kw):
    src = tmp_path / "src.db"
    cat = _mod(TORCH, "store.catalog").Catalog(src, embedding_dim=DIM)
    _build(cat, **kw)
    cat.close()
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir(exist_ok=True)
        shutil.copy(src, tmp_path / pkg / "h.db")
        out[pkg] = _mod(pkg, "store.catalog").Catalog(tmp_path / pkg / "h.db", embedding_dim=DIM)
    return out


def run_both(cats, make_configs, metrics=("recall", "ndcg")):
    out = {}
    for pkg, cat in cats.items():
        cfg = _mod(pkg, "config")
        config = cfg.ExecutorConfig(pipelines=make_configs(pkg),
                                    metrics=[cfg.BaseMetricConfig(name=m) for m in metrics],
                                    health_check=True, health_check_queries=1)
        result = _mod(pkg, "executor").Executor(cat, config, cfg.BuildContext(**_kw(pkg))).run()
        assert result.success, result.report()
        res = {}
        for pres in result.pipelines:
            pid = pres.stats["pipeline_id"]
            rows = {q: [(r["doc_id"], r["rel_score"]) for r in cat.get_retrieved(q, pid, "image_chunk")]
                    for q in cat.get_all_query_ids()}
            res[pres.name] = (rows, {m.metric_name: m.average for m in pres.metrics})
        out[pkg] = res
    return out


def assert_lists_equal(got, ref, atol=1e-6):
    assert got.keys() == ref.keys()
    for q in ref:
        assert [d for d, _ in got[q]] == [d for d, _ in ref[q]], q
        np.testing.assert_allclose([s for _, s in got[q]], [s for _, s in ref[q]], rtol=0, atol=atol)


@pytest.mark.parametrize("text,total,ratio", [
    ("revenue table of q3", 6, 0.5), ("of in at", 6, 0.5), ("", 5, 0.25), ("", 1, 0.9),
    ("alpha beta gamma delta epsilon zeta eta theta", 4, 0.5), ("Revenue REVENUE revenue", 3, 0.1),
])
def test_estimate_key_vector_count_equal(text, total, ratio):
    got = [_mod(p, "pipelines.retrieval.heaven").estimate_key_vector_count(text, total, ratio)
           for p in PKGS]
    assert got[0] == got[1]
    assert 1 <= got[1] <= total


@pytest.mark.parametrize("nq", [0, 1, 5])
def test_maxsim_subset_equal(nq):
    rng = np.random.default_rng(nq)
    q = _unit(rng.standard_normal((nq, DIM))) if nq else np.zeros((0, DIM), np.float32)
    docs = {f"d{i}": _unit(rng.standard_normal((i + 1, DIM))) for i in range(5)}
    docs["empty"] = np.zeros((0, DIM), np.float32)
    docs["none"] = None
    got = [_mod(p, "pipelines.retrieval.heaven").maxsim_subset(q, docs) for p in PKGS]
    assert got[0] == got[1]
    assert got[1]["empty"] == got[1]["none"] == 0.0


@pytest.mark.parametrize("stage1,ratio,weight,top_k", [
    (200, 0.25, 0.3, 10),  # the template's defaults
    (12, 0.25, 0.3, 5),
    (5, 1.0, 0.0, 3),
    (20, 0.1, 1.0, 10),
    (8, 0.5, 0.7, 12),  # top_k above the stage-1 size
])
def test_heaven_lists_equal_jax(tmp_path, stage1, ratio, weight, top_k):
    cats = copies(tmp_path)

    def configs(pkg):
        return [_mod(pkg, "pipelines.retrieval.heaven").HEAVENConfig(
            name="heaven", stage1_candidate_count=stage1, stage2_refine_ratio=ratio,
            stage1_weight=weight, top_k=top_k)]

    out = run_both(cats, configs)
    got, ref = out[TORCH]["heaven"], out[JAX]["heaven"]
    assert got[1] == pytest.approx(ref[1], abs=1e-9)
    assert_lists_equal(got[0], ref[0])
    assert all(len(r) == top_k for r in got[0].values())  # stage 1 lists max(top_k, stage1)


def test_heaven_shares_stage1_with_image_vector_search(tmp_path):
    cats = copies(tmp_path)

    def configs(pkg):
        return [
            _mod(pkg, "pipelines.retrieval.image_vector_search").ImageVectorSearchConfig(
                name="ivs", search_mode="single", top_k=10),
            _mod(pkg, "pipelines.retrieval.heaven").HEAVENConfig(name="heaven", top_k=10),
        ]

    out = run_both(cats, configs)
    for name in ("ivs", "heaven"):
        assert_lists_equal(out[TORCH][name][0], out[JAX][name][0])
    dense = [k for k in _mod(TORCH, "index.registry")._CACHE if k[2] == "dense"]
    assert len(dense) == 1 and dense[0][3] == "image_chunk"


def _pipes(cats, **kw):
    return {pkg: _mod(pkg, "pipelines.retrieval.heaven").HEAVENPipeline(cat, **kw, **_kw(pkg))
            for pkg, cat in cats.items()}


class _Empty:
    def search(self, q, k):
        return [[]]


def test_empty_stage1_and_missing_multi_vectors(tmp_path):
    cats = copies(tmp_path)
    pipes = _pipes(cats, stage1_candidate_count=6)
    rng = np.random.default_rng(5)
    single = _unit(rng.standard_normal(DIM))
    multi = _unit(rng.standard_normal((4, DIM)))
    for pkg, pipe in pipes.items():
        pipe_empty = _mod(pkg, "pipelines.retrieval.heaven").HEAVENPipeline(cats[pkg], **_kw(pkg))
        pipe_empty._stage1_index = _Empty
        assert pipe_empty._search("revenue", single, multi, 5) == []
    # no multi-vector for the query, or an empty one: the stage-1 hits
    out = {}
    for pkg, pipe in pipes.items():
        out[pkg] = [pipe._search("t", single, m, 4) for m in (None, np.zeros((0, DIM), np.float32))]
        assert out[pkg][0] == out[pkg][1]
        stage1 = pipe._stage1_index().search(single[None], 6)[0]
        assert [h["doc_id"] for h in out[pkg][0]] == [h.doc_id for h in stage1[:4]]
    assert [h["doc_id"] for h in out[TORCH][0]] == [h["doc_id"] for h in out[JAX][0]]
    np.testing.assert_allclose([h["score"] for h in out[TORCH][0]],
                               [h["score"] for h in out[JAX][0]], atol=1e-6)
    # candidates without a multi-vector (pg0, pg7, ...) score on stage 1 alone
    res = {pkg: pipe._search("revenue growth", single, multi, 6) for pkg, pipe in pipes.items()}
    assert [h["doc_id"] for h in res[TORCH]] == [h["doc_id"] for h in res[JAX]]
    np.testing.assert_allclose([h["score"] for h in res[TORCH]],
                               [h["score"] for h in res[JAX]], atol=1e-6)


def test_stored_query_without_embeddings_raises(tmp_path):
    cats = copies(tmp_path)
    for pkg, cat in cats.items():
        cat.add_queries([{"id": "bare", "contents": "no vectors"}])
        pipe = _mod(pkg, "pipelines.retrieval.heaven").HEAVENPipeline(cat, **_kw(pkg))
        with pytest.raises(_mod(pkg, "exceptions").EmbeddingMissingError, match="single-vector"):
            _mod(TORCH, "utils.concurrency").run_async(pipe._retrieve_by_id("bare", 3))


def test_text_queries_equal(tmp_path):
    cats = copies(tmp_path)
    texts = ["revenue table growth", "of", "chart in q3 sales"]
    out = {}
    for pkg, cat in cats.items():
        emb = _mod(pkg, "embeddings")
        pipe = _mod(pkg, "pipelines.retrieval.heaven").HEAVENPipeline(
            cat, stage1_candidate_count=10,
            single_vector_embedding_model=emb.MockEmbedding(dim=DIM),
            multi_vector_embedding_model=emb.MockMultiVectorEmbedding(dim=DIM, max_tokens=5),
            **_kw(pkg))
        run = _mod(TORCH, "utils.concurrency").run_async
        out[pkg] = [run(pipe.retrieve(t, top_k=5)) for t in texts]
        bare = _mod(pkg, "pipelines.retrieval.heaven").HEAVENPipeline(cat, **_kw(pkg))
        with pytest.raises(_mod(pkg, "exceptions").EmbeddingMissingError, match="both embedding"):
            run(bare.retrieve("x", top_k=3))
    for got, ref in zip(out[TORCH], out[JAX]):
        assert [h["doc_id"] for h in got] == [h["doc_id"] for h in ref]
        np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in ref], atol=1e-6)


@pytest.mark.parametrize("kw,match", [
    ({"stage1_candidate_count": 0}, "positive"),
    ({"stage2_refine_ratio": 0.0}, r"\(0, 1\]"),
    ({"stage2_refine_ratio": 1.5}, r"\(0, 1\]"),
    ({"stage1_weight": -0.1}, r"\[0, 1\]"),
])
def test_parameter_refusals_equal(tmp_path, kw, match):
    cats = copies(tmp_path)
    for pkg, cat in cats.items():
        with pytest.raises(ValueError, match=match):
            _mod(pkg, "pipelines.retrieval.heaven").HEAVENPipeline(cat, **kw)


def test_mesh_refused_and_config_keys(tmp_path):
    """A mesh is taken (stage 1 shards over it, as in the JAX package; the
    search with a mesh is ``tests/test_torch_parallel.py``'s); the config
    keys are the JAX package's."""
    cats = copies(tmp_path)
    heaven = _mod(TORCH, "pipelines.retrieval.heaven")
    mesh = _mod(TORCH, "parallel.mesh").corpus_mesh(devices=["cpu"] * 2)
    assert heaven.HEAVENPipeline(cats[TORCH], mesh=mesh, device="cpu").mesh is mesh
    got = heaven.HEAVENPipeline(cats[TORCH], device="cpu")._get_pipeline_config()
    ref = _mod(JAX, "pipelines.retrieval.heaven").HEAVENPipeline(cats[JAX])._get_pipeline_config()
    assert got == ref
    assert heaven.HEAVENPipeline(cats[TORCH]).device.type == "cuda"  # the default
