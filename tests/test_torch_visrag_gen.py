"""The port's ``visrag_gen`` and config #5 (ViDoRe pages) against the JAX package.

Mirrors ``tests/test_multimodal_e2e.py`` and the VisRAG cases of
``tests/test_generation_agents.py``: both packages' ``Executor``s (the
port's with ``BuildContext(device="cpu")``) run image retrieval in single
and multi mode and ``visrag_gen`` on copies of one catalog, with the same
page-reading mock VLM. The image result rows (ids equal, scores within 1e-6),
the executor rows (text, token usage, metadata), the images each VLM
received and the metric averages are equal. ``TorchLM``, like ``JaxLM``,
ignores ``images=``: on one ``JaxLM.save`` checkpoint both answer the
``visrag_gen`` prompt with the same text. Config #5's recipe
(``tests/test_parity_recipes.py``: ``ingest --name vidorev2 ...
--late-interaction``, then ``run`` with ``image_vector_search`` in multi
mode) runs through both CLIs without ``--mesh``: the catalogs and the
rankings are equal, and ``heaven`` / ``visrag_gen`` resolve from the
``init`` templates.
"""

import importlib
import io
import json
import shutil
import sqlite3
from pathlib import Path

import numpy as np
import pytest

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)
DIM = 24
SMALL = dict(hidden=32, layers=2, heads=2, max_len=256)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _kw(pkg):
    return {"device": "cpu"} if pkg == TORCH else {}


def _run(coro):
    return _mod(TORCH, "utils.concurrency").run_async(coro)


@pytest.fixture(autouse=True)
def clear_cache():
    for pkg in PKGS:
        _mod(pkg, "index.registry").invalidate()
    yield
    for pkg in PKGS:
        _mod(pkg, "index.registry").invalidate()


def _png(w, h, color):
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (w, h), color).save(buf, format="PNG")
    return buf.getvalue()


PAGES = [f"page image bytes {i}".encode() for i in range(6)]


def _mm_catalog(cat, pages=PAGES):
    """``tests/test_multimodal_e2e.py``'s catalog: six pages, two queries
    whose embeddings point at their gold pages."""
    emb = _mod(TORCH, "embeddings").MockEmbedding(dim=DIM)
    memb = _mod(TORCH, "embeddings").MockMultiVectorEmbedding(dim=DIM, max_tokens=5)
    svc = _mod(TORCH, "store.ingestion").IngestionService(cat)
    svc.add_image_chunks([{"id": f"pg{i}", "image": img, "mimetype": "image/png"}
                          for i, img in enumerate(pages)])
    svc.add_queries([
        {"id": "q0", "contents": "what is on page two", "generation_gt": ["chart on page two"]},
        {"id": "q1", "contents": "what is on page five", "generation_gt": ["table on page five"]},
    ])
    svc.add_retrieval_gt("q0", "pg2", chunk_type="image")
    svc.add_retrieval_gt("q1", "pg5", chunk_type="image")
    cat.set_embeddings("image_chunk", [(f"pg{i}", emb.embed_images([p])[0]) for i, p in enumerate(pages)])
    cat.set_multi_embeddings("image_chunk", [(f"pg{i}", memb.embed_images_multi([p])[0])
                                             for i, p in enumerate(pages)])
    cat.set_embeddings("query", [("q0", emb.embed_images([pages[2]])[0]),
                                 ("q1", emb.embed_images([pages[5]])[0])])
    cat.set_multi_embeddings("query", [("q0", memb.embed_images_multi([pages[2]])[0]),
                                       ("q1", memb.embed_images_multi([pages[5]])[0])])


def copies(tmp_path, build=_mm_catalog):
    src = tmp_path / "src.db"
    cat = _mod(TORCH, "store.catalog").Catalog(src, embedding_dim=DIM)
    build(cat)
    cat.close()
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir(exist_ok=True)
        shutil.copy(src, tmp_path / pkg / "mm.db")
        out[pkg] = _mod(pkg, "store.catalog").Catalog(tmp_path / pkg / "mm.db", embedding_dim=DIM)
    return out


def page_vlm(pkg, seen):
    """Answers from the page image bytes it receives (the JAX test's VLM)."""
    llm = _mod(pkg, "llm")

    class PageVLM(llm.MockLLM):
        async def agenerate(self, prompt, images=None, **kw):
            seen.append((prompt, list(images or [])))
            if images and b"2" in images[0]:
                text = "chart on page two"
            elif images and b"5" in images[0]:
                text = "table on page five"
            else:
                text = "unknown page"
            return llm.LLMResult(text=text, token_usage={"prompt_tokens": 2, "completion_tokens": 3,
                                                         "total_tokens": 5})

    return PageVLM()


def executor_rows(cat, pipeline_id):
    with sqlite3.connect(cat.path) as conn:
        rows = conn.execute(
            "SELECT query_id, generation_result, token_usage, result_metadata FROM executor_result "
            "WHERE pipeline_id = ? ORDER BY query_id", (pipeline_id,)).fetchall()
    return [(q, text, json.loads(usage), json.loads(meta)) for q, text, usage, meta in rows]


def run_e2e(cats, llm_for, max_images=1, retriever="ivs_single", mode="multi_image", top_k=2):
    out = {}
    for pkg, cat in cats.items():
        cfg = _mod(pkg, "config")
        ivs = _mod(pkg, "pipelines.retrieval.image_vector_search").ImageVectorSearchConfig
        config = cfg.ExecutorConfig(
            pipelines=[
                ivs(name="ivs_single", search_mode="single", top_k=top_k),
                ivs(name="ivs_multi", search_mode="multi", top_k=top_k),
                _mod(pkg, "pipelines.generation.visrag_gen").VisRAGGenConfig(
                    name="visrag", retrieval_pipeline_name=retriever, llm=llm_for(pkg),
                    top_k=top_k, max_images=max_images, image_processing_mode=mode),
            ],
            metrics=[cfg.BaseMetricConfig(name="recall", metric_type="retrieval"),
                     cfg.BaseMetricConfig(name="exact_match", metric_type="generation")],
            health_check=True, health_check_queries=1,
        )
        result = _mod(pkg, "executor").Executor(cat, config, cfg.BuildContext(**_kw(pkg))).run()
        assert result.success, result.report()
        res = {}
        for p in result.pipelines:
            pid = p.stats["pipeline_id"]
            rows = {q: [(r["doc_id"], r["rel_score"]) for r in cat.get_retrieved(q, pid, "image_chunk")]
                    for q in ("q0", "q1")}
            res[p.name] = (rows, {m.metric_name: m.average for m in p.metrics},
                           executor_rows(cat, pid))
        out[pkg] = res
    return out


def assert_equal_runs(out):
    got, ref = out[TORCH], out[JAX]
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name][1] == ref[name][1], name
        assert got[name][2] == ref[name][2], name
        for q in ref[name][0]:
            assert [d for d, _ in got[name][0][q]] == [d for d, _ in ref[name][0][q]], (name, q)
            np.testing.assert_allclose([s for _, s in got[name][0][q]],
                                       [s for _, s in ref[name][0][q]], rtol=0, atol=1e-6)


@pytest.mark.parametrize("retriever", ["ivs_single", "ivs_multi"])
def test_multimodal_executor_end_to_end_equal(tmp_path, retriever):
    seen = {pkg: [] for pkg in PKGS}
    out = run_e2e(copies(tmp_path), lambda pkg: page_vlm(pkg, seen[pkg]), retriever=retriever)
    assert_equal_runs(out)
    assert seen[TORCH] == seen[JAX]
    got = out[TORCH]
    assert got["ivs_single"][1]["recall"] == got["ivs_multi"][1]["recall"] == 1.0
    assert got["visrag"][1] == {"recall": 1.0, "exact_match": 1.0}
    q0 = got["visrag"][2][0]
    assert q0[1] == "chart on page two" and q0[3]["image_chunk_ids"] == ["pg2"]
    # the generation pipeline's retrieval lands in the image result table
    assert got["visrag"][0]["q0"][0][0] == "pg2"


@pytest.mark.parametrize("max_images", [1, 3, 10])
def test_images_passed_equal(tmp_path, max_images):
    """The VLM receives the top pages' bytes, at most ``max_images``."""
    seen = {pkg: [] for pkg in PKGS}
    out = run_e2e(copies(tmp_path), lambda pkg: page_vlm(pkg, seen[pkg]), max_images=max_images,
                  top_k=4)
    assert_equal_runs(out)
    assert seen[TORCH] == seen[JAX]
    assert all(len(imgs) == min(max_images, 4) for _, imgs in seen[TORCH])
    assert seen[TORCH][-1][0].startswith("Answer the question using the attached page images.")


@pytest.mark.parametrize("direction", ["horizontal", "vertical"])
def test_concatenate_mode_equal(tmp_path, direction):
    """``image_processing_mode="concatenate"``: one composite image, the same
    PNG bytes in both packages."""
    pngs = [_png(8 + i, 6 + 2 * i, (40 * i, 0, 0)) for i in range(6)]
    seen = {pkg: [] for pkg in PKGS}
    cats = copies(tmp_path, lambda cat: _mm_catalog(cat, pngs))
    for pkg, cat in cats.items():
        gen = _mod(pkg, "pipelines.generation.visrag_gen").VisRAGGenerationPipeline(
            cat, "vr_cc", llm=page_vlm(pkg, seen[pkg]), max_images=3,
            image_processing_mode="concatenate", concatenation_direction=direction,
            retrieval_pipeline=_mod(pkg, "pipelines.retrieval.image_vector_search")
            .ImageVectorSearchPipeline(cat, "ivs_cc", **_kw(pkg)))
        res = _run(gen._generate("q0", 3))
        assert res.metadata["image_chunk_ids"] == [h["doc_id"] for h in res.retrieved][:3]
    assert seen[TORCH] == seen[JAX]
    assert len(seen[TORCH][0][1]) == 1 and seen[TORCH][0][1][0][:8] == b"\x89PNG\r\n\x1a\n"


def test_refusals_and_config_keys(tmp_path):
    cats = copies(tmp_path)
    for pkg, cat in cats.items():
        with pytest.raises(ValueError, match="image_processing_mode"):
            _mod(pkg, "pipelines.generation.visrag_gen").VisRAGGenerationPipeline(
                cat, image_processing_mode="tiles")
    configs = [_mod(pkg, "pipelines.generation.visrag_gen").VisRAGGenerationPipeline(
        cat, llm=_mod(pkg, "llm").MockLLM())._get_pipeline_config() for pkg, cat in cats.items()]
    assert configs[0] == configs[1]


def test_torch_lm_ignores_images_like_jax_lm(tmp_path):
    """``visrag_gen`` over a real decoder: ``TorchLM`` and ``JaxLM`` on one
    checkpoint drop ``images=`` and answer the same prompt identically."""
    from autorag_research_tpu.llm import JaxLM
    from autorag_research_tpu.models.decoder import DecoderConfig as JCfg
    from autorag_research_tpu_torch.llm import TorchLM
    from autorag_research_tpu_torch.models.decoder import DecoderConfig

    path = str(tmp_path / "lm.npz")
    JaxLM(config=JCfg(**SMALL), max_prompt_len=128, max_new_tokens=12, seed=3).save(path)
    lms = {JAX: JaxLM(config=JCfg(**SMALL), max_prompt_len=128, max_new_tokens=12, checkpoint=path),
           TORCH: TorchLM(DecoderConfig(**SMALL), max_prompt_len=128, max_new_tokens=12,
                          checkpoint=path, device="cpu")}
    for lm in lms.values():
        with_images = _run(lm.agenerate("Question: what is shown?", images=[b"\x89PNGx"]))
        assert with_images.text == _run(lm.agenerate("Question: what is shown?")).text
    out = run_e2e(copies(tmp_path), lambda pkg: lms[pkg], max_images=3)
    assert_equal_runs(out)
    assert all(r[2]["completion_tokens"] > 0 for r in out[TORCH]["visrag"][2])


# ------------------------------------------------------- config #5's recipe


def _vidore_snapshot(root: Path):
    """``tests/test_parity_recipes.py``'s ViDoRe v2 snapshot."""
    import datasets
    from PIL import Image

    rng = np.random.default_rng(0)
    imgs = [Image.fromarray(rng.integers(0, 255, size=(8, 8, 3), dtype=np.uint8)) for _ in range(5)]
    datasets.Dataset.from_dict({"corpus-id": [f"p{i}" for i in range(5)], "image": imgs}) \
        .cast_column("image", datasets.Image()).save_to_disk(str(root / "corpus"))
    datasets.Dataset.from_dict({"query-id": [f"q{i}" for i in range(2)],
                                "query": [f"what is on page {i}" for i in range(2)]}) \
        .save_to_disk(str(root / "queries"))
    datasets.Dataset.from_dict({"query-id": ["q0", "q1"], "corpus-id": ["p0", "p3"],
                                "score": [1, 1]}).save_to_disk(str(root / "qrels"))
    return root


def test_config5_recipe_through_both_clis(tmp_path, monkeypatch, capsys):
    """``ingest --name vidorev2 --late-interaction`` then ``run`` of
    ``image_vector_search`` (multi) and ``heaven`` from the ``init``
    templates, through each package's CLI in a directory of its own: equal
    catalogs and rankings, and both reports list the pipelines."""
    from autorag_research_tpu.cli.app import main as jax_main
    from autorag_research_tpu_torch.cli.app import main as torch_main

    snap = _vidore_snapshot(tmp_path / "vidore_v2")
    mains = {JAX: jax_main, TORCH: lambda argv: torch_main(["--device", "cpu", *argv])}
    rows, dumps = {}, {}
    for pkg, main in mains.items():
        work = tmp_path / pkg
        work.mkdir()
        monkeypatch.chdir(work)
        assert main(["init"]) == 0
        (work / "configs" / "embedding" / "mock_multi.yaml").write_text(
            "type: mock_multi\ndim: 16\nmax_tokens: 4\n")
        assert main(["ingest", "--name", "vidorev2", "--db", "ws", "--extra", f"data_dir={snap}",
                     "--embedding-model", "mock_multi", "--late-interaction"]) == 0
        (work / "configs" / "pipelines" / "retrieval" / "image_vector_search.yaml").write_text(
            "type: image_vector_search\nsearch_mode: multi\ntop_k: 5\n")
        (work / "configs" / "experiment.yaml").write_text(
            "pipelines:\n  retrieval:\n    - image_vector_search\n  generation: []\n"
            "metrics:\n  retrieval:\n    - recall\n    - ndcg\n  generation: []\n"
            "executor:\n  health_check: true\n  health_check_queries: 1\n")
        assert main(["run", "--db", "ws"]) == 0
        assert main(["report", "--db", "ws", "--html", "report.html"]) == 0
        out = capsys.readouterr().out
        assert "image_vector_search" in out and "recall" in out
        cat = _mod(pkg, "store.catalog").Catalog(work / "ws" / "catalog.db")
        pid = cat.get_pipeline("image_vector_search")["id"]
        rows[pkg] = {q: [(r["doc_id"], r["rel_score"]) for r in cat.get_retrieved(q, pid, "image_chunk")]
                     for q in ("q0", "q1")}
        with sqlite3.connect(work / "ws" / "catalog.db") as conn:
            dumps[pkg] = {t: conn.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                          for t in ("image_chunk", "query", "retrieval_relation")}
        resolver = _mod(pkg, "cli.config_resolver").ConfigResolver(work / "configs")
        assert resolver.resolve_pipeline("retrieval", "heaven").name == "heaven"
        assert resolver.resolve_pipeline("generation", "visrag_gen").name == "visrag_gen"
    assert dumps[TORCH] == dumps[JAX]
    for q in rows[JAX]:
        assert [d for d, _ in rows[TORCH][q]] == [d for d, _ in rows[JAX][q]], q
        np.testing.assert_allclose([s for _, s in rows[TORCH][q]], [s for _, s in rows[JAX][q]],
                                   rtol=0, atol=1e-6)
    assert len(rows[TORCH]["q0"]) == 5
