"""The port's whole MaxSim slice vs the JAX package's.

Two catalogs built from one seed (160 chunks, 12 queries with one gold chunk
each, 40 image chunks); each package embeds them with the same multi-vector
encoder weights (saved by the JAX package, loaded by the port through
``from_jax_params``), runs ``VectorSearchPipeline(search_mode="multi")`` in
exact and verified mode and ``ImageVectorSearchPipeline`` over
``image_chunk``, and scores recall / ndcg. The persisted (query, doc, score)
rows agree (scores ``rtol=1e-5``: encoder outputs differ by ~1e-6 between the
frameworks) and so do the metrics; so do the ad-hoc text paths.
"""

import importlib

import numpy as np
import pytest

SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, max_len=16, out_dim=32, multi_vector=True)


def _corpus(seed=0, n_chunks=160, n_queries=12, n_images=40):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(300)]
    chunks = [" ".join(rng.choice(vocab, size=int(rng.integers(4, 16)))) for _ in range(n_chunks)]
    gold = rng.choice(n_chunks, size=n_queries, replace=False)
    queries = [" ".join(rng.choice(chunks[g].split(), size=4)) for g in gold]
    images = [" ".join(rng.choice(vocab, size=int(rng.integers(4, 16)))) for _ in range(n_images)]
    return chunks, queries, gold, images


def _embedder(pkg, params_path):
    if pkg == "autorag_research_tpu":
        from autorag_research_tpu.embeddings.jax_encoder import JaxEncoderMultiVectorEmbedding
        from autorag_research_tpu.models.encoder import EncoderConfig

        return JaxEncoderMultiVectorEmbedding(EncoderConfig(**SMALL), params_path=params_path), {}
    from autorag_research_tpu_torch.embeddings.torch_encoder import TorchEncoderMultiVectorEmbedding
    from autorag_research_tpu_torch.models.encoder import EncoderConfig

    emb = TorchEncoderMultiVectorEmbedding(EncoderConfig(**SMALL), params_path=params_path, device="cpu")
    return emb, {"device": "cpu"}


def _run_slice(pkg, tmp_path, params_path):
    """Build, embed, run and score with one package -> (stats, rows, metrics, adhoc)."""
    Catalog = importlib.import_module(f"{pkg}.store.catalog").Catalog
    gt_mod = importlib.import_module(f"{pkg}.store.gt")
    metrics = importlib.import_module(f"{pkg}.evaluation.metrics.retrieval")
    MetricInput = importlib.import_module(f"{pkg}.schema").MetricInput
    vs = importlib.import_module(f"{pkg}.pipelines.retrieval.vector_search")
    ivs = importlib.import_module(f"{pkg}.pipelines.retrieval.image_vector_search")
    registry = importlib.import_module(f"{pkg}.index.registry")
    embedder, pipe_kw = _embedder(pkg, params_path)
    chunks, queries, gold, images = _corpus()
    (tmp_path / pkg).mkdir()
    cat = Catalog(tmp_path / pkg / "ws.db", embedding_dim=SMALL["out_dim"])
    cat.add_chunks({"id": i, "contents": t} for i, t in enumerate(chunks))
    cat.set_multi_embeddings("chunk", enumerate(embedder.embed_texts_multi(chunks)))
    cat.add_queries({"id": j, "contents": t} for j, t in enumerate(queries))
    cat.set_multi_embeddings("query", enumerate(embedder.embed_texts_multi(queries)))
    cat.add_image_chunks(
        {"id": f"img{i}", "image": t.encode(), "mimetype": "image/png"} for i, t in enumerate(images)
    )
    cat.set_multi_embeddings(
        "image_chunk", [(f"img{i}", m) for i, m in enumerate(embedder.embed_texts_multi(images))]
    )
    for j, g in enumerate(gold):
        cat.add_retrieval_gt(j, gt_mod.or_all([int(g)]))
    try:
        pipes = [
            vs.VectorSearchPipeline(cat, name="mv_exact", search_mode="multi", **pipe_kw),
            vs.VectorSearchPipeline(
                cat, name="mv_verified", search_mode="multi",
                index_options={"mode": "verified"}, **pipe_kw,
            ),
            ivs.ImageVectorSearchPipeline(cat, name="img_mv", search_mode="multi", **pipe_kw),
        ]
        stats, rows, scores = [], [], []
        for pipe in pipes:
            stats.append(pipe.run(top_k=10)["total_results"])
            unit = pipe.retrieval_unit
            got = {j: cat.get_retrieved(j, pipe.pipeline_id, unit) for j in range(len(queries))}
            rows.append([(j, r["doc_id"], r["rel_score"]) for j in got for r in got[j]])
            if unit == "chunk":
                inputs = []
                for j in range(len(queries)):
                    gt, _ = gt_mod.build_retrieval_gt_from_relations(
                        [dict(r) for r in cat.get_relations_by_query(j)]
                    )
                    inputs.append(MetricInput(
                        retrieval_gt=gt, retrieved_ids=[f"chunk_{r['doc_id']}" for r in got[j]]
                    ))
                scores.append({
                    "recall": metrics.retrieval_recall(inputs),
                    "ndcg": metrics.retrieval_ndcg(inputs),
                })
        # the ad-hoc text paths (serving batch, single text, raw embedding)
        pipe = vs.VectorSearchPipeline(
            cat, name="mv_text", search_mode="multi", embedding_model=embedder, **pipe_kw
        )
        adhoc = pipe._retrieve_batch_by_texts(queries[:3], 5)
        from asyncio import run

        adhoc.append(run(pipe._retrieve_by_text(queries[4], 5)))
        adhoc.append(pipe.search_by_embedding(embedder.embed_texts_multi([queries[5]])[0], 5))
        return stats, rows, scores, adhoc
    finally:
        registry.invalidate(cat)
        cat.close()


def _assert_rows_equal(t_rows, j_rows):
    assert [r[:2] for r in t_rows] == [r[:2] for r in j_rows]
    np.testing.assert_allclose([r[2] for r in t_rows], [r[2] for r in j_rows], rtol=1e-5)


def test_whole_maxsim_slice_matches_jax(tmp_path):
    from autorag_research_tpu.embeddings.jax_encoder import save_params
    from autorag_research_tpu.models.encoder import EncoderConfig, RetrievalEncoder

    params_path = tmp_path / "encoder.npz"
    save_params(RetrievalEncoder(EncoderConfig(**SMALL)).init(13), params_path)
    j_stats, j_rows, j_scores, j_adhoc = _run_slice("autorag_research_tpu", tmp_path, params_path)
    t_stats, t_rows, t_scores, t_adhoc = _run_slice("autorag_research_tpu_torch", tmp_path, params_path)
    assert t_stats == j_stats == [120, 120, 120]
    for t, j in zip(t_rows, j_rows):
        _assert_rows_equal(t, j)
    assert t_rows[0] == t_rows[1]  # verified rows = exact rows
    assert t_scores == j_scores
    assert 0.0 < np.mean(t_scores[0]["recall"]) <= 1.0
    assert [[h["doc_id"] for h in r] for r in t_adhoc] == [[h["doc_id"] for h in r] for r in j_adhoc]
    for t, j in zip(t_adhoc, j_adhoc):
        np.testing.assert_allclose([h["score"] for h in t], [h["score"] for h in j], rtol=1e-5)


def test_multi_pipeline_config_and_refusals(tmp_path):
    from autorag_research_tpu_torch.pipelines.retrieval.image_vector_search import (
        ImageVectorSearchPipeline,
    )
    from autorag_research_tpu_torch.pipelines.retrieval.vector_search import VectorSearchPipeline
    from autorag_research_tpu_torch.store.catalog import Catalog

    cat = Catalog(tmp_path / "ws.db", embedding_dim=8)
    pipe = VectorSearchPipeline(cat, name="mv", search_mode="multi", maxsim_prefilter=4, device="cpu")
    assert pipe._get_pipeline_config() == {
        "type": "vector_search", "search_mode": "multi", "retrieval_unit": "chunk",
        "table": "chunk", "index_type": "exact", "index_options": {}, "maxsim_prefilter": 4,
    }
    img = ImageVectorSearchPipeline(cat, search_mode="multi", device="cpu")
    assert (img.retrieval_unit, img._get_pipeline_config()["type"]) == ("image_chunk", "image_vector_search")
    with pytest.raises(ValueError):
        VectorSearchPipeline(cat, name="x", search_mode="sparse", device="cpu")
    with pytest.raises(NotImplementedError):
        VectorSearchPipeline(cat, name="y", index_type="ivf", device="cpu")
    cat.close()
