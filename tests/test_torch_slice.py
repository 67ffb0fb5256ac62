"""The port's whole dense slice vs the JAX package's, plus its import boundary.

Slice: two catalogs built from one seed (200 chunks, 16 queries, one gold
chunk per query); each package embeds them with the same encoder weights,
runs ``VectorSearchPipeline(index_options={"mode": "verified"}).run(top_k=10)``
and scores recall / ndcg. The persisted (query, doc, score) rows agree (scores
``rtol=1e-5``: encoder outputs differ by ~1e-6 between the frameworks) and
so do the metrics.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, max_len=16, out_dim=32)


def _corpus(seed=0, n_chunks=200, n_queries=16):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    chunks = [" ".join(rng.choice(vocab, size=int(rng.integers(6, 16)))) for _ in range(n_chunks)]
    gold = rng.choice(n_chunks, size=n_queries, replace=False)
    queries = [" ".join(rng.choice(chunks[g].split(), size=5)) for g in gold]
    return chunks, queries, gold


def _run_slice(pkg, tmp_path, params_path):
    """Build, embed, run and score with one package -> (stats, rows, metrics)."""
    import importlib

    Catalog = importlib.import_module(f"{pkg}.store.catalog").Catalog
    gt_mod = importlib.import_module(f"{pkg}.store.gt")
    metrics = importlib.import_module(f"{pkg}.evaluation.metrics.retrieval")
    MetricInput = importlib.import_module(f"{pkg}.schema").MetricInput
    vs = importlib.import_module(f"{pkg}.pipelines.retrieval.vector_search")
    registry = importlib.import_module(f"{pkg}.index.registry")
    if pkg == "autorag_research_tpu":
        from autorag_research_tpu.embeddings.jax_encoder import JaxEncoderEmbedding
        from autorag_research_tpu.models.encoder import EncoderConfig

        embedder = JaxEncoderEmbedding(EncoderConfig(**SMALL), params_path=params_path)
        pipe_kw = {}
    else:
        from autorag_research_tpu_torch.embeddings.torch_encoder import TorchEncoderEmbedding
        from autorag_research_tpu_torch.models.encoder import EncoderConfig

        embedder = TorchEncoderEmbedding(
            EncoderConfig(**SMALL), params_path=params_path, device="cpu"
        )
        pipe_kw = {"device": "cpu"}
    chunks, queries, gold = _corpus()
    (tmp_path / pkg).mkdir()
    cat = Catalog(tmp_path / pkg / "ws.db", embedding_dim=SMALL["out_dim"])
    cat.add_chunks(
        {"id": i, "contents": t, "embedding": e}
        for i, (t, e) in enumerate(zip(chunks, embedder.embed_texts(chunks)))
    )
    cat.add_queries(
        {"id": j, "contents": t, "embedding": e}
        for j, (t, e) in enumerate(zip(queries, embedder.embed_texts(queries)))
    )
    for j, g in enumerate(gold):
        cat.add_retrieval_gt(j, gt_mod.or_all([int(g)]))
    try:
        pipe = vs.VectorSearchPipeline(
            cat, name="dense", index_options={"mode": "verified"}, **pipe_kw
        )
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
        }
        return stats, rows, scores
    finally:
        registry.invalidate(cat)
        cat.close()


def test_whole_slice_matches_jax(tmp_path):
    from autorag_research_tpu.embeddings.jax_encoder import save_params
    from autorag_research_tpu.models.encoder import EncoderConfig, RetrievalEncoder

    params_path = tmp_path / "encoder.npz"
    save_params(RetrievalEncoder(EncoderConfig(**SMALL)).init(11), params_path)
    j_stats, j_rows, j_scores = _run_slice("autorag_research_tpu", tmp_path, params_path)
    t_stats, t_rows, t_scores = _run_slice("autorag_research_tpu_torch", tmp_path, params_path)
    assert t_stats["total_results"] == j_stats["total_results"] == 160
    assert [r[:2] for r in t_rows] == [r[:2] for r in j_rows]
    np.testing.assert_allclose([r[2] for r in t_rows], [r[2] for r in j_rows], rtol=1e-5)
    assert t_scores == j_scores
    assert 0.0 < np.mean(t_scores["recall"]) <= 1.0


_BOUNDARY = r"""
import importlib, pkgutil, sys

sys.modules["jax"] = None
sys.modules["jaxlib"] = None


class _RefuseJaxPackage:
    def find_spec(self, name, path=None, target=None):
        # the port's own name starts with the JAX package's: match exactly
        if name == "autorag_research_tpu" or name.startswith("autorag_research_tpu."):
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, _RefuseJaxPackage())
import autorag_research_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (the smoke script imports nothing of JAX either)

leaked = [m for m in sys.modules if m == "autorag_research_tpu" or m.startswith("autorag_research_tpu.")]
assert not leaked, leaked
print("imported", len(names))
"""


def test_port_imports_without_jax_or_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _BOUNDARY], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 25


@pytest.mark.parametrize("alone", [False, True], ids=["in-repo", "script-alone"])
def test_chip_smoke_refuses_without_cuda_or_package(tmp_path, alone):
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    out = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
