"""The port's ingestion layer against the JAX package's, case by case.

Covers ``tests/test_data_ingest.py`` for the ported ingestors (``local``,
``synthetic``) and the embedding loop: each case runs through both
packages on catalogs of their own and the catalogs are compared table by
table, every column of every row (``dump``). The synthetic ingestor is a
pure function of (seed, n_docs, n_queries) in both packages, so its
catalogs are equal row for row at ``scripts/parity_run.py``'s smoke scale
(300 docs, 20 queries) for three seeds. Embedding blobs written from the
same float32 vectors are byte-identical; the port's ``torch_encoder`` on the
JAX encoder's weights (carried over with ``params_path``) writes vectors
within 1e-5 of ``jax_encoder``'s. The embedding cases of the JAX BEIR tests
run here on the same fixture through ``local``; every other ingestor of the
JAX registry resolves to the port's own class. The text ingestors are held
against the JAX package in ``tests/test_torch_text_ingestors.py``, the
visual-document ones in ``tests/test_torch_mm_ingestors.py``.
"""

import importlib
import json
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)
SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, max_len=16, out_dim=32)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def dump(path) -> dict[str, list[tuple]]:
    """Every row of every table, in rowid order."""
    with sqlite3.connect(path) as conn:
        tables = [r[0] for r in conn.execute("SELECT name FROM sqlite_master WHERE type='table'")]
        return {t: conn.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                for t in tables if t != "sqlite_sequence"}


def ingest(pkg, name, db, embedding_model=None, embed=True, **kw):
    """Ingest through ``pkg``'s registry into a fresh catalog at ``db``."""
    info = _mod(pkg, "data.registry").get_ingestor(name)
    cat = _mod(pkg, "store.catalog").Catalog(db)
    ing = info.cls(embedding_model=embedding_model, **kw)
    ing.set_service(_mod(pkg, "store.ingestion").IngestionService(cat))
    ing.ingest()
    stats = ing.embed_all() if embed and embedding_model is not None else None
    cat.close()
    return stats


def _local_dir(tmp_path, n_docs=20, n_queries=6):
    """The BEIR fixture of ``tests/test_data_ingest.py`` as local JSONL."""
    d = tmp_path / "local"
    d.mkdir()
    docs = [{"id": f"doc{i}", "contents": f"Title {i} body text {i} topic {i % 3}"}
            for i in range(n_docs)]
    (d / "corpus.jsonl").write_text("\n".join(json.dumps(x) for x in docs))
    queries = [{"id": f"q{i}", "contents": f"question about topic {i}",
                "gt": [[f"doc{i}", f"doc{i + 10}"]], "generation_gt": [f"ans {i}"]}
               for i in range(n_queries)]
    (d / "queries.jsonl").write_text("\n".join(json.dumps(x) for x in queries))
    return d


@pytest.mark.parametrize("seed", [0, 42, 7])
def test_synthetic_catalogs_equal_row_for_row(tmp_path, seed):
    out = {}
    for pkg in PKGS:
        ingest(pkg, "synthetic", tmp_path / f"{pkg}.db", n_docs=300, n_queries=20, seed=seed)
        out[pkg] = dump(tmp_path / f"{pkg}.db")
    assert out[TORCH] == out[JAX]
    assert len(out[TORCH]["chunk"]) == 300 and len(out[TORCH]["query"]) == 20
    assert out[TORCH]["retrieval_relation"]  # AND/OR GT written
    assert {r[1] for r in out[TORCH]["retrieval_relation"]} == {0, 1}  # some AND groups


@pytest.mark.parametrize("subset,limit,min_cnt", [("dev", 5, None), ("test", None, 350)])
def test_synthetic_subset_and_limits_equal(tmp_path, subset, limit, min_cnt):
    out = {}
    for pkg in PKGS:
        info = _mod(pkg, "data.registry").get_ingestor("zipf")  # the alias
        cat = _mod(pkg, "store.catalog").Catalog(tmp_path / f"{pkg}.db")
        ing = info.cls(n_docs=300, n_queries=20)
        ing.set_service(_mod(pkg, "store.ingestion").IngestionService(cat))
        ing.ingest(subset=subset, query_limit=limit, min_corpus_cnt=min_cnt)
        cat.close()
        out[pkg] = dump(tmp_path / f"{pkg}.db")
    assert out[TORCH] == out[JAX]


def test_local_jsonl_catalogs_equal(tmp_path):
    d = _local_dir(tmp_path)
    out = {pkg: (ingest(pkg, "local", tmp_path / f"{pkg}.db", data_dir=str(d)),
                 dump(tmp_path / f"{pkg}.db"))[1] for pkg in PKGS}
    assert out[TORCH] == out[JAX]
    assert len(out[TORCH]["chunk"]) == 20 and len(out[TORCH]["query"]) == 6


def test_local_jsonl_and_of_or_groups(tmp_path):
    """``TestLocalIngestor::test_local_jsonl`` through both packages."""
    d = tmp_path / "local"
    d.mkdir()
    (d / "corpus.jsonl").write_text(
        "\n".join(json.dumps({"id": i, "contents": f"doc {i}"}) for i in range(4))
    )
    (d / "queries.jsonl").write_text(
        json.dumps({"id": 100, "contents": "q", "gt": [[0, 1], [2]], "generation_gt": ["ans"]})
    )
    gts = {}
    for pkg in PKGS:
        ingest(pkg, "local", tmp_path / f"{pkg}.db", data_dir=str(d))
        cat = _mod(pkg, "store.catalog").Catalog(tmp_path / f"{pkg}.db")
        assert cat.count("chunk") == 4
        gts[pkg], _ = _mod(pkg, "store.gt").build_retrieval_gt_from_relations(
            [dict(r) for r in cat.get_relations_by_query(100)]
        )
        cat.close()
    assert gts[TORCH] == gts[JAX] == [["chunk_0", "chunk_1"], ["chunk_2"]]


def test_local_missing_dir_raises(tmp_path):
    for pkg in PKGS:
        info = _mod(pkg, "data.registry").get_ingestor("local")
        with pytest.raises(_mod(pkg, "exceptions").IngestionError):
            info.cls(data_dir=str(tmp_path / "nope"))


def test_mock_embed_all_blobs_identical(tmp_path):
    """``TestBEIR::test_embed_all`` on the same fixture through ``local``:
    counts, dimension, resume, and byte-identical blobs."""
    d = _local_dir(tmp_path)
    for pkg in PKGS:
        emb = _mod(pkg, "embeddings").MockEmbedding(dim=16)
        cat = _mod(pkg, "store.catalog").Catalog(tmp_path / f"{pkg}.db")
        ing = _mod(pkg, "data.registry").get_ingestor("local").cls(
            embedding_model=emb, data_dir=str(d))
        ing.set_service(_mod(pkg, "store.ingestion").IngestionService(cat))
        ing.ingest()
        stats = ing.embed_all(batch_size=7)
        assert stats["chunk"].embedded == 20 and stats["query"].embedded == 6
        assert cat.embedding_dim == 16 and cat.count_unembedded("chunk") == 0
        assert ing.embed_all()["chunk"].embedded == 0  # resume: a no-op
        cat.close()
    assert dump(tmp_path / f"{TORCH}.db") == dump(tmp_path / f"{JAX}.db")


def test_late_interaction_blobs_identical(tmp_path):
    """``TestBEIR::test_embed_late_interaction`` through ``local``."""
    d = _local_dir(tmp_path)
    mats = {}
    for pkg in PKGS:
        emb = _mod(pkg, "embeddings").MockMultiVectorEmbedding(dim=16)
        cat = _mod(pkg, "store.catalog").Catalog(tmp_path / f"{pkg}.db")
        ing = _mod(pkg, "data.registry").get_ingestor("local").cls(
            embedding_model=emb, data_dir=str(d))
        ing.set_service(_mod(pkg, "store.ingestion").IngestionService(cat))
        ing.ingest(query_limit=2)
        stats = ing.embed_all_late_interaction(batch_size=4)
        assert stats["chunk"].embedded == 20
        ids, m = cat.get_embeddings_matrix("chunk", multi=True)
        assert len(ids) == 20 and m[0].shape[1] == 16
        mats[pkg] = (ids, m)
        cat.close()
    assert mats[TORCH][0] == mats[JAX][0]
    for a, b in zip(mats[TORCH][1], mats[JAX][1]):
        np.testing.assert_array_equal(a, b)
    assert dump(tmp_path / f"{TORCH}.db") == dump(tmp_path / f"{JAX}.db")


def test_bag_of_tokens_embeddings_equal(tmp_path):
    """The synthetic fixture's two embedders, both packages: single-vector
    blobs byte-identical, token matrices equal."""
    texts = ["w1 w2 topic0sig0_w1500", "", "w3 W3 w3", "a b c d e f g h i j k l m n o p q r"]
    for cls, call in (("BagOfTokensEmbedding", "embed_texts"),
                      ("BagOfTokensMultiVectorEmbedding", "embed_texts_multi")):
        j = getattr(getattr(_mod(JAX, "data.synthetic"), cls)(), call)(texts)
        t = getattr(getattr(_mod(TORCH, "data.synthetic"), cls)(), call)(texts)
        for a, b in zip(t, j):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _flaky(pkg):
    class FlakyEmbedding(_mod(pkg, "embeddings").MockEmbedding):
        def embed_texts(self, texts):
            if any("poison" in t for t in texts):
                raise RuntimeError("bad input")
            return super().embed_texts(texts)

    return FlakyEmbedding


def _quarantine_catalog(pkg, path):
    cat = _mod(pkg, "store.catalog").Catalog(path)
    cat.add_chunks([{"id": 1, "contents": "fine"}, {"id": 2, "contents": "poison pill"},
                    {"id": 3, "contents": "also fine"}])
    return cat


def test_failing_rows_are_quarantined(tmp_path):
    """``TestEmbedQuarantine``: both packages quarantine the same row and
    write the same blobs."""
    for pkg in PKGS:
        cat = _quarantine_catalog(pkg, tmp_path / f"{pkg}.db")
        stats = _mod(pkg, "store.ingestion").IngestionService(cat).embed_table(
            _flaky(pkg)(dim=8), "chunk", batch_size=10)
        assert stats.embedded == 2 and stats.failed_ids == [2]
        assert cat.count_unembedded("chunk") == 1
        cat.close()
    assert dump(tmp_path / f"{TORCH}.db") == dump(tmp_path / f"{JAX}.db")


def _device_embedding(pkg):
    """A mock with the device hot path, as ``TestPipelinedEmbedLoop`` has
    it: a ``jnp`` array for the JAX package, a tensor for the port."""

    class DeviceEmbedding(_mod(pkg, "embeddings").MockEmbedding):
        def __init__(self, dim=8):
            super().__init__(dim=dim)
            self.device_calls = 0

        def embed_texts_device(self, texts):
            self.device_calls += 1
            vecs = np.asarray(self.embed_texts(texts))
            return jnp.asarray(vecs) if pkg == JAX else torch.from_numpy(vecs)

    return DeviceEmbedding


def test_pipelined_equals_sync_and_jax(tmp_path):
    rows = [{"id": i, "contents": f"text number {i}"} for i in range(23)]
    for pkg in PKGS:
        cat = _mod(pkg, "store.catalog").Catalog(tmp_path / f"{pkg}.db")
        cat.add_chunks(rows)
        emb = _device_embedding(pkg)(dim=8)
        stats = _mod(pkg, "store.ingestion").IngestionService(cat).embed_table(
            emb, "chunk", batch_size=5)
        assert stats.embedded == 23 and not stats.failed_ids
        assert emb.device_calls == 5  # the pipelined path ran
        cat.close()
    sync = _mod(TORCH, "store.catalog").Catalog(tmp_path / "sync.db")
    sync.add_chunks(rows)
    _mod(TORCH, "store.ingestion").IngestionService(sync).embed_table(
        _mod(TORCH, "embeddings").MockEmbedding(dim=8), "chunk", batch_size=5)
    sync.close()
    assert dump(tmp_path / f"{TORCH}.db") == dump(tmp_path / f"{JAX}.db") == dump(tmp_path / "sync.db")


def test_pipelined_dispatch_failure_quarantines_per_item(tmp_path):
    for pkg in PKGS:
        base = _device_embedding(pkg)

        class Flaky(base):
            def embed_texts_device(self, texts):
                if any("poison" in t for t in texts):
                    raise RuntimeError("bad batch")
                return super().embed_texts_device(texts)

            def embed_texts(self, texts):
                if any("poison" in t for t in texts):
                    raise RuntimeError("bad item")
                return super().embed_texts(texts)

        cat = _quarantine_catalog(pkg, tmp_path / f"{pkg}.db")
        stats = _mod(pkg, "store.ingestion").IngestionService(cat).embed_table(
            Flaky(dim=8), "chunk", batch_size=10)
        assert stats.embedded == 2 and stats.failed_ids == [2]
        assert cat.count_unembedded("chunk") == 1
        cat.close()
    assert dump(tmp_path / f"{TORCH}.db") == dump(tmp_path / f"{JAX}.db")


def test_pipelined_resume_skips_existing(tmp_path):
    for pkg in PKGS:
        cat = _mod(pkg, "store.catalog").Catalog(tmp_path / f"{pkg}.db")
        cat.add_chunks([{"id": i, "contents": f"t{i}"} for i in range(9)])
        emb = _device_embedding(pkg)(dim=8)
        service = _mod(pkg, "store.ingestion").IngestionService
        service(cat).embed_table(emb, "chunk", batch_size=4, max_batches=1)
        assert cat.count_unembedded("chunk") == 5
        assert service(cat).embed_table(emb, "chunk", batch_size=4).embedded == 5
        assert cat.count_unembedded("chunk") == 0
        cat.close()
    assert dump(tmp_path / f"{TORCH}.db") == dump(tmp_path / f"{JAX}.db")


def test_encoder_embed_all_matches_jax_encoder(tmp_path):
    """``embed_all`` with the port's ``torch_encoder`` (on the CPU, through
    the pipelined path) against the JAX package's ``jax_encoder`` on the same
    weights: vectors within 1e-5, every other column equal."""
    from autorag_research_tpu.embeddings.jax_encoder import JaxEncoderEmbedding, save_params
    from autorag_research_tpu.models import encoder as jenc
    from autorag_research_tpu_torch.embeddings.torch_encoder import TorchEncoderEmbedding
    from autorag_research_tpu_torch.models import encoder as tenc

    params = tmp_path / "enc.npz"
    save_params(jenc.RetrievalEncoder(jenc.EncoderConfig(**SMALL)).init(11), params)
    models = {
        JAX: JaxEncoderEmbedding(jenc.EncoderConfig(**SMALL), params_path=params, batch_size=32),
        TORCH: TorchEncoderEmbedding(tenc.EncoderConfig(**SMALL), params_path=params,
                                     batch_size=32, device="cpu"),
    }
    mats = {}
    for pkg in PKGS:
        stats = ingest(pkg, "synthetic", tmp_path / f"{pkg}.db", embedding_model=models[pkg],
                       n_docs=300, n_queries=20)
        assert stats["chunk"].embedded == 300 and stats["query"].embedded == 20
        cat = _mod(pkg, "store.catalog").Catalog(tmp_path / f"{pkg}.db")
        mats[pkg] = {t: cat.get_embeddings_matrix(t) for t in ("chunk", "query")}
        cat.close()
    for table in ("chunk", "query"):
        assert mats[TORCH][table][0] == mats[JAX][table][0]
        np.testing.assert_allclose(mats[TORCH][table][1], mats[JAX][table][1], atol=1e-5)
    strip = {t: [r[:4] for r in rows] if t in ("chunk", "query") else rows
             for t, rows in dump(tmp_path / f"{TORCH}.db").items()}
    ref = {t: [r[:4] for r in rows] if t in ("chunk", "query") else rows
           for t, rows in dump(tmp_path / f"{JAX}.db").items()}
    assert strip == ref


def test_registry_params_and_listing():
    """The port lists every ingestor of the JAX registry (the text ones
    since the port of ROADMAP.md item 7)."""
    infos = {i.name for i in _mod(TORCH, "data.registry").list_ingestors()}
    assert infos == {i.name for i in _mod(JAX, "data.registry").list_ingestors()} == {
        "local", "synthetic", "vidore", "vidorev2", "vidorev3", "visrag", "sds_kopub_vdr",
        "kovidorev2", "beir", "text_mteb", "ragbench", "mrtydi", "bright", "crag",
        "open_ragbench"}
    local = _mod(TORCH, "data.registry").get_ingestor("local")
    assert {p.name for p in local.params} == {"data_dir"}
    jsyn = _mod(JAX, "data.registry").get_ingestor("synthetic")
    tsyn = _mod(TORCH, "data.registry").get_ingestor("synthetic")
    assert [(p.name, p.default, p.required) for p in tsyn.params] == [
        (p.name, p.default, p.required) for p in jsyn.params
    ]


@pytest.mark.parametrize("name", ["beir", "bright", "crag", "kovidorev2", "mrtydi",
                                  "open_ragbench", "ragbench", "sds_kopub_vdr", "text_mteb",
                                  "vidore", "vidorev2", "vidorev3", "visrag"])
def test_network_ingestors_refused(name):
    """Once refused (ROADMAP.md items 7 and 8), every one is ported now: it
    resolves to the port's own class, with the JAX ingestor's parameters."""
    info = _mod(TORCH, "data.registry").get_ingestor(name)
    ref = _mod(JAX, "data.registry").get_ingestor(name)
    assert info.name == name and info.cls.__module__.startswith(f"{TORCH}.data.")
    assert [p.name for p in info.params] == [p.name for p in ref.params]


def test_fetch_unembedded_after_id_walks_from_the_cursor(tmp_path):
    """``after_id`` starts the id-ordered walk past the cursor (string ids
    sort after integer ones, as ``ORDER BY id`` has them); without it the
    fetch is the JAX package's."""
    rows = [{"id": i, "contents": f"t{i}"} for i in range(6)] + [
        {"id": f"s{i}", "contents": f"s{i}"} for i in range(3)]
    got = {}
    for pkg in PKGS:
        cat = _mod(pkg, "store.catalog").Catalog(tmp_path / f"{pkg}.db")
        cat.add_chunks(rows)
        got[pkg] = [r["id"] for r in cat.fetch_unembedded("chunk", 4, exclude_ids=[1])]
        cat.close()
    assert got[TORCH] == got[JAX] == [0, 2, 3, 4]
    cat = _mod(TORCH, "store.catalog").Catalog(tmp_path / f"{TORCH}.db")
    assert [r["id"] for r in cat.fetch_unembedded("chunk", 4, after_id=3)] == [4, 5, "s0", "s1"]
    assert [r["id"] for r in cat.fetch_unembedded("chunk", 4, after_id="s1")] == ["s2"]
    cat.close()
