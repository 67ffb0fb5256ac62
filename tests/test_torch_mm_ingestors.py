"""The port's visual-document ingestors against the JAX package's.

Each case builds a local ``datasets.save_to_disk`` snapshot (or the in-memory
``data=`` mapping the JAX tests use, ``tests/test_hf_ingestors.py``) from
seeded page images, ingests it through both packages' registries into
catalogs of their own, and compares the catalogs table by table, every column
of every row: the same pages (PNG bytes), queries, GT groups and graded
scores, and the same file / document / page hierarchy. Embedding through the
multimodal base (single- and multi-vector, ``image=True``) writes
byte-identical blobs from the mock embedders. ``data/hf_util.py``'s helpers
give the same samples and raise the same ``IngestionError``s.
"""

import importlib
import sqlite3
import sys

import numpy as np
import pytest

datasets = pytest.importorskip("datasets")
Image = pytest.importorskip("PIL.Image")

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)
NAMES = ("vidore", "vidorev2", "vidorev3", "visrag", "sds_kopub_vdr", "kovidorev2")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def dump(path) -> dict[str, list[tuple]]:
    with sqlite3.connect(path) as conn:
        tables = [r[0] for r in conn.execute("SELECT name FROM sqlite_master WHERE type='table'")]
        return {t: conn.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                for t in tables if t != "sqlite_sequence"}


def _pages(n, seed):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 255, size=(6 + i % 3, 5, 3), dtype=np.uint8))
            for i in range(n)]


def _save(root, name, columns, image_col=None):
    ds = datasets.Dataset.from_dict(columns)
    if image_col:
        ds = ds.cast_column(image_col, datasets.Image())
    ds.save_to_disk(str(root / name) if name else str(root))


def _split_snapshot(root, n_pages=8, text_field=None, multi_hop=False, meta=False,
                    underscore=False):
    """corpus / queries / qrels (and optional documents_metadata) subdirs, the
    ViDoRe v2 / v3 and KoPub layout; ``underscore`` names the id columns
    ``corpus_id`` / ``query_id`` as v3 does."""
    cid, qid = ("corpus_id", "query_id") if underscore else ("corpus-id", "query-id")
    corpus = {cid: [f"p{i}" for i in range(n_pages)], "image": _pages(n_pages, 1)}
    if text_field:
        corpus[text_field] = [f"page {i} text" if i % 3 else "" for i in range(n_pages)]
    if meta:
        corpus["doc_id"] = [f"d{i // 3}" for i in range(n_pages)]
        corpus["page_number_in_doc"] = [i % 3 + 1 for i in range(n_pages)]
    _save(root, "corpus", corpus, "image")
    queries = {qid: [f"q{i}" for i in range(5)],
               "query": [f"where is item {i} on the page" for i in range(4)] + [""],
               "answer": ["ans 0", None, "ans 2", "", "ans 4"]}
    if multi_hop:
        queries["query_types"] = [["multi-hop"], ["extractive"], ["multi-hop"], [], ["x"]]
    _save(root, "queries", queries)
    rows = [("q0", "p1", 2), ("q0", "p4", 1), ("q0", "p5", 0), ("q1", "p2", 1),
            ("q2", "p3", 1), ("q2", "p6", 3), ("q3", "p7", 1), ("q4", "p0", 1),
            ("qx", "p0", 1)]
    _save(root, "qrels", {qid: [r[0] for r in rows], cid: [r[1] for r in rows],
                          "score": [r[2] for r in rows]})
    if meta:
        _save(root, "documents_metadata", {
            "doc_id": ["d0", "d1"], "url": ["http://x/a.pdf", None],
            "file_name": ["a.pdf", "b.pdf"], "doc_type": ["report", None],
            "doc_language": ["en", "fr"], "doc_year": [2024, None],
        })
    return root


def ingest(pkg, name, db, embedding_model=None, late=False, subset="test", query_limit=None,
           min_corpus_cnt=None, **kw):
    info = _mod(pkg, "data.registry").get_ingestor(name)
    cat = _mod(pkg, "store.catalog").Catalog(db)
    ing = info.cls(embedding_model=embedding_model, **kw)
    ing.set_service(_mod(pkg, "store.ingestion").IngestionService(cat))
    ing.ingest(subset=subset, query_limit=query_limit, min_corpus_cnt=min_corpus_cnt)
    stats = None
    if embedding_model is not None:
        stats = ing.embed_all_late_interaction() if late else ing.embed_all()
    cat.close()
    return stats


def both(tmp_path, name, **kw):
    out = {}
    for pkg in PKGS:
        ingest(pkg, name, tmp_path / f"{pkg}.db", **kw)
        out[pkg] = dump(tmp_path / f"{pkg}.db")
    assert out[TORCH] == out[JAX]
    return out[TORCH]


def test_registry_lists_the_six_with_jax_params():
    names = {i.name for i in _mod(TORCH, "data.registry").list_ingestors()}
    assert set(NAMES) <= names
    for name in NAMES:
        jinfo = _mod(JAX, "data.registry").get_ingestor(name)
        tinfo = _mod(TORCH, "data.registry").get_ingestor(name)
        assert tinfo.cls.__module__.startswith(TORCH)
        assert (tinfo.description, tinfo.hf_repo) == (jinfo.description, jinfo.hf_repo)
        assert [(p.name, p.default, p.required, p.choices) for p in tinfo.params] == [
            (p.name, p.default, p.required, p.choices) for p in jinfo.params
        ]


@pytest.mark.parametrize("limit", [None, 2])
def test_vidore_v1_snapshot_equal(tmp_path, limit):
    snap = tmp_path / "v1"
    _save(snap, None, {"query": ["find the chart", "", "read the table", "who signed"],
                       "image": _pages(4, 2), "image_filename": ["a.png", "b.png", "c.png", "a.png"]},
          "image")
    out = both(tmp_path, "vidore", data_dir=str(snap), query_limit=limit,
               dataset_name="vidore/docvqa_test_subsampled")
    assert out["image_chunk"] and all(r[2][:8] == b"\x89PNG\r\n\x1a\n" for r in out["image_chunk"])
    # the row without query text is skipped; a limit samples the rows first
    assert len(out["query"]) == 3 if limit is None else len(out["query"]) <= limit


@pytest.mark.parametrize("limit,min_cnt", [(None, None), (2, None), (None, 5), (3, 4)])
def test_vidorev2_snapshot_equal(tmp_path, limit, min_cnt):
    snap = _split_snapshot(tmp_path / "v2")
    out = both(tmp_path, "vidorev2", data_dir=str(snap), query_limit=limit,
               min_corpus_cnt=min_cnt)
    assert out["retrieval_relation"] and out["image_chunk"]
    assert not out["chunk"]  # image-only collection
    if min_cnt is not None:  # every gold page kept, others filled up to min_cnt
        assert min_cnt <= len(out["image_chunk"]) < 8


@pytest.mark.parametrize("mode", ["image", "text", "mixed"])
def test_vidorev3_snapshot_modes_and_hierarchy_equal(tmp_path, mode):
    snap = _split_snapshot(tmp_path / "v3", text_field="markdown", multi_hop=True, meta=True,
                           underscore=True)
    out = both(tmp_path, "vidorev3", data_dir=str(snap), qrels_mode=mode)
    assert len(out["file"]) == 3 and len(out["document"]) == 3 and len(out["page"]) == 8
    assert out["chunk"]  # the pages with markdown
    assert {r[1] for r in out["retrieval_relation"]} >= {0, 1}  # multi-hop AND groups


def test_vidorev3_snapshot_without_metadata_equal(tmp_path):
    snap = _split_snapshot(tmp_path / "v3", text_field="markdown", multi_hop=True,
                           underscore=True)
    out = both(tmp_path, "vidorev3", data_dir=str(snap))
    assert not out["file"] and not out["page"]


@pytest.mark.parametrize("name,field", [("sds_kopub_vdr", "text"), ("kovidorev2", "markdown")])
@pytest.mark.parametrize("mode", ["image", "text", "mixed"])
def test_korean_snapshots_equal(tmp_path, name, field, mode):
    snap = _split_snapshot(tmp_path / name, text_field=field, multi_hop=True)
    out = both(tmp_path, name, data_dir=str(snap), qrels_mode=mode, min_corpus_cnt=6)
    groups = {r[1] for r in out["retrieval_relation"]}
    # KoViDoRe ANDs its multi-hop queries; SDS KoPub never does
    assert (groups >= {0, 1}) == (name == "kovidorev2")


@pytest.mark.parametrize("limit,min_cnt", [(None, None), (2, 3)])
def test_visrag_data_equal(tmp_path, limit, min_cnt):
    data = {
        "corpus": [{"corpus-id": f"pg{i}", "image": img} for i, img in enumerate(_pages(6, 3))],
        "queries": [{"query-id": f"q{i}", "query": f"what is on page {i}",
                     "answer": f"a{i}" if i % 2 else None} for i in range(4)],
        "qrels": [{"query-id": f"q{i}", "corpus-id": f"pg{(2 * i) % 6}", "score": 1}
                  for i in range(4)] + [{"query-id": "q1", "corpus-id": "pg5", "score": 0}],
    }
    out = both(tmp_path, "visrag", data=data, query_limit=limit, min_corpus_cnt=min_cnt)
    assert any(r for r in out["query"])


@pytest.mark.parametrize("late", [False, True], ids=["single", "multi"])
def test_multimodal_embedding_blobs_equal(tmp_path, late):
    """``MultiModalDataIngestor.embed_all`` / ``embed_all_late_interaction``
    embed the page images (``image=True``) and the query texts; the blobs
    are byte-identical between the packages."""
    snap = _split_snapshot(tmp_path / "v2")
    out, stats = {}, {}
    for pkg in PKGS:
        emb = _mod(pkg, "embeddings")
        model = emb.MockMultiVectorEmbedding(dim=16, max_tokens=4) if late else \
            emb.MockEmbedding(dim=16)
        stats[pkg] = ingest(pkg, "vidorev2", tmp_path / f"{pkg}.db", embedding_model=model,
                            late=late, data_dir=str(snap))
        out[pkg] = dump(tmp_path / f"{pkg}.db")
    assert out[TORCH] == out[JAX]
    assert {t: (s.total, s.embedded) for t, s in stats[TORCH].items()} == \
        {t: (s.total, s.embedded) for t, s in stats[JAX].items()}
    assert stats[TORCH]["image_chunk"].embedded == 8


def test_image_only_collection_refuses_text_modes():
    for pkg in PKGS:
        cls = _mod(pkg, "data.vidore").ViDoReV2Ingestor
        with pytest.raises(ValueError, match="image-only"):
            cls(data={}, qrels_mode="mixed")
        with pytest.raises(ValueError, match="qrels_mode"):
            cls(data={}, qrels_mode="both")


@pytest.mark.parametrize("limit,min_cnt", [(None, None), (3, None), (2, 6), (10, 4)])
def test_hf_util_samples_equal(limit, min_cnt):
    import random

    ids = [f"c{i}" for i in range(12)]
    gold = {"c3", "c7", "zz"}
    for fn, args in (("sample_ids", (ids, limit)),
                     ("gold_preserving_subsample", (ids, gold, min_cnt))):
        got = [getattr(_mod(pkg, "data.hf_util"), fn)(*args, random.Random(42)) for pkg in PKGS]
        assert got[0] == got[1]


def test_hf_util_errors_equal(tmp_path, monkeypatch):
    """A directory that is no snapshot, and ``datasets`` missing, raise each
    package's ``IngestionError`` with the same message."""
    (tmp_path / "empty").mkdir()
    msgs = []
    for pkg in PKGS:
        err = _mod(pkg, "exceptions").IngestionError
        with pytest.raises(err, match="cannot read local snapshot") as exc:
            _mod(pkg, "data.hf_util").load_hf_dataset("x/y", "corpus", data_dir=str(tmp_path / "empty"))
        msgs.append(str(exc.value).replace(str(tmp_path), ""))
    assert msgs[0] == msgs[1]
    monkeypatch.setitem(sys.modules, "datasets", None)  # no network is tried
    for pkg in PKGS:
        with pytest.raises(_mod(pkg, "exceptions").IngestionError, match="cannot load HF dataset"):
            _mod(pkg, "data.hf_util").load_hf_dataset("vidore/esg_reports_v2", "corpus")
