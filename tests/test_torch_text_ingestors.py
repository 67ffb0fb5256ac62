"""The port's text ingestors and hub dumps against the JAX package's.

Each case feeds both packages' registries the same local data: a seeded
BEIR directory in ``tmp_path`` (``corpus.jsonl``, ``queries.jsonl``,
``qrels/test.tsv`` with a header, score-0 rows and a qrel to a missing
document), ``datasets.Dataset`` mappings as in
``tests/test_hf_ingestors.py``, or a ``save_to_disk`` snapshot, and compares
the two catalogs table by table, every column of every row: chunks, queries,
retrieval GT groups and generation GT, the seed-42 query sample and
gold-preserving corpus subsample included. No case reaches the network: the
offline refusals are raised as each package's ``IngestionError``, and the
hub dumps (``data/hf_storage.py``, the CLI's ``data upload`` / ``download``
and ``show dumps``) run against one stand-in ``huggingface_hub``
(``hub_stub.py``).
"""

import importlib
import json
import sqlite3
import sys

import numpy as np
import pytest

datasets = pytest.importorskip("datasets")

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)
TEXT = ("beir", "text_mteb", "ragbench", "mrtydi", "bright", "crag", "open_ragbench")
LIMITS = [(None, None), (4, None), (4, 9), (None, 14), (30, 3)]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def dump(path) -> dict[str, list[tuple]]:
    with sqlite3.connect(path) as conn:
        tables = [r[0] for r in conn.execute("SELECT name FROM sqlite_master WHERE type='table'")]
        return {t: conn.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                for t in tables if t != "sqlite_sequence"}


def ingest(pkg, name, db, query_limit=None, min_corpus_cnt=None, subset="test", **kw):
    info = _mod(pkg, "data.registry").get_ingestor(name)
    cat = _mod(pkg, "store.catalog").Catalog(db)
    ing = info.cls(**kw)
    ing.set_service(_mod(pkg, "store.ingestion").IngestionService(cat))
    ing.ingest(subset=subset, query_limit=query_limit, min_corpus_cnt=min_corpus_cnt)
    key_type = ing.detect_primary_key_type()
    cat.close()
    return key_type


def both(tmp_path, name, data_fn=None, **kw) -> dict:
    """Ingest ``name`` through both packages (``data_fn()`` builds a fresh
    ``data=`` for each) and return the port's catalog, equal to JAX's."""
    out, keys = {}, {}
    for pkg in PKGS:
        extra = {"data": data_fn()} if data_fn else {}
        keys[pkg] = ingest(pkg, name, tmp_path / f"{pkg}.db", **kw, **extra)
        out[pkg] = dump(tmp_path / f"{pkg}.db")
    assert keys[TORCH] == keys[JAX]
    assert out[TORCH] == out[JAX]
    return out[TORCH]


def ds(rows):
    keys = rows[0].keys()
    return datasets.Dataset.from_dict({k: [r.get(k) for r in rows] for k in keys})


def words(rng, n):
    vocab = ["alpha", "beta", "gamma", "delta", "kinase", "protein", "café", "naïve", "x"]
    return " ".join(rng.choice(vocab, size=n))


# ---------------------------------------------------------------------- BEIR
def beir_dir(root, n_docs=24, n_queries=12, string_ids=False, seed=0):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "qrels").mkdir()
    did = (lambda i: f"doc-{i}") if string_ids else str
    qid = (lambda i: f"q-{i}") if string_ids else (lambda i: str(1000 + i))
    with open(root / "corpus.jsonl", "w", encoding="utf-8") as f:
        for i in range(n_docs):
            row = {"_id": did(i), "text": words(rng, int(rng.integers(3, 12)))}
            if i % 4:
                row["title"] = f"Title {i}"
            f.write(json.dumps(row) + "\n")
    with open(root / "queries.jsonl", "w", encoding="utf-8") as f:
        for i in range(n_queries + 2):  # two queries without qrels
            f.write(json.dumps({"_id": qid(i), "text": f"query {words(rng, 4)}"}) + "\n")
    lines = ["query-id\tcorpus-id\tscore"]
    for i in range(n_queries):
        for d in rng.choice(n_docs, size=int(rng.integers(1, 4)), replace=False):
            lines.append(f"{qid(i)}\t{did(int(d))}\t{int(rng.integers(1, 3))}")
        lines.append(f"{qid(i)}\t{did((i * 7) % n_docs)}\t0")
    lines.append(f"{qid(0)}\t{did(n_docs + 5)}\t1")  # a document not in the corpus
    (root / "qrels" / "test.tsv").write_text("\n".join(lines) + "\n")
    return root


@pytest.mark.parametrize("dataset", ["scifact", "hotpotqa"])
@pytest.mark.parametrize("string_ids", [False, True], ids=["bigint", "string"])
@pytest.mark.parametrize("limit,min_cnt", LIMITS)
def test_beir_directory_catalogs_equal(tmp_path, dataset, string_ids, limit, min_cnt):
    root = beir_dir(tmp_path / "beir", string_ids=string_ids)
    cat = both(tmp_path, "beir", dataset_name=dataset, data_dir=str(root), query_limit=limit,
               min_corpus_cnt=min_cnt)
    assert cat["query"] and cat["chunk"] and cat["retrieval_relation"]


def test_beir_relations_follow_the_dataset(tmp_path):
    """hotpotqa is ``and_all`` (a group per gold document), the others
    ``or_all`` (one group); score-0 qrels and missing documents count for
    nothing; a chunk is ``title + " " + text``, stripped."""
    from autorag_research_tpu_torch.store.catalog import Catalog

    root = beir_dir(tmp_path / "beir")
    for name in ("hotpotqa", "scifact"):
        ingest(TORCH, "beir", tmp_path / f"{name}.db", dataset_name=name, data_dir=str(root))
        cat = Catalog(tmp_path / f"{name}.db")
        _, _, qrels = _mod(TORCH, "data.beir").load_beir_dir(root)
        corpus = set(_mod(TORCH, "data.beir").load_beir_dir(root)[0])
        for q, rel in qrels.items():
            gold = {d for d, s in rel.items() if s > 0 and d in corpus}
            rows = cat.get_relations_by_query(q)
            assert {str(r["chunk_id"]) for r in rows} == gold
            groups = {r["group_index"] for r in rows}
            assert groups == (set(range(len(gold))) if name == "hotpotqa" else {0})
        contents = {str(k): v for k, v in cat.get_chunk_contents(["0", "1"]).items()}
        assert contents["0"] == contents["0"].strip() and contents["1"].startswith("Title 1 ")
        cat.close()


def test_beir_loader_equal(tmp_path):
    root = beir_dir(tmp_path / "beir", string_ids=True)
    ref = _mod(JAX, "data.beir").load_beir_dir(root)
    assert _mod(TORCH, "data.beir").load_beir_dir(root) == ref


def test_beir_missing_directory_raises_ingestion_error(tmp_path):
    for pkg in PKGS:
        with pytest.raises(_mod(pkg, "exceptions").IngestionError, match="BEIR data not found"):
            _mod(pkg, "data.registry").get_ingestor("beir").cls(data_dir=str(tmp_path / "none"))


# ------------------------------------------------------------ HF-backed ones
def mteb_data(seed=0, n_docs=20, n_q=10):
    rng = np.random.default_rng(seed)
    corpus = [{"_id": f"d{i}", "title": f"T{i}" if i % 3 else None, "text": words(rng, 5)}
              for i in range(n_docs)]
    queries = [{"_id": f"q{i}", "text": f"find {words(rng, 3)}"} for i in range(n_q + 1)]
    qrels = []
    for i in range(n_q):
        for d in rng.choice(n_docs, size=3, replace=False):
            qrels.append({"query-id": f"q{i}", "corpus-id": f"d{d}",
                          "score": int(rng.integers(0, 3))})
    return {"corpus": ds(corpus), "queries": ds(queries), "qrels": ds(qrels)}


@pytest.mark.parametrize("threshold", [1, 2])
@pytest.mark.parametrize("limit,min_cnt", LIMITS)
def test_text_mteb_catalogs_equal(tmp_path, threshold, limit, min_cnt):
    both(tmp_path, "text_mteb", mteb_data, score_threshold=threshold, query_limit=limit,
         min_corpus_cnt=min_cnt)


def test_text_mteb_snapshot_equal(tmp_path):
    """The offline turnkey path: a ``save_to_disk`` snapshot with corpus /
    queries / qrels subdirectories (``data_dir=``)."""
    data = mteb_data(3)
    snap = tmp_path / "snap"
    data["corpus"].save_to_disk(str(snap / "corpus"))
    data["queries"].save_to_disk(str(snap / "queries"))
    data["qrels"].save_to_disk(str(snap / "default"))
    cat = both(tmp_path, "text_mteb", data_dir=str(snap), query_limit=5, min_corpus_cnt=8)
    assert len(cat["query"]) == 5


def rag_rows(seed=0, n=12):
    rng = np.random.default_rng(seed)
    shared = "a shared document ☃"
    return [{"id": f"r{i}" if i % 5 else None, "question": f"what is {words(rng, 2)}",
             "documents": [words(rng, 6), shared] if i % 2 else [words(rng, 4)],
             "response": words(rng, 3) if i % 3 else ""} for i in range(n)]


@pytest.mark.parametrize("limit", [None, 5, 50])
def test_ragbench_catalogs_equal(tmp_path, limit):
    both(tmp_path, "ragbench", lambda: ds(rag_rows()), query_limit=limit)


def mrtydi_rows(seed=0, n=10):
    rng = np.random.default_rng(seed)
    return [{"query_id": f"m{i}", "query": f"question {words(rng, 3)}",
             "positive_passages": [{"docid": f"p{i}", "title": "t" if i % 2 else None,
                                    "text": words(rng, 5)}],
             "negative_passages": [{"docid": f"p{(i + 1) % n}", "title": "", "text": "neg"},
                                   {"docid": f"n{i}", "title": None, "text": words(rng, 4)}]}
            for i in range(n)]


@pytest.mark.parametrize("limit", [None, 4])
def test_mrtydi_catalogs_equal(tmp_path, limit):
    both(tmp_path, "mrtydi", lambda: ds(mrtydi_rows()), query_limit=limit)


def bright_data(seed=0, n_docs=16, n_q=8):
    rng = np.random.default_rng(seed)
    examples = [{"id": f"b{i}", "query": f"why {words(rng, 3)}",
                 "gold_ids": [f"g{d}" for d in rng.choice(n_docs, size=2, replace=False)],
                 "gold_answer": words(rng, 2) if i % 2 else None} for i in range(n_q)]
    documents = [{"id": f"g{i}", "content": words(rng, 6)} for i in range(n_docs)]
    return {"examples": ds(examples), "documents": ds(documents)}


@pytest.mark.parametrize("limit,min_cnt", LIMITS)
def test_bright_catalogs_equal(tmp_path, limit, min_cnt):
    both(tmp_path, "bright", bright_data, query_limit=limit, min_corpus_cnt=min_cnt)


def crag_rows(seed=0, n=10):
    rng = np.random.default_rng(seed)
    return [{"interaction_id": f"c{i}" if i % 4 else None, "query": f"who {words(rng, 2)}",
             "answer": words(rng, 2) if i % 3 else None,
             "search_results": [{"page_snippet": words(rng, 5)}, {"page_snippet": ""},
                                {"page_snippet": "  the same snippet  "}],
             "domain": ["sports", "finance"][i % 2], "question_type": "simple"}
            for i in range(n)]


@pytest.mark.parametrize("limit", [None, 3])
def test_crag_catalogs_equal(tmp_path, limit):
    both(tmp_path, "crag", lambda: ds(crag_rows()), query_limit=limit)


def open_rows(seed=0, n=6):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return [{"id": f"o{i}", "question": f"what {words(rng, 2)}",
             "contexts": [words(rng, 5), "", "a context every row shares"],
             "answer": words(rng, 2) if i % 2 else "",
             "page_image": Image.fromarray(rng.integers(0, 255, (5, 4, 3), dtype=np.uint8))
             if i % 3 else None} for i in range(n)]


@pytest.mark.parametrize("limit", [None, 4])
def test_open_ragbench_catalogs_equal(tmp_path, limit):
    pytest.importorskip("PIL")
    cat = both(tmp_path, "open_ragbench", open_rows, query_limit=limit)
    assert cat["image_chunk"]


def test_doc_id_hashes_equal():
    for name in ("ragbench", "crag", "open_ragbench"):
        for text in ("", "x", "café ☃", "a" * 1000):
            assert _mod(TORCH, f"data.{name}")._doc_id(text) == _mod(JAX, f"data.{name}")._doc_id(text)


def test_offline_load_raises_ingestion_error(monkeypatch):
    """``tests/test_hf_ingestors.py::test_offline_load_raises_cleanly`` on both
    packages, with ``datasets`` blocked so that nothing is fetched."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    for pkg in PKGS:
        ing = _mod(pkg, "data.registry").get_ingestor("text_mteb").cls(task_name="NoSuchTask")
        ing.set_service(None)
        with pytest.raises(_mod(pkg, "exceptions").IngestionError):
            ing._load("test")
        for name in ("ragbench", "mrtydi", "crag", "open_ragbench"):
            ing = _mod(pkg, "data.registry").get_ingestor(name).cls()
            with pytest.raises(_mod(pkg, "exceptions").IngestionError):
                ing._load("test")
        with pytest.raises(_mod(pkg, "exceptions").IngestionError):
            _mod(pkg, "data.registry").get_ingestor("bright").cls()._load()


def test_registry_lists_every_ingestor_with_jax_params():
    """The set of ``tests/test_hf_ingestors.py::test_all_reference_ingestors_registered``,
    with each ingestor's parameters and defaults as the JAX registry has
    them."""
    want = {"beir", "local", "text_mteb", "ragbench", "mrtydi", "bright", "crag",
            "vidore", "vidorev2", "vidorev3", "visrag", "sds_kopub_vdr",
            "kovidorev2", "open_ragbench"}
    infos = {pkg: {i.name: i for i in _mod(pkg, "data.registry").list_ingestors()} for pkg in PKGS}
    assert want <= set(infos[TORCH]) and set(infos[TORCH]) == set(infos[JAX])
    for name in TEXT:
        t, j = infos[TORCH][name], infos[JAX][name]
        assert (t.description, t.hf_repo) == (j.description, j.hf_repo)
        assert [(p.name, p.default, p.required) for p in t.params] == [
            (p.name, p.default, p.required) for p in j.params]
    assert _mod(TORCH, "data.registry").get_ingestor("mteb").name == "text_mteb"


# ------------------------------------------------------------------ hub dumps
def test_hf_storage_against_jax(tmp_path, monkeypatch):
    """``upload_dump`` / ``list_dumps`` / ``download_dump`` make the same hub
    calls and give the same results in both packages; without
    ``huggingface_hub`` each raises its ``StoreError``."""
    from hub_stub import StubHub

    dump_file = tmp_path / "ws.dump.tar.gz"
    dump_file.write_bytes(b"not really a tarball")
    results = {}
    for pkg in PKGS:
        hub = StubHub(tmp_path / f"hub_{pkg}")
        monkeypatch.setitem(sys.modules, "huggingface_hub", hub.module())
        st = _mod(pkg, "data.hf_storage")
        dest = tmp_path / f"dl_{pkg}"
        dest.mkdir()
        ref = st.upload_dump(dump_file, "beir", org="org", token="tok")
        listed = st.list_dumps("beir", org="org", token="tok")
        path = st.download_dump("beir", "ws.dump.tar.gz", dest, org="org", token="tok")
        results[pkg] = (ref, listed, path.read_bytes(), path.parent == dest, hub.calls)
        with pytest.raises(_mod(pkg, "exceptions").StoreError, match="dump listing failed"):
            st.list_dumps("nothing", org="org")
        with pytest.raises(_mod(pkg, "exceptions").StoreError, match="dump download failed"):
            st.download_dump("beir", "other.tar.gz", dest, org="org")
    assert results[TORCH] == results[JAX]
    assert results[TORCH][:2] == ("org/beir-dumps/ws.dump.tar.gz", ["ws.dump.tar.gz"])
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for pkg in PKGS:
        st, err = _mod(pkg, "data.hf_storage"), _mod(pkg, "exceptions").StoreError
        with pytest.raises(err, match="dump upload failed"):
            st.upload_dump(dump_file, "beir")
        with pytest.raises(err, match="dump listing failed"):
            st.list_dumps("beir")
        with pytest.raises(err, match="dump download failed"):
            st.download_dump("beir", "x", tmp_path)
    assert _mod(TORCH, "data.hf_storage").DEFAULT_ORG == _mod(JAX, "data.hf_storage").DEFAULT_ORG


def test_show_dumps_over_every_ingestor_against_jax(tmp_path, monkeypatch, capsys):
    """``show dumps`` without ``--ingestor`` lists each ingestor's repo: the
    ones with dumps on stdout, the others as unavailable on stderr, the
    same lines from both CLIs."""
    from hub_stub import StubHub

    from autorag_research_tpu.cli.app import main as jax_main
    from autorag_research_tpu_torch.cli.app import main as torch_main

    monkeypatch.delenv("HF_TOKEN", raising=False)
    (tmp_path / "a.dump.tar.gz").write_bytes(b"a")
    outs = {}
    for pkg, main in ((JAX, jax_main), (TORCH, torch_main)):
        hub = StubHub(tmp_path / f"hub_{pkg}")
        for name in ("beir", "crag"):
            hub.put(f"myorg/{name}-dumps", tmp_path / "a.dump.tar.gz")
        hub.put("myorg/crag-dumps", tmp_path / "a.dump.tar.gz", "notes.txt")
        monkeypatch.setitem(sys.modules, "huggingface_hub", hub.module())
        capsys.readouterr()
        assert main(["show", "dumps", "--org", "myorg"]) == 0
        cap = capsys.readouterr()
        outs[pkg] = (cap.out, cap.err, hub.calls)
    assert outs[TORCH] == outs[JAX]
    assert outs[TORCH][0].split() == ["beir", "a.dump.tar.gz", "crag", "a.dump.tar.gz"]


def test_data_upload_without_hub_fails_cleanly(tmp_path, monkeypatch, capsys):
    """``data upload`` dumps the workspace, then reports the hub's failure
    and exits 1, as the JAX CLI does."""
    from autorag_research_tpu_torch.cli.app import main as torch_main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "ws").mkdir()
    (tmp_path / "ws" / "catalog.db").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    assert torch_main(["data", "upload", "--db", "ws"]) == 1
    assert "dump upload failed" in capsys.readouterr().err
    assert (tmp_path / "ws.dump.tar.gz").exists()
    assert torch_main(["data", "download", "--db", "ws2"]) == 1
    assert "requires --ingestor" in capsys.readouterr().err
