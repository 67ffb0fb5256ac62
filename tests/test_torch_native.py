"""The port's native BM25 builders (``native.py`` over ``csrc/bm25_native.cpp``)
against the JAX package's native builders and the port's own plain builders.

The C++ source is the port's own copy; this host's ``g++`` builds it into
``_build/``. Held bitwise: the sparse build against the JAX package's
``build_sparse_native`` (vocabulary, slot ids, weights, document
frequencies, lengths, avgdl) and, per (doc, term), against the port's numpy
builder; both aux builders against their numpy plain versions on the cases
of ``tests/test_native.py::TestNativeAuxBuilders``. The routing rule is the
JAX package's: non-ASCII text, the ``english`` tokenizer and ``max_slots``
take the numpy builder. A missing or failing compiler raises; nothing falls
back. Search hits over natively built indexes equal the JAX package's in the
flat, packed and bucketed layouts (ids equal; scores within 1e-6 relative,
an id swap only between two scores within that, as in
``tests/test_torch_index_sparse.py``).
"""

import numpy as np
import pytest

from autorag_research_tpu import native as jnative
from autorag_research_tpu.index.sparse import SparseIndex as JSparse
from autorag_research_tpu_torch import native
from autorag_research_tpu_torch.index.sparse import SparseIndex
from autorag_research_tpu_torch.ops import sparse as ts

RTOL = 1e-6
ARRAYS = ("slot_ids", "slot_weights", "doc_freq", "doc_lengths")


def zipf_corpus(seed=0, n=5000, vocab=3000, max_words=60):
    """Seeded ASCII Zipf(1.2) texts with punctuation, mixed case, digits and
    empty documents."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)] + ["The", "FOX,", "don't", "x-ray", "42!"]
    texts = []
    for _ in range(n):
        picks = np.minimum(rng.zipf(1.2, size=int(rng.integers(0, max_words))), len(words)) - 1
        texts.append(" ".join(words[j] for j in picks))
    texts[0] = texts[17] = ""
    texts[5] = "   ...   "
    return texts


@pytest.fixture(scope="module")
def corpus():
    return zipf_corpus()


def _pairs(slot_ids, slot_weights, vocab):
    """{(doc, term string): weight bits} of a slot layout."""
    terms = {i: t for t, i in vocab.items()}
    rows, cols = np.nonzero(slot_ids >= 0)
    bits = slot_weights[rows, cols].view(np.int32)
    return {(int(r), terms[int(t)]): int(b) for r, t, b in zip(rows, slot_ids[rows, cols], bits)}


# ----------------------------------------------------------------- build
@pytest.mark.parametrize("k1,b", [(1.2, 0.75), (0.9, 0.4)])
def test_build_sparse_native_bitwise_against_jax_native(corpus, k1, b):
    got = native.build_sparse_native(corpus, k1, b)
    want = jnative.build_sparse_native(corpus, k1, b)
    assert got["vocab"] == want["vocab"] and list(got["vocab"]) == list(want["vocab"])
    assert got["avgdl"] == want["avgdl"]
    for name in ARRAYS:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_native_weights_equal_plain_builder_per_doc_term(corpus):
    nat = SparseIndex(list(range(len(corpus))), corpus, device="cpu")
    plain = SparseIndex(list(range(len(corpus))), None, device="cpu")
    plain._build_plain(corpus)
    assert set(nat.vocab) == set(plain.vocab)
    assert nat.avgdl == plain.avgdl
    by_term = {t: (nat.doc_freq[i], i) for t, i in nat.vocab.items()}
    assert all(plain.doc_freq[i] == by_term[t][0] for t, i in plain.vocab.items())
    np.testing.assert_array_equal(nat.doc_lengths, plain.doc_lengths)
    # the slot order within a document differs (hash table against first
    # occurrence); each (doc, term) weight is the same f32, bit for bit
    assert _pairs(nat._slot_ids, nat._slot_weights, nat.vocab) == _pairs(
        plain._slot_ids, plain._slot_weights, plain.vocab
    )
    assert nat._slot_ids.shape == plain._slot_ids.shape


def test_native_index_matches_jax_native_index(corpus):
    ids = [f"d{i}" for i in range(len(corpus))]
    t, j = SparseIndex(ids, corpus, device="cpu"), JSparse(ids, corpus)
    assert t.vocab == j.vocab and t.avgdl == j.avgdl
    for name in ("_slot_ids", "_slot_weights", "doc_freq", "doc_lengths"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)


def test_cluster_layout_applies_to_the_native_build(corpus):
    ids = list(range(len(corpus)))
    t = SparseIndex(ids, corpus, cluster_layout=True, device="cpu")
    j = JSparse(ids, corpus, cluster_layout=True)
    assert t.ids == j.ids and t.ids != ids
    np.testing.assert_array_equal(t._slot_ids, j._slot_ids)
    np.testing.assert_array_equal(t.doc_lengths, j.doc_lengths)


def test_empty_and_blank_corpora():
    for texts in ([], ["", ""], ["!!", " "]):
        got = native.build_sparse_native(texts, 1.2, 0.75)
        want = jnative.build_sparse_native(texts, 1.2, 0.75)
        assert got["vocab"] == want["vocab"] == {} and got["avgdl"] == want["avgdl"]
        for name in ARRAYS:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        t = SparseIndex(list(range(len(texts))), texts, device="cpu")
        assert t._slot_ids.shape == (len(texts), 1)


# -------------------------------------------------------------- routing
def _spy(monkeypatch):
    calls = []
    real = native.build_sparse_native

    def spy(texts, k1, b):
        calls.append(len(texts))
        return real(texts, k1, b)

    monkeypatch.setattr(native, "build_sparse_native", spy)
    return calls


@pytest.mark.parametrize("case", ["non_ascii", "english", "max_slots", "ascii", "wiki_tocken"])
def test_routing_rule_is_the_jax_packages(corpus, monkeypatch, case):
    texts = corpus[:300]
    opts = {}
    if case == "non_ascii":
        texts = texts + ["café crème brûlée"]
    elif case == "english":
        opts["tokenizer"] = "english"
    elif case == "max_slots":
        opts["max_slots"] = 8
    elif case == "wiki_tocken":
        opts["tokenizer"] = "wiki_tocken"
    calls = _spy(monkeypatch)
    t = SparseIndex(list(range(len(texts))), texts, device="cpu", **opts)
    native_route = case in ("ascii", "wiki_tocken")
    assert calls == ([len(texts)] if native_route else [])
    # either way the index is the JAX package's (which routes alike)
    j = JSparse(list(range(len(texts))), texts, **opts)
    assert t.vocab == j.vocab
    if native_route:
        np.testing.assert_array_equal(t._slot_ids, j._slot_ids)
    else:
        jp = JSparse(list(range(len(texts))), None, **opts)
        jp._build_python(texts)
        np.testing.assert_array_equal(t._slot_ids, jp._slot_ids)
        np.testing.assert_array_equal(t._slot_weights, jp._slot_weights)


# ---------------------------------------------------------- aux builders
@pytest.fixture(scope="module")
def aux_doc_ids():
    """``tests/test_native.py::TestNativeAuxBuilders``'s fixture."""
    rng = np.random.default_rng(11)
    ids = rng.zipf(1.3, size=(20_000, 48)).astype(np.int64)
    ids = np.minimum(ids, 9_000).astype(np.int32) - 1
    ids[rng.random(ids.shape) < 0.3] = -1
    return ids


@pytest.mark.parametrize("block_n", [2048, 128, 4096])
def test_term_tile_lists_native_equal_plain(aux_doc_ids, block_n):
    ip_n, tl_n = ts.build_term_tile_lists(aux_doc_ids, block_n)
    ip_p, tl_p = ts.build_term_tile_lists_plain(aux_doc_ids, block_n)
    assert ip_n.dtype == ip_p.dtype == np.int64 and tl_n.dtype == tl_p.dtype == np.int32
    np.testing.assert_array_equal(ip_n, ip_p)
    np.testing.assert_array_equal(tl_n, tl_p)
    ip_j, tl_j = jnative.build_term_tile_lists_native(aux_doc_ids, block_n)
    np.testing.assert_array_equal(ip_n, ip_j)
    np.testing.assert_array_equal(tl_n, tl_j)


@pytest.mark.parametrize("block_n,n_words", [(2048, None), (128, 64), (512, None)])
def test_bloom_bitmaps_native_equal_plain(aux_doc_ids, block_n, n_words):
    bm_n = ts.build_tile_bitmaps(aux_doc_ids, block_n, n_words)
    bm_p = ts.build_tile_bitmaps_plain(aux_doc_ids, block_n, n_words)
    assert bm_n.dtype == bm_p.dtype == np.int32
    np.testing.assert_array_equal(bm_n, bm_p)
    np.testing.assert_array_equal(bm_n, jnative.build_tile_bitmaps_native(aux_doc_ids, block_n, bm_n.shape[1]))
    with pytest.raises(ValueError):
        ts.build_tile_bitmaps(aux_doc_ids, block_n, n_words=48)


def test_aux_builders_on_an_index_corpus(corpus):
    """The index's own slot arrays (a Zipf text corpus, many pads)."""
    idx = SparseIndex(list(range(len(corpus))), corpus, device="cpu")
    for block_n in (64, 1000):
        for got, want in zip(ts.build_term_tile_lists(idx._slot_ids, block_n),
                             ts.build_term_tile_lists_plain(idx._slot_ids, block_n)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ts.build_tile_bitmaps(idx._slot_ids, block_n),
                                      ts.build_tile_bitmaps_plain(idx._slot_ids, block_n))


# ------------------------------------------------------------- no fallback
@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The library unloaded and unbuilt: the next call builds into
    ``tmp_path``."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path


@pytest.mark.parametrize("compiler", ["no-such-compiler-g++", "false"])
def test_a_failed_build_raises(fresh_build, monkeypatch, caplog, compiler):
    monkeypatch.setenv("CXX", compiler)
    with pytest.raises(RuntimeError, match="native BM25 builder"):
        native.build_sparse_native(["plain ascii text"], 1.2, 0.75)
    with pytest.raises(RuntimeError, match="native BM25 builder"):
        SparseIndex([0, 1], ["plain ascii", "text"], device="cpu")
    with pytest.raises(RuntimeError, match="native BM25 builder"):
        ts.build_term_tile_lists(np.zeros((4, 2), np.int32), 2)
    assert not list(fresh_build.glob("*.so"))
    assert not caplog.records  # nothing logged and carried on


def test_a_failed_load_raises(fresh_build, monkeypatch):
    (fresh_build / native.lib_path().name).write_bytes(b"not a shared object")
    with pytest.raises(RuntimeError, match="loading"):
        native.load()


def test_build_goes_to_the_build_dir_named_by_source_hash(fresh_build, monkeypatch):
    monkeypatch.setenv("CXX", "g++")
    path = native.build()
    assert path.parent == fresh_build and path.name.startswith("bm25_native-")
    assert path.exists() and native.build() == path  # built once, then reused
    assert native.load() is native.load()


# ----------------------------------------------------------------- search
def _short_docs(seed, n, max_words):
    return zipf_corpus(seed, n=n, vocab=400, max_words=max_words)


def _queries(seed, n=16):
    rng = np.random.default_rng(seed)
    qs = [" ".join(f"w{int(w)}" for w in rng.zipf(1.2, size=int(rng.integers(1, 6))) % 400)
          for _ in range(n)]
    qs[2] = "nothing matches zzz"
    return qs


def _assert_hits(t_hits, j_hits):
    for t, j in zip(t_hits, j_hits, strict=True):
        assert len(t) == len(j)
        ts_, js_ = np.array([h.score for h in t]), np.array([h.score for h in j])
        np.testing.assert_allclose(ts_, js_, rtol=RTOL, atol=0)
        for r, (a, c) in enumerate(zip(t, j)):
            if a.doc_id != c.doc_id:  # a near-tie only
                assert any(abs(js_[r] - js_[x]) <= RTOL * js_[r] for x in (r - 1, r + 1) if 0 <= x < len(j))


@pytest.mark.parametrize("layout", ["flat", "packed", "bucketed"])
def test_search_over_native_builds_matches_jax(layout):
    if layout == "flat":  # a document wider than 64 unique terms
        docs = _short_docs(3, 600, 30)
        docs[9] = " ".join(f"u{i}" for i in range(70))
        opts = {}
    elif layout == "packed":
        docs, opts = _short_docs(4, 900, 20), {}
    else:
        docs = _short_docs(5, 600, 12)
        docs[::10] = [" ".join(f"w{i}" for i in range(80 + j % 20)) for j in range(len(docs[::10]))]
        opts = {"bucketize": 2}
    ids = [f"d{i}" for i in range(len(docs))]
    t = SparseIndex(ids, docs, device="cpu", **opts).to_device()
    j = JSparse(ids, docs, **opts).to_device()
    assert t._layout() == layout
    np.testing.assert_array_equal(t._slot_ids, j._slot_ids)
    queries = _queries(6)
    for k in (5, 30):
        _assert_hits(t.search(queries, k), j.search(queries, k))


def test_the_port_never_loads_the_jax_packages_library(tmp_path):
    """A process that builds an index through the port maps the port's own
    library and not ``native/libbm25_native.so``."""
    import subprocess
    import sys
    from pathlib import Path

    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from autorag_research_tpu_torch.index.sparse import SparseIndex\n"
        "SparseIndex([0, 1], ['plain ascii', 'text'], device='cpu')\n"
        "print(open('/proc/self/maps').read())\n"
    )
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", script], cwd=repo, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert native.lib_path().name in out.stdout
    assert "libbm25_native.so" not in out.stdout
