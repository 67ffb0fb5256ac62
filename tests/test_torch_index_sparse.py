"""Port ``index/tokenize.py`` and ``index/sparse.py`` vs the JAX package's.

Tokenizers, the index build (held against the JAX ``_build_python``, which
the JAX ``SparseIndex`` would otherwise skip for its native build),
``encode_queries`` and ``score_host`` are compared bitwise. Search hits, on
short corpora (both packages pack them) and on wide ones (more than 64
unique terms in a document: both keep the flat layout): the port's CPU route
against the JAX index on the CPU: ids equal and scores
``rtol=1e-6``, an id swap allowed only between two scores within that
tolerance (XLA on the CPU may round a multiply-add differently). The pruned
legs (probe, tile-WAND, Bloom skip) run on CPU tensors through their plain
versions and are held against the JAX ``_search_pruned`` in interpret mode.
Artifacts cross between the packages in both directions.
"""

import numpy as np
import pytest
import torch

from autorag_research_tpu.index.sparse import SparseIndex as JSparse
from autorag_research_tpu.index.tokenize import get_tokenizer as j_tokenizer
from autorag_research_tpu_torch.index.sparse import SparseIndex
from autorag_research_tpu_torch.index.tokenize import get_tokenizer

RTOL = 1e-6
TEXTS = [
    "Éclair recipe with chocolate, crème brûlée and 3 eggs",
    "don’t panic: the guide_book says 42",
    "",
    "naïve Bayes classifiers — straße ΑΒΓ δέλτα 東京 2024",
    "plain ascii text about the lazy dog",
]


def _corpus(seed=0, n=400, vocab=250, wide=False):
    """Short documents (the longest, doc 8, of 40 unique terms: the packed
    layout) or, ``wide``, doc 8 of 70 unique terms (wider than 64 slots: the
    flat layout)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)] + ["Éclair", "straße", "naïve"]
    docs = [" ".join(rng.choice(words, size=int(rng.integers(0, 30)))) for _ in range(n)]
    docs[7] = ""
    docs[8] = " ".join(f"u{i}" for i in range(70 if wide else 40))
    queries = [" ".join(rng.choice(words, size=int(rng.integers(1, 7)))) for _ in range(19)]
    queries[3] = "nothing matches here"
    queries[4] = ""
    return docs, queries


def _assert_hits(t_hits, j_hits):
    for t, j in zip(t_hits, j_hits, strict=True):
        assert len(t) == len(j)
        ts_, js_ = np.array([h.score for h in t]), np.array([h.score for h in j])
        np.testing.assert_allclose(ts_, js_, rtol=RTOL, atol=0)
        for r, (a, b) in enumerate(zip(t, j)):
            if a.doc_id != b.doc_id:  # a near-tie only
                assert any(abs(js_[r] - js_[x]) <= RTOL * js_[r] for x in (r - 1, r + 1) if 0 <= x < len(j))


# ------------------------------------------------------------- tokenizers
@pytest.mark.parametrize("name", ["simple", "wiki_tocken", "english"])
def test_tokenizers_match_jax(name):
    for text in TEXTS + ["The foxes are running quickly", "Hello, World! 123"]:
        assert get_tokenizer(name).tokenize(text) == j_tokenizer(name).tokenize(text)
    assert get_tokenizer(name).tokenize_batch(TEXTS) == j_tokenizer(name).tokenize_batch(TEXTS)


def test_tokenizer_errors_match_jax():
    from autorag_research_tpu.exceptions import TokenizerError as JTokenizerError
    from autorag_research_tpu_torch.exceptions import TokenizerError

    for name in ("nope", "./no/such/checkpoint"):
        with pytest.raises(TokenizerError):
            get_tokenizer(name)
        with pytest.raises(JTokenizerError):
            j_tokenizer(name)
    assert get_tokenizer("wiki_tocken").tokenize("a b") == ["a", "b"]


# ----------------------------------------------------------------- build
@pytest.mark.parametrize("cluster_layout", [False, True])
@pytest.mark.parametrize("max_slots", [None, 5])
@pytest.mark.parametrize("tokenizer", ["simple", "english"])
def test_build_bitwise_against_python_build(tokenizer, max_slots, cluster_layout):
    docs, _ = _corpus()
    docs = docs + TEXTS
    ids = [f"d{i}" for i in range(len(docs))]
    opts = dict(tokenizer=tokenizer, max_slots=max_slots, cluster_layout=cluster_layout)
    j = JSparse(ids, None, **opts)
    j._build_python(docs)
    t = SparseIndex(ids, docs, device="cpu", **opts)
    assert t.vocab == j.vocab and list(t.vocab) == list(j.vocab)  # ids in first-seen order
    assert t.ids == j.ids and t.avgdl == j.avgdl
    for name in ("_slot_ids", "_slot_weights", "doc_freq", "doc_lengths"):
        got, want = getattr(t, name), getattr(j, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    if max_slots:
        assert t._slot_ids.shape[1] == max_slots


def test_build_edge_cases():
    j = JSparse([], None)
    j._build_python([])
    t = SparseIndex([], [], device="cpu")
    assert t._slot_ids.shape == j._slot_ids.shape == (0, 1) and t.avgdl == j.avgdl == 0.0
    j = JSparse(["a", "b"], None)
    j._build_python(["", ""])
    t = SparseIndex(["a", "b"], ["", ""], device="cpu")
    np.testing.assert_array_equal(t._slot_ids, j._slot_ids)
    np.testing.assert_array_equal(t._slot_weights, j._slot_weights)


@pytest.mark.parametrize("max_terms", [None, 2])
def test_encode_queries_and_idf_bitwise(max_terms):
    docs, queries = _corpus(1)
    j = JSparse(list(range(len(docs))), docs)
    t = SparseIndex(list(range(len(docs))), docs, device="cpu")
    jq, tq = j.encode_queries(queries, max_terms), t.encode_queries(queries, max_terms)
    np.testing.assert_array_equal(tq[0], jq[0])
    np.testing.assert_array_equal(tq[1], jq[1])
    assert [t.idf(i) for i in range(20)] == [j.idf(i) for i in range(20)]


def test_score_host_matches_jax():
    docs, queries = _corpus(2)
    j = JSparse(list(range(len(docs))), docs)
    t = SparseIndex(list(range(len(docs))), docs, device="cpu")
    np.testing.assert_array_equal(t.score_host(queries), j.score_host(queries))


# ----------------------------------------------------------------- search
@pytest.mark.parametrize("k", [1, 10, 500])
@pytest.mark.parametrize("tile_skip", [True, False])
def test_search_matches_jax(tile_skip, k):
    docs, queries = _corpus(3)
    ids = [f"doc-{i}" for i in range(len(docs))]
    j = JSparse(ids, docs, tile_skip=tile_skip)
    t = SparseIndex(ids, docs, tile_skip=tile_skip, device="cpu")
    t_hits = t.search(queries, k)
    _assert_hits(t_hits, j.search(queries, k))
    assert t_hits[3] == [] and t_hits[4] == []
    assert all(h.score > 0 for r in t_hits for h in r)
    # hits are the host oracle's positive scores in (-score, row) order
    host = t.score_host(queries)
    for b, hits in enumerate(t_hits):
        order = np.lexsort((np.arange(len(docs)), -host[b]))
        want = [ids[r] for r in order[: min(k, len(docs))] if host[b, r] > 0]
        assert [h.doc_id for h in hits] == want


@pytest.mark.parametrize("k", [1, 10, 500])
@pytest.mark.parametrize("tile_skip", [True, False])
def test_search_flat_layout_matches_jax(tile_skip, k):
    # a corpus wider than 64 slots keeps the flat layout in both packages
    docs, queries = _corpus(3, wide=True)
    ids = [f"doc-{i}" for i in range(len(docs))]
    j = JSparse(ids, docs, tile_skip=tile_skip).to_device()
    t = SparseIndex(ids, docs, tile_skip=tile_skip, device="cpu").to_device()
    assert t._device_pack == getattr(j, "_device_pack", 1) == 1 and t._layout() == "flat"
    t_hits = t.search(queries, k)
    _assert_hits(t_hits, j.search(queries, k))
    assert t_hits[3] == [] and t_hits[4] == [] and t._device_flat is None
    host = t.score_host(queries)
    for b, hits in enumerate(t_hits):
        order = np.lexsort((np.arange(len(docs)), -host[b]))
        want = [ids[r] for r in order[: min(k, len(docs))] if host[b, r] > 0]
        assert [h.doc_id for h in hits] == want


# the leg each pin takes on a flat index off the card (plain versions)
_FLAT_PIN_CALLS = {
    "xla": ("bm25_topk_scan",),
    "pallas_v2": ("bm25_topk_v2_plain",),
    "pallas": ("bm25_topk_v1_plain",),
    "pallas_v2_skip": ("bm25_topk_v2_skip_plain",),
    "pallas_probe": ("bm25_topk_probe_plain",),
    "pallas_wand": ("bm25_topk_probe_plain", "bm25_topk_v2_skip_plain"),
}


@pytest.mark.parametrize("method", ["xla", "pallas_v2", "pallas", "pallas_v2_skip", "pallas_probe",
                                    "pallas_wand"])
def test_search_method_pins_on_cpu(method):
    # a flat index: every pin takes its own leg and gives auto's hits, and the
    # JAX index's (its auto route, and the pin itself where it runs on the
    # CPU: the scan, and the pruned legs in interpret mode)
    from autorag_research_tpu_torch.ops import sparse as ts

    docs, queries = _corpus(4, wide=True)
    ids = list(range(len(docs)))
    t = SparseIndex(ids, docs, device="cpu", probe_block_n=128)
    j = JSparse(ids, docs, probe_block_n=128)
    auto = t.search(queries, 8)
    assert t._layout() == "flat"
    ts.reset_launch_counts()
    pinned = t.search(queries, 8, method=method)
    assert sum(ts.PLAIN_CALLS[n] for n in _FLAT_PIN_CALLS[method]) >= 1
    assert sum(ts.PLAIN_CALLS.values()) == sum(ts.PLAIN_CALLS[n] for n in _FLAT_PIN_CALLS[method])
    assert [[(h.doc_id, h.score) for h in r] for r in pinned] == [[(h.doc_id, h.score) for h in r] for r in auto]
    assert t._device_flat is None
    _assert_hits(pinned, j.search(queries, 8))
    if method not in ("pallas_v2", "pallas"):
        _assert_hits(pinned, j.search(queries, 8, method=method))


@pytest.mark.parametrize("method", ["xla", "pallas_v2", "pallas", "pallas_v2_skip", "pallas_probe",
                                    "pallas_wand"])
def test_search_method_pins_on_packed_index(method):
    # the corpus packs; xla / pallas_v2 / pallas run on a flat upload, the
    # pruned pins fall back to the packed route
    docs, queries = _corpus(4)
    t = SparseIndex(list(range(len(docs))), docs, device="cpu", probe_block_n=128)
    auto = t.search(queries, 8)
    assert t._device_pack > 1 and t._device_flat is None
    pinned = t.search(queries, 8, method=method)
    assert [[(h.doc_id, h.score) for h in r] for r in pinned] == [[(h.doc_id, h.score) for h in r] for r in auto]
    assert (t._device_flat is not None) == (method in ("xla", "pallas_v2", "pallas"))


def _regional_corpus(n=3000, seed=11):
    """Ten regions of local words (docs in region order) plus a common band,
    so a batch of one region's words is selective."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        r = i * 10 // n
        local = [f"r{r}x{j}" for j in rng.choice(300, size=int(rng.integers(3, 20)), replace=False)]
        docs.append(" ".join(local + [f"c{j}" for j in rng.choice(30, size=3)]))
    selective = [" ".join(f"r{b % 2}x{j}" for j in rng.choice(300, size=3)) for b in range(11)]
    common = [" ".join(f"c{j}" for j in rng.choice(30, size=4)) + " r5x1" for _ in range(11)]
    return docs, selective, common


@pytest.mark.parametrize("k", [3, 60])
@pytest.mark.parametrize("kind", ["selective", "common"])
def test_pruned_legs_match_jax(kind, k):
    import jax.numpy as jnp

    from autorag_research_tpu_torch.ops import sparse as ts

    docs, selective, common = _regional_corpus()
    queries = selective if kind == "selective" else common
    ids = list(range(len(docs)))
    j = JSparse(ids, docs)
    t = SparseIndex(ids, docs, device="cpu").to_device()
    j.probe_block_n = t.probe_block_n = 128
    q_ids, q_w = t.encode_queries(queries)
    ts.reset_launch_counts()
    # the flat layout's legs (this short-doc corpus packs: its flat upload)
    s, r = t._search_pruned(q_ids, q_w, *t._flat_device(), k, "auto")
    js_, jr = j._search_pruned(q_ids, q_w, jnp.asarray(j._slot_ids), jnp.asarray(j._slot_weights), k, "auto")
    # selective batches take the probe over the exact candidate tiles; common
    # ones the tile-WAND flow (probe passes, or its Bloom-skip fallback)
    calls = ts.PLAIN_CALLS
    if kind == "selective":
        assert calls["bm25_topk_probe_plain"] == 1 and calls["bm25_topk_v2_skip_plain"] == 0
    else:
        assert calls["bm25_topk_probe_plain"] + calls["bm25_topk_v2_skip_plain"] >= 1
    assert calls["bm25_topk_scan"] == 0
    host = t.score_host(queries)
    js_, jr = np.asarray(js_), np.asarray(jr)
    for b in range(len(queries)):
        order = np.lexsort((np.arange(len(docs)), -host[b]))
        want = [x for x in order[:k] if host[b, x] > 0]
        m = len(want)
        assert r[b, :m].tolist() == want and bool((s[b, m:] <= 0).all())
        np.testing.assert_allclose(s[b, :m].numpy(), js_[b, :m], rtol=RTOL, atol=0)
        assert jr[b, :m].tolist() == want and (js_[b, m:] <= 0).all()


def test_cluster_layout_same_hits_modulo_ties():
    docs, queries = _corpus(5)
    plain = SparseIndex(list(range(len(docs))), docs, device="cpu")
    clust = SparseIndex(list(range(len(docs))), docs, cluster_layout=True, device="cpu")
    for a, b in zip(plain.search(queries, 5), clust.search(queries, 5)):
        assert sorted(h.score for h in a) == sorted(h.score for h in b)


def test_device_layout_pads_slots_to_a_multiple_of_four():
    # the flat layout (here the pins' flat upload of a packed index) pads
    # slots with empty ones; device_bytes counts the layout searched
    docs, queries = _corpus(6)
    t = SparseIndex(list(range(len(docs))), docs, device="cpu").to_device()
    ids, w = t._flat_device()
    assert t._slot_ids.shape[1] == 40 and ids.shape == (len(docs), 40)
    assert t._device_pack == 3 and t.device_bytes() == -(-len(docs) // 3) * 128 * 8
    narrow = SparseIndex(list(range(3)), ["a b c", "a", "b b"], device="cpu").to_device()
    flat = narrow._flat_device()[0]
    assert flat.shape == (3, 4) and (flat[:, 3] == -1).all()
    assert narrow._device[0].shape == (1, 128) and narrow._device_pack == 42
    assert narrow.search(["b"], 3)[0][0].doc_id == 2
    assert narrow.search(["b"], 3, method="xla")[0][0].doc_id == 2


def test_bucketize_and_mesh_raise():
    # bucketize > 1 builds and searches (a one-bucket corpus here); a mesh
    # that is not a DeviceMesh raises (sharding: tests/test_torch_parallel.py)
    from autorag_research_tpu_torch.pipelines.retrieval.bm25 import BM25Pipeline
    from autorag_research_tpu_torch.store.catalog import Catalog

    idx = SparseIndex([0], ["a"], bucketize=3, device="cpu")
    assert [[h.doc_id for h in r] for r in idx.search(["a", "b"], 2)] == [[0], []]
    assert len(idx._device_buckets) == 1
    with pytest.raises(TypeError, match="DeviceMesh"):
        SparseIndex([0], ["a"], device="cpu").to_device(mesh=object())
    cat = Catalog(":memory:")
    assert BM25Pipeline(cat, bucketize=2, device="cpu").bucketize == 2
    cat.close()


# ------------------------------------------------------------ artifacts
def test_artifacts_cross_between_packages(tmp_path):
    docs, queries = _corpus(7)
    ids = [f"d{i}" for i in range(len(docs))]
    j = JSparse(ids, docs, cluster_layout=True)
    j.save(tmp_path / "jax")
    t = SparseIndex.load(tmp_path / "jax", device="cpu")
    assert t.cluster_layout and t.ids == j.ids
    _assert_hits(t.search(queries, 10), j.search(queries, 10))
    t.save(tmp_path / "torch")
    j2 = JSparse.load(tmp_path / "torch")
    for name in ("_slot_ids", "_slot_weights", "doc_freq", "doc_lengths"):
        np.testing.assert_array_equal(getattr(j2, name), getattr(j, name))
    assert (j2.vocab, j2.avgdl, j2.ids) == (j.vocab, j.avgdl, j.ids)
    _assert_hits(t.search(queries, 10), j2.search(queries, 10))


def test_registry_builds_saves_and_reloads_sparse(tmp_path):
    from autorag_research_tpu_torch.index import registry
    from autorag_research_tpu_torch.store.catalog import Catalog

    docs, queries = _corpus(8)
    cat = Catalog(tmp_path / "ws.db")
    cat.add_chunks({"id": i, "contents": d} for i, d in enumerate(docs))
    built = []

    def build():
        built.append(1)
        return SparseIndex.from_catalog(cat, device="cpu")

    assert registry._LOADERS["sparse"][1] == "SparseIndex"
    try:
        first = registry.get_or_build(cat, "sparse", builder=build, device="cpu", tokenizer="simple")
        registry.invalidate(cat)
        again = registry.get_or_build(cat, "sparse", builder=build, device="cpu", tokenizer="simple")
        assert built == [1] and again is not first  # the second one came from the artifact
        assert again.device == torch.device("cpu")
        assert [[h.doc_id for h in r] for r in again.search(queries, 5)] == [
            [h.doc_id for h in r] for r in first.search(queries, 5)
        ]
    finally:
        registry.invalidate(cat)
        cat.close()
