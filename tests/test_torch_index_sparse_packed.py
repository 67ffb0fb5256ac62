"""Port ``index/sparse.py``'s packed and bucketed layouts vs the JAX package's.

Both packages build from the same texts, under 10,000 documents so that both
pack off the card, with ``probe_block_n=128``. On the CPU the JAX index runs
its Pallas kernels in ``interpret=True``; the port's index runs its plain
versions. Hits: ids equal and scores ``rtol=1e-6`` (XLA on the CPU may round
a multiply-add differently), an id swap allowed only between two scores
within that tolerance. The pruned packed legs (``_search_packed_auto``'s
branch on the card) are held against the JAX kernels fed the JAX index's own
term -> tile lists. Layout choices, ``device_bytes`` and artifacts are
compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_index_sparse import _assert_hits

from autorag_research_tpu.index.sparse import SparseIndex as JSparse
from autorag_research_tpu.ops import sparse as js
from autorag_research_tpu_torch.index.sparse import SparseIndex
from autorag_research_tpu_torch.ops import sparse as ts


def _short_corpus(n=3000, seed=21):
    """Short documents (3-19 local words of one of ten regions plus 3 common
    words: at most 22 unique terms, pack 5) and three query batches: selective
    (two regions' words), common (common words and one local word) and mixed."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        r = i * 10 // n
        local = [f"r{r}x{j}" for j in rng.choice(300, size=int(rng.integers(3, 20)), replace=False)]
        docs.append(" ".join(local + [f"c{j}" for j in rng.choice(30, size=3)]))
    selective = [" ".join(f"r{b % 2}x{j}" for j in rng.choice(300, size=3)) for b in range(11)]
    common = [" ".join(f"c{j}" for j in rng.choice(30, size=4)) + " r5x1" for _ in range(11)]
    mixed = [" ".join(f"c{j}" for j in rng.choice(30, size=2)) + f" r{b % 10}x{b}" for b in range(13)]
    mixed[3] = "nothing known"
    return docs, {"selective": selective, "common": common, "mixed": mixed}


def _skewed_corpus(n=2000, seed=22):
    """90% short documents (8-14 words over 400) and 10% long ones (100-127
    unique words over 5,000, so wider than 64 slots): bucketize=2 gives a
    packed short bucket and a flat long one."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        if rng.random() < 0.9:
            docs.append(" ".join(f"s{j}" for j in rng.choice(400, size=int(rng.integers(8, 15)))))
        else:
            size = int(rng.integers(100, 128))
            docs.append(" ".join(f"l{j}" for j in rng.choice(5000, size=size, replace=False)))
    queries = [" ".join(f"s{j}" for j in rng.choice(400, size=3)) + f" l{int(rng.integers(5000))}"
               for _ in range(15)]
    queries[2] = " ".join(f"l{j}" for j in rng.choice(5000, size=4))
    return docs, queries


def _pairs(hits):
    return [[(h.doc_id, h.score) for h in row] for row in hits]


# ----------------------------------------------------- probe_block_n repair
def test_probe_block_n_is_a_constructor_parameter_in_both_packages():
    docs, batches = _short_corpus()
    ids = list(range(len(docs)))
    j = JSparse(ids, docs, probe_block_n=128)
    t = SparseIndex(ids, docs, probe_block_n=128, device="cpu")
    assert t.probe_block_n == j.probe_block_n == 128
    q_ids, q_w = t.encode_queries(batches["selective"])
    # the flat pruned legs at that tile size (the probe, for this batch)
    ts.reset_launch_counts()
    s, r = t._search_pruned(q_ids, q_w, *t._flat_device(), 10, "auto")
    assert ts.PLAIN_CALLS["bm25_topk_probe_plain"] == 1
    js_, jr = j._search_pruned(q_ids, q_w, jnp.asarray(j._slot_ids), jnp.asarray(j._slot_weights), 10,
                               "auto")
    js_, jr = np.asarray(js_), np.asarray(jr)
    for b in range(len(q_ids)):
        m = int((js_[b] > 0).sum())
        assert r[b, :m].tolist() == jr[b, :m].tolist() and bool((s[b, m:] <= 0).all())
        np.testing.assert_allclose(s[b, :m].numpy(), js_[b, :m], rtol=1e-6, atol=0)


# ------------------------------------------------------------ packed layout
@pytest.mark.parametrize("k", [1, 10, 300])
@pytest.mark.parametrize("batch", ["selective", "common", "mixed"])
def test_packed_search_matches_jax(batch, k):
    docs, batches = _short_corpus()
    ids = [f"doc-{i}" for i in range(len(docs))]
    j = JSparse(ids, docs, probe_block_n=128).to_device()
    t = SparseIndex(ids, docs, probe_block_n=128, device="cpu").to_device()
    assert t._device_pack == j._device_pack == 5 and t._slot_ids.shape[1] == 22
    ts.reset_launch_counts()
    t_hits = t.search(batches[batch], k)
    assert ts.PLAIN_CALLS["bm25_topk_packed_plain"] == 1 and ts.PLAIN_CALLS["bm25_topk_scan"] == 0
    _assert_hits(t_hits, j.search(batches[batch], k))
    assert all(h.score > 0 for row in t_hits for h in row)


@pytest.mark.parametrize("k", [3, 24])
@pytest.mark.parametrize("batch", ["selective", "common", "mixed"])
def test_pruned_packed_legs_match_jax(batch, k):
    # _search_packed_auto's branch on the card: the JAX kernels in interpret
    # mode on the JAX index's own term -> tile lists, against the port's
    # leg on CPU tensors (plain versions)
    docs, batches = _short_corpus()
    ids = list(range(len(docs)))
    j = JSparse(ids, docs, probe_block_n=128).to_device()
    t = SparseIndex(ids, docs, probe_block_n=128, device="cpu").to_device()
    pack = j._device_pack
    bn_rows = ts.packed_block_rows(128, pack)
    assert bn_rows == max(8, (128 // pack) // 8 * 8) == 24
    docs_per_tile = bn_rows * pack
    p_tiles = -(-len(docs) // docs_per_tile)
    q_ids, q_w = t.encode_queries(batches[batch])
    cand, count, maxc = js.probe_candidates(q_ids, *j._ensure_term_tiles(docs_per_tile), bq=8, cap=p_tiles)
    leg = ts.pruned_leg("auto", maxc, p_tiles)
    assert leg == ("probe" if batch == "selective" else "wand")
    packed_j = (j._device[0], j._device[1], len(docs), pack)
    if leg == "probe":
        cap = min(p_tiles, max(16, 1 << max(0, maxc - 1).bit_length()))
        js_, jr = js.bm25_topk_pallas_probe_packed(
            jnp.asarray(q_ids), jnp.asarray(q_w), j._device[0], j._device[1], len(docs), pack,
            jnp.asarray(cand[:, :cap]), jnp.asarray(count), k, block_n=bn_rows, interpret=True)
    else:
        js_, jr = js.bm25_topk_wand(jnp.asarray(q_ids), jnp.asarray(q_w), None, None,
                                    j._ensure_term_tiles_maxw(docs_per_tile), k, block_n=bn_rows,
                                    interpret=True, packed=packed_j)
    ts.reset_launch_counts()
    s, r = t._search_packed_pruned(q_ids, q_w, k)
    calls = ts.PLAIN_CALLS
    assert calls["bm25_topk_probe_plain"] == calls["bm25_topk_scan"] == calls["bm25_topk_v2_skip_plain"] == 0
    assert calls["bm25_topk_probe_packed_plain"] + calls["bm25_topk_packed_plain"] >= 1
    js_, jr = np.asarray(js_), np.asarray(jr)
    host = t.score_host(batches[batch])
    for b in range(len(q_ids)):
        order = np.lexsort((np.arange(len(docs)), -host[b]))
        want = [x for x in order[:k] if host[b, x] > 0]
        m = len(want)
        assert r[b, :m].tolist() == want and bool((s[b, m:] <= 0).all())
        assert jr[b, :m].tolist() == want and (js_[b, m:] <= 0).all()
        np.testing.assert_allclose(s[b, :m].numpy(), js_[b, :m], rtol=1e-6, atol=0)


@pytest.mark.parametrize("method", ["xla", "pallas_v2", "pallas", "pallas_v2_skip", "pallas_probe",
                                    "pallas_wand"])
def test_packed_index_pins_match_jax(method):
    # the kernel pins run on a flat upload, the pruned pins fall back to the
    # packed route; every pin gives the JAX index's auto hits
    docs, batches = _short_corpus(n=1500)
    ids = list(range(len(docs)))
    j = JSparse(ids, docs, probe_block_n=128).to_device()
    t = SparseIndex(ids, docs, probe_block_n=128, device="cpu").to_device()
    queries = batches["mixed"]
    j_auto = j.search(queries, 12)
    ts.reset_launch_counts()
    pinned = t.search(queries, 12, method=method)
    _assert_hits(pinned, j_auto)
    flat_pin = method in ("xla", "pallas_v2", "pallas")
    assert (t._device_flat is not None) == flat_pin
    assert (ts.PLAIN_CALLS["bm25_topk_packed_plain"] == 1) != flat_pin
    if method in ("xla", "pallas_probe"):  # the JAX index's pins that run on its CPU
        _assert_hits(pinned, j.search(queries, 12, method=method))
    assert _pairs(pinned) == _pairs(t.search(queries, 12))


def test_packed_layout_choice_and_device_bytes_match_jax():
    docs, _ = _short_corpus(n=1500)
    ids = list(range(len(docs)))
    j = JSparse(ids, docs).to_device()
    t = SparseIndex(ids, docs, device="cpu").to_device()
    # (the JAX index takes its native builder here, whose term ids differ)
    assert t._device_pack == j._device_pack == 5
    assert tuple(t._device[0].shape) == j._device[0].shape == (300, 128)
    assert t.device_bytes() == j.device_bytes() == 300 * 128 * 8
    # the JAX package's factor over its flat layout (22 slots)
    flat_bytes = len(docs) * 22 * 8
    assert flat_bytes / t.device_bytes() == flat_bytes / j.device_bytes()
    # wider than 64, or beyond 10,000 documents off the card: flat, as in JAX
    wide = [" ".join(f"w{q}" for q in range(65))] + docs[:10]
    t_wide = SparseIndex(list(range(11)), wide, device="cpu").to_device()
    j_wide = JSparse(list(range(11)), wide).to_device()
    assert t_wide._device_pack == getattr(j_wide, "_device_pack", 1) == 1
    assert t_wide._device[0].shape == (11, 68)  # 65 slots padded to a multiple of 4


# ---------------------------------------------------------- bucketed layout
@pytest.mark.parametrize("method", ["auto", "xla", "pallas_v2", "pallas", "pallas_probe"])
@pytest.mark.parametrize("k", [5, 40])
def test_bucketed_search_matches_jax_and_flat(k, method):
    docs, queries = _skewed_corpus()
    ids = [f"d{i}" for i in range(len(docs))]
    j = JSparse(ids, docs, bucketize=2).to_device()
    t = SparseIndex(ids, docs, bucketize=2, device="cpu").to_device()
    assert [(b["pack"], int(b["rows"].size)) for b in t._device_buckets] == [
        (b["pack"], int(b["rows"].size)) for b in j._device_buckets
    ]
    assert t._device_buckets[0]["pack"] > 1 and t._device_buckets[1]["pack"] == 1
    ts.reset_launch_counts()
    t_hits = t.search(queries, k, method=method)
    assert ts.PLAIN_CALLS["bm25_topk_packed_plain"] == 1  # the short bucket, whatever the pin
    _assert_hits(t_hits, j.search(queries, k, method="xla" if method != "auto" else "auto"))
    flat = SparseIndex(ids, docs, device="cpu")
    assert _pairs(t_hits) == _pairs(flat.search(queries, k))
    assert t_hits[2] and all(h.doc_id in {ids[r] for r in t._device_buckets[1]["rows"]}
                             for h in t_hits[2])


def test_bucketed_device_bytes_match_jax():
    docs, _ = _skewed_corpus()
    ids = list(range(len(docs)))
    j = JSparse(ids, docs, bucketize=2).to_device()
    t = SparseIndex(ids, docs, bucketize=2, device="cpu").to_device()
    long_w = j._device_buckets[1]["slot_ids"].shape[1]
    pad = (-long_w) % 4  # the port pads a flat bucket's slots to a multiple of 4
    assert t.device_bytes() == j.device_bytes() + int(t._device_buckets[1]["rows"].size) * pad * 8
    flat = SparseIndex(ids, docs, device="cpu").to_device()
    assert t.device_bytes() < flat.device_bytes() / 2


def test_bucketed_edge_cases():
    # an empty corpus and a corpus of one bucket
    t = SparseIndex([], [], bucketize=2, device="cpu")
    assert t.search(["a"], 3) == [[]] and t.device_bytes() == 0
    t = SparseIndex(["a", "b"], ["x y", "y"], bucketize=3, device="cpu")
    flat = SparseIndex(["a", "b"], ["x y", "y"], device="cpu")
    assert _pairs(t.search(["y", "x", "z"], 5)) == _pairs(flat.search(["y", "x", "z"], 5))


# ------------------------------------------------------------ artifacts
def test_bucketed_and_packed_artifacts_cross_between_packages(tmp_path):
    docs, queries = _skewed_corpus(n=600)
    ids = [f"d{i}" for i in range(len(docs))]
    j = JSparse(ids, docs, bucketize=2, probe_block_n=128)
    j.save(tmp_path / "jax")
    t = SparseIndex.load(tmp_path / "jax", device="cpu")
    assert (t.bucketize, t.probe_block_n) == (2, 128)
    _assert_hits(t.search(queries, 10), j.search(queries, 10))
    t.save(tmp_path / "torch")
    j2 = JSparse.load(tmp_path / "torch")
    assert (j2.bucketize, j2.probe_block_n) == (2, 128)
    _assert_hits(t.search(queries, 10), j2.search(queries, 10))
    # a packed (short-doc) index the other way
    sdocs, batches = _short_corpus(n=800)
    t = SparseIndex(list(range(800)), sdocs, probe_block_n=256, device="cpu")
    t.save(tmp_path / "short")
    j3 = JSparse.load(tmp_path / "short").to_device()
    t3 = SparseIndex.load(tmp_path / "short", device="cpu").to_device()
    assert t3.probe_block_n == j3.probe_block_n == 256 and t3._device_pack == j3._device_pack == 5
    _assert_hits(t3.search(batches["mixed"], 7), j3.search(batches["mixed"], 7))


def test_registry_builds_bucketed_sparse(tmp_path):
    from autorag_research_tpu_torch.index import registry
    from autorag_research_tpu_torch.pipelines.retrieval.bm25 import BM25Pipeline
    from autorag_research_tpu_torch.store.catalog import Catalog

    docs, queries = _skewed_corpus(n=300)
    cat = Catalog(tmp_path / "ws.db")
    cat.add_chunks({"id": i, "contents": d} for i, d in enumerate(docs))
    try:
        idx = BM25Pipeline(cat, bucketize=2, device="cpu")._index()
        assert idx.bucketize == 2 and idx._device_buckets is None  # uploaded on first search
        registry.invalidate(cat)
        again = BM25Pipeline(cat, bucketize=2, device="cpu")._index()  # from the artifact
        assert again is not idx and again.bucketize == 2
        assert _pairs(again.search(queries, 5)) == _pairs(idx.search(queries, 5))
        assert again._device_buckets is not None
    finally:
        registry.invalidate(cat)
        cat.close()
