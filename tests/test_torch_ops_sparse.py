"""Port ``ops/sparse.py`` vs the JAX package's ``ops/sparse.py`` (flat layout).

The same seeded numpy arrays go through both packages. The JAX side runs its
Pallas kernels as its own tests do on the CPU (``interpret=True``,
``block_n=128``); the port runs on CPU tensors, where each kernel wrapper
takes its plain version.

Tolerances: bitwise on dyadic inputs (doc weights that are multiples of 1/8,
query weights 1 or 2: every product and sum is exact in f32). On random
weights ids equal and scores ``rtol=1e-6``, the JAX tests' own tolerance
between v2 and the skip kernel: XLA on the CPU may contract the t-ordered
multiply-add to an FMA, or sum the einsum in another order, which moves a
score by an ulp. An id may differ only where two scores lie within that
tolerance of each other (``_assert_topk`` checks it). The Bloom bitmaps,
the tile predicate, the cluster order, the host term -> tile lists, the
WAND bounds and the probe's candidate lists are compared bitwise; the
tile-WAND search exactly as the JAX one, exit by exit. The CUDA kernels are
held against these plain versions in ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorag_research_tpu.ops import sparse as js
from autorag_research_tpu_torch.ops import sparse as ts
from autorag_research_tpu_torch.ops.topk import INT_MAX, NEG_INF

RTOL = 1e-6


def _data(seed, b=13, t=7, n=500, slots=22, vocab=600, dyadic=False, clustered=False):
    """Doc slot arrays of unique-term rows with scattered pads (an index
    build's shape) and queries of distinct terms; query 0 is all pads and
    query 1 holds one unknown term. ``clustered`` docs draw from a window of
    60 ids around ``row * vocab / n`` and each query from one window."""
    rng = np.random.default_rng(seed)
    doc_ids = np.full((n, slots), -1, np.int32)
    for r in range(n):
        if clustered:
            lo = min(max(0, r * vocab // n - 30), vocab - 60)
            doc_ids[r] = lo + rng.choice(60, size=slots, replace=False)
        else:
            doc_ids[r] = rng.choice(vocab, size=slots, replace=False)
    if dyadic:
        doc_w = (rng.integers(1, 17, size=(n, slots)) / 8.0).astype(np.float32)
    else:
        doc_w = rng.uniform(0.05, 2.5, size=(n, slots)).astype(np.float32)
    pad = rng.random((n, slots)) < 0.25
    doc_ids[pad] = -1
    doc_w[pad] = 0.0
    q_ids = np.full((b, t), -2, np.int32)
    q_w = np.zeros((b, t), np.float32)
    for i in range(2, b):
        m = int(rng.integers(1, t + 1))
        lo = int(rng.integers(0, vocab - 60)) if clustered else 0
        q_ids[i, :m] = lo + rng.choice(60 if clustered else vocab, size=m, replace=False)
        if dyadic:
            q_w[i, :m] = rng.integers(1, 3, size=m)
        else:
            q_w[i, :m] = rng.uniform(0.2, 3.0, size=m).astype(np.float32)
    q_ids[1, 0], q_w[1, 0] = vocab + 11, 1.0
    return q_ids, q_w, doc_ids, doc_w


def _j(arrays):
    return tuple(jnp.asarray(x) for x in arrays)


def _t(arrays):
    return tuple(torch.from_numpy(x) for x in arrays)


def _assert_positive_topk(t_out, j_out, exact=False, k_eff=None):
    """``positive_only`` results: the positive hits as ``_assert_topk``
    holds them, then the port's ``(0.0, INT_MAX)`` filler. The JAX kernel's
    under-full rows hold one ``(0.0, INT_MAX)`` entry and then ``NEG_INF``
    entries with arbitrary rows (``_extract_topk`` masks every copy of its
    identical filler entries in one round); both are fillers of score <= 0,
    which the search drops. Past ``k_eff`` (k beyond the corpus) both pad
    with ``(NEG_INF, INT_MAX)``."""
    ts_, ti = (x.numpy() for x in t_out)
    js_, ji = (np.asarray(x) for x in j_out)
    k_eff = ts_.shape[1] if k_eff is None else k_eff
    for b in range(ts_.shape[0]):
        m = int((js_[b] > 0).sum())
        _assert_topk((torch.from_numpy(ts_[b : b + 1, :m]), torch.from_numpy(ti[b : b + 1, :m])),
                     (js_[b : b + 1, :m], ji[b : b + 1, :m]), exact)
        assert (ts_[b, m:k_eff] == 0).all() and (ti[b, m:] == INT_MAX).all()
        assert (ts_[b, k_eff:] == NEG_INF).all()
        assert (js_[b, m:] <= 0).all()
        if m < js_.shape[1]:
            assert (js_[b, m], ji[b, m]) == (0.0, INT_MAX)


def _assert_topk(t_out, j_out, exact=False):
    ts_, ti = (x.numpy() for x in t_out)
    js_, ji = (np.asarray(x) for x in j_out)
    if exact:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ts_, js_)
        return
    np.testing.assert_allclose(ts_, js_, rtol=RTOL, atol=0)
    # an id swap only between two scores within the tolerance (a near-tie)
    for b, r in zip(*np.nonzero(ti != ji)):
        near = [abs(js_[b, r] - js_[b, x]) <= RTOL * abs(js_[b, r]) for x in (r - 1, r + 1)
                if 0 <= x < js_.shape[1]]
        assert any(near), (b, r)


# ------------------------------------------------------------------ scan
@pytest.mark.parametrize("k", [1, 10, 37])
@pytest.mark.parametrize("seed", [0, 1])
def test_scan_matches_xla(seed, k):
    arrays = _data(seed)
    _assert_topk(ts.bm25_topk_scan(*_t(arrays), k, tile_n=64), js.bm25_topk_xla(*_j(arrays), k=k, tile_n=128))


@pytest.mark.parametrize("k", [5, 40])
def test_scan_dyadic_bitwise_against_xla_and_pallas(k):
    arrays = _data(2, dyadic=True)
    got = ts.bm25_topk_scan(*_t(arrays), k)
    _assert_topk(got, js.bm25_topk_xla(*_j(arrays), k=k, tile_n=128), exact=True)
    _assert_topk(got, js.bm25_topk_pallas_v2(*_j(arrays), k=k, block_n=128, interpret=True), exact=True)
    # tile size does not change a bit
    _assert_topk(got, tuple(np.asarray(x) for x in ts.bm25_topk_scan(*_t(arrays), k, tile_n=32)), exact=True)


# ----------------------------------------------------------------- v2
@pytest.mark.parametrize("k", [1, 8, 33])
def test_v2_plain_matches_pallas_v2(k):
    arrays = _data(3, b=20, t=12)
    j = js.bm25_topk_pallas_v2(*_j(arrays), k=k, block_q=8, block_n=128, interpret=True)
    _assert_topk(ts.bm25_topk_v2(*_t(arrays), k), j)
    _assert_topk(ts.bm25_topk_v2_plain(*_t(arrays), k), j)


def test_v2_plain_dyadic_bitwise_and_zero_fill():
    # query 0 (all pads) and 1 (unknown term) score 0 everywhere: their
    # top-k is the first k rows with score 0, as the JAX kernel returns them
    arrays = _data(4, dyadic=True)
    got = ts.bm25_topk_v2(*_t(arrays), 12)
    j = js.bm25_topk_pallas_v2(*_j(arrays), k=12, block_n=128, interpret=True)
    _assert_topk(got, j, exact=True)
    assert got[1][0].tolist() == list(range(12)) and bool((got[0][:2] == 0).all())


def test_v2_any_k_equals_scan_bitwise():
    # the kernel's lists serve any k; its plain version is the scan's top-k
    arrays = _data(5, dyadic=True)
    for k in (300, 500):
        _assert_topk(ts.bm25_topk_v2(*_t(arrays), k),
                     tuple(np.asarray(x) for x in ts.bm25_topk_scan(*_t(arrays), k)), exact=True)


# ---------------------------------------------------------------- skip
@pytest.mark.parametrize("positive_only", [False, True])
@pytest.mark.parametrize("k", [3, 9, 30])
def test_skip_plain_matches_pallas_skip(positive_only, k):
    arrays = _data(6, b=11, clustered=True)
    bitmaps = js.build_tile_bitmaps(arrays[2], block_n=128, n_words=64)
    j = js.bm25_topk_pallas_v2_skip(
        *_j(arrays), jnp.asarray(bitmaps), k=k, block_q=8, block_n=128,
        positive_only=positive_only, interpret=True,
    )
    got = ts.bm25_topk_v2_skip(*_t(arrays), torch.from_numpy(bitmaps), k, block_n=128,
                               positive_only=positive_only)
    (_assert_positive_topk if positive_only else _assert_topk)(got, j)


def test_skip_positive_only_filler_when_fewer_hits_than_k():
    # a term held by exactly one doc, an unknown term, an empty query: the
    # rows come back as their positive hits, then (0.0, INT_MAX)
    q_ids, q_w, doc_ids, doc_w = _data(7, b=3, dyadic=True)
    doc_ids[299, 0], doc_w[299, 0] = 5000, 1.5
    q_ids[2] = -2
    q_ids[2, 0], q_w[2, 0] = 5000, 2.0
    arrays = (q_ids, q_w, doc_ids, doc_w)
    bitmaps = js.build_tile_bitmaps(doc_ids, block_n=128, n_words=64)
    for positive_only in (False, True):
        j = js.bm25_topk_pallas_v2_skip(
            *_j(arrays), jnp.asarray(bitmaps), k=5, block_n=128,
            positive_only=positive_only, interpret=True,
        )
        got = ts.bm25_topk_v2_skip_plain(*_t(arrays), torch.from_numpy(bitmaps), 5, block_n=128,
                                         positive_only=positive_only)
        (_assert_positive_topk if positive_only else _assert_topk)(got, j, exact=True)
    assert got[0][2].tolist() == [3.0, 0.0, 0.0, 0.0, 0.0]
    assert got[1][2].tolist() == [299] + [INT_MAX] * 4
    assert got[1][0].tolist() == [INT_MAX] * 5


def test_skip_refuses_bitmaps_of_another_block_n():
    arrays = _data(8)
    bitmaps = torch.from_numpy(ts.build_tile_bitmaps(arrays[2], 128, n_words=64))
    with pytest.raises(ValueError, match="block_n"):
        ts.bm25_topk_v2_skip(*_t(arrays), bitmaps, 5, block_n=256)
    with pytest.raises(ValueError, match="block_n"):
        ts.bm25_topk_v2_skip_plain(*_t(arrays), bitmaps, 5, block_n=2048)


# -------------------------------------------------------- Bloom, cluster
@pytest.mark.parametrize("n_words", [None, 64])
@pytest.mark.parametrize("block_n", [64, 128])
def test_tile_bitmaps_bitwise(block_n, n_words):
    doc_ids = _data(9, clustered=True)[2]
    assert ts.bitmap_words_for(doc_ids, block_n) == js.bitmap_words_for(doc_ids, block_n)
    np.testing.assert_array_equal(
        ts.build_tile_bitmaps(doc_ids, block_n, n_words), js.build_tile_bitmaps(doc_ids, block_n, n_words)
    )
    with pytest.raises(ValueError):
        ts.build_tile_bitmaps(doc_ids, block_n, n_words=48)


@pytest.mark.parametrize("b", [3, 8, 13])
def test_tile_match_bitwise(b):
    q_ids, _, doc_ids, _ = _data(10, b=b, t=5, clustered=True)
    bitmaps = js.build_tile_bitmaps(doc_ids, 64)
    bsz_pad = -(-b // 8) * 8
    j = js._tile_match(jnp.asarray(q_ids), jnp.asarray(bitmaps), jnp.arange(bsz_pad) % b, 8)
    got = ts.tile_match(torch.from_numpy(q_ids), torch.from_numpy(bitmaps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j))
    # large term ids exercise the mod-2^32 wrap of the probe
    big = q_ids.copy()
    big[big >= 0] += 2**31 - 1000
    j = js._tile_match(jnp.asarray(big), jnp.asarray(bitmaps), jnp.arange(bsz_pad) % b, 8)
    np.testing.assert_array_equal(ts.tile_match(torch.from_numpy(big), torch.from_numpy(bitmaps)).numpy(),
                                  np.asarray(j))


@pytest.mark.parametrize("qb", [64, 128, 256])
@pytest.mark.parametrize("b", [1, 5, 8, 133, 1024])
def test_tile_group_masks_fold_the_jax_rows(b, qb):
    # the skip walk's masks against the JAX _tile_match, called as it is:
    # bit g of query tile i is the JAX row of 8-query group i qb / 8 + g
    q_ids, _, doc_ids, _ = _data(20 + b, b=b + 2, t=5, clustered=True)
    q_ids = np.ascontiguousarray(q_ids[2:])  # the last b: all real queries
    q_ids[b // 2 + 1 :: 7] = -2  # empty queries, some whole groups among them at b = 1,024
    bitmaps = js.build_tile_bitmaps(doc_ids, 64)
    n_tiles = bitmaps.shape[0]
    bsz_pad = -(-b // 8) * 8
    masks = ts.tile_group_masks(torch.from_numpy(q_ids), torch.from_numpy(bitmaps), qb).numpy()
    q_tiles = -(-b // qb)
    assert masks.shape == (q_tiles, n_tiles) and masks.dtype == np.int32
    bits = (masks.astype(np.int64)[:, None, :] >> np.arange(qb // 8)[None, :, None]) & 1
    groups = bits.reshape(q_tiles * qb // 8, n_tiles).astype(bool)
    # pad rows replicating the last real query: queries past B add nothing
    own = np.asarray(js._tile_match(jnp.asarray(q_ids), jnp.asarray(bitmaps),
                                    jnp.minimum(jnp.arange(bsz_pad), b - 1), 8))
    np.testing.assert_array_equal(groups[: bsz_pad // 8], own)
    assert not groups[bsz_pad // 8 :].any()  # groups past B never set a bit
    # the wrapper's own replication (rows 0..) differs at most in a partial last group
    jax_rows = np.asarray(js._tile_match(jnp.asarray(q_ids), jnp.asarray(bitmaps),
                                         jnp.arange(bsz_pad) % b, 8))
    np.testing.assert_array_equal(groups[: b // 8], jax_rows[: b // 8])
    with pytest.raises(ValueError):
        ts.tile_group_masks(torch.from_numpy(q_ids), torch.from_numpy(bitmaps), 264)


def test_tile_match_no_false_negatives():
    _, _, doc_ids, _ = _data(11, clustered=True)
    bitmaps = torch.from_numpy(ts.build_tile_bitmaps(doc_ids, 128, n_words=64))
    tile0 = np.unique(doc_ids[:128][doc_ids[:128] >= 0])
    q = torch.full((len(tile0), 1), -2, dtype=torch.int32)
    q[:, 0] = torch.from_numpy(tile0)
    per_query = ts.tile_match(q, bitmaps, bq=1)
    assert bool(per_query[:, 0].all())


def test_cluster_doc_order_bitwise():
    rng = np.random.default_rng(12)
    ids = rng.integers(0, 50, size=(400, 8)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    ids[rng.choice(400, size=30, replace=False), 0] = 999
    df = np.bincount(ids[ids >= 0], minlength=1000).astype(np.int64)
    np.testing.assert_array_equal(ts.cluster_doc_order(ids, df), js.cluster_doc_order(ids, df))


# -------------------------------------------------------------- dispatch
def test_route_rules():
    r = ts.bm25_route
    # auto: the card takes the pruned legs with tile_skip while k <= 2048
    # (the JAX package's pruned_ok gate), else the v2 kernel; never the scan
    assert r("auto", 500, 10, "cpu", True) == "scan"
    assert r("auto", 500, 10, "cpu", False) == "scan"
    assert r("auto", 5000, 2048, "cuda", True) == "pruned"
    assert r("auto", 5000, 2049, "cuda", True) == "fused"
    assert r("auto", 200, 5000, "cuda", True) == "pruned"  # k_eff = n <= 2048
    assert r("auto", 5000, 10, "cuda", False) == "fused"
    assert r("auto", 500_000, 1000, "cuda", False) == "fused"
    assert r("xla", 5000, 10, "cuda", True) == "scan"
    assert r("pallas_v2", 5000, 10, "cpu", True) == "fused"
    for method in ("pallas_v2_skip", "pallas_probe", "pallas_wand"):
        assert r(method, 5000, 10, "cpu", False) == "pruned"
        assert r(method, 5000, 10, "cuda", False) == "pruned"
        assert r(method, 5000, 4096, "cuda", True) == "fused"  # k too large: as auto
        assert r(method, 5000, 4096, "cpu", True) == "scan"
    for dev in ("cuda", "cpu"):  # the v1 pin: its kernel on the card, plain off it
        assert r("pallas", 100, 10, dev, True) == "v1"
    with pytest.raises(ValueError):
        r("nope", 100, 10, "cpu", False)


@pytest.mark.parametrize("method", ["auto", "xla", "pallas_v2", "pallas", "pallas_v2_skip"])
def test_bm25_topk_dispatch_on_cpu(method):
    arrays = _data(13, dyadic=True)
    ts.reset_launch_counts()
    if method == "pallas_v2_skip":  # a SparseIndex pin: no whole-corpus route
        with pytest.raises(ValueError, match="pruned"):
            ts.bm25_topk(*_t(arrays), 10, method=method)
        return
    s, i = ts.bm25_topk(*_t(arrays), 10, method=method)
    assert sum(ts.LAUNCHES.values()) == 0 and sum(ts.PLAIN_CALLS.values()) == 1
    ref_s, ref_i = ts.bm25_topk_scan(*_t(arrays), 10)
    np.testing.assert_array_equal(i.numpy(), ref_i.numpy())
    np.testing.assert_array_equal(s.numpy(), ref_s.numpy())


def test_edge_cases_k_beyond_corpus_empty_queries_and_ragged_batches():
    arrays = _data(14, b=11, n=20, slots=6, vocab=40, dyadic=True)
    j = js.bm25_topk_pallas_v2(*_j(arrays), k=25, block_n=128, interpret=True)
    got = ts.bm25_topk_v2(*_t(arrays), 25)
    _assert_topk(got, j, exact=True)
    assert bool((got[0][:, 20:] == NEG_INF).all()) and bool((got[1][:, 20:] == INT_MAX).all())
    bitmaps = js.build_tile_bitmaps(arrays[2], 128)
    j = js.bm25_topk_pallas_v2_skip(*_j(arrays), jnp.asarray(bitmaps), k=25, block_n=128,
                                    positive_only=True, interpret=True)
    _assert_positive_topk(ts.bm25_topk_v2_skip(*_t(arrays), torch.from_numpy(bitmaps), 25, block_n=128,
                                               positive_only=True), j, exact=True, k_eff=20)
    cand = np.array([[0], [0]], np.int32)
    j = js.bm25_topk_pallas_probe(*_j(arrays), jnp.asarray(cand), jnp.asarray(np.array([1, 1], np.int32)),
                                  k=25, block_n=128, interpret=True)
    got = ts.bm25_topk_probe(*_t(arrays), torch.from_numpy(cand), torch.tensor([1, 1], dtype=torch.int32),
                             25, block_n=128)
    _assert_positive_topk(got, j, exact=True, k_eff=20)
    empty = tuple(x[:0] for x in _t(arrays)[:2]) + _t(arrays)[2:]
    s, i = ts.bm25_topk_v2(*empty, 5)
    assert s.shape == (0, 5) and i.shape == (0, 5)


# ------------------------------------------------ term -> tile lists, probe
def _synthetic(n_docs=600, n_slots=24, vocab=5000, seed=0, common_frac=0.3):
    """Ten regions of local terms plus a common band [0, 50) found in every
    region (the JAX package's WAND test corpus)."""
    rng = np.random.default_rng(seed)
    ids = np.full((n_docs, n_slots), -1, np.int32)
    w = np.zeros((n_docs, n_slots), np.float32)
    for i in range(n_docs):
        region = (i * 10 // n_docs) * (vocab // 10)
        n_terms = int(rng.integers(4, n_slots))
        n_common = int(n_terms * common_frac)
        local = region + 50 + rng.choice(vocab // 10 - 50, size=n_terms - n_common, replace=False)
        terms = np.concatenate([rng.choice(50, size=n_common, replace=False), local])
        ids[i, : len(terms)] = terms
        w[i, : len(terms)] = rng.uniform(0.2, 2.0, size=len(terms)).astype(np.float32)
    return ids, w


def _queries(kind, bsz, seed, t=6):
    rng = np.random.default_rng(seed)
    q_ids = np.full((bsz, t), -2, np.int32)
    q_w = np.zeros((bsz, t), np.float32)
    for b in range(bsz):
        region = (b * 3 % 10) * 500 + 50
        if kind == "rare":
            terms = region + rng.choice(400, size=3, replace=False)
        elif kind == "common":
            terms = rng.choice(50, size=3, replace=False)
        else:
            terms = np.concatenate([rng.choice(50, size=2, replace=False),
                                    region + rng.choice(400, size=2, replace=False)])
        q_ids[b, : len(terms)] = terms
        q_w[b, : len(terms)] = rng.uniform(0.5, 1.5, size=len(terms)).astype(np.float32)
    return q_ids, q_w


@pytest.mark.parametrize("block_n", [64, 128])
def test_term_tile_lists_and_maxw_bitwise(block_n):
    doc_ids, doc_w = _synthetic(seed=1)
    doc_ids[5, 3], doc_w[5, 3] = doc_ids[5, 0], 0.75  # one term in two slots of a doc
    for got, want in zip(ts.build_term_tile_lists(doc_ids, block_n),
                         js.build_term_tile_lists(doc_ids, block_n), strict=True):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for got, want in zip(ts.build_term_tile_maxw(doc_ids, doc_w, block_n),
                         js.build_term_tile_maxw(doc_ids, doc_w, block_n), strict=True):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("cap", [3, 5])
def test_probe_candidates_and_wand_bounds_bitwise(cap):
    doc_ids, doc_w = _synthetic(seed=2)
    q_ids, q_w = _queries("mixed", 11, 3)
    q_ids[4, 0] = 99_999  # beyond the vocabulary: no tiles
    indptr, tiles = ts.build_term_tile_lists(doc_ids, 128)
    for got, want in zip(ts.probe_candidates(q_ids, indptr, tiles, 8, cap),
                         js.probe_candidates(q_ids, indptr, tiles, 8, cap), strict=True):
        np.testing.assert_array_equal(got, want)
    trip = ts.build_term_tile_maxw(doc_ids, doc_w, 128)
    for got, want in zip(ts.wand_upper_bounds(q_ids, q_w, *trip, 5),
                         js.wand_upper_bounds(q_ids, q_w, *trip, 5, return_single_best=True), strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 7, 40])
@pytest.mark.parametrize("kind", ["rare", "mixed"])
def test_probe_plain_matches_pallas_probe(kind, k):
    doc_ids, doc_w = _synthetic(seed=3)
    q_ids, q_w = _queries(kind, 13, 4)
    indptr, tiles = ts.build_term_tile_lists(doc_ids, 128)
    cand, count, _ = ts.probe_candidates(q_ids, indptr, tiles, 8, 5)
    count[1] = 1  # a truncated list: only its first tile is scored
    arrays = (q_ids, q_w, doc_ids, doc_w)
    j = js.bm25_topk_pallas_probe(*_j(arrays), jnp.asarray(cand), jnp.asarray(count), k=k,
                                  block_n=128, interpret=True)
    got = ts.bm25_topk_probe(*_t(arrays), torch.from_numpy(cand), torch.from_numpy(count), k, block_n=128)
    _assert_positive_topk(got, j)
    with pytest.raises(ValueError, match="query tile"):
        ts.bm25_topk_probe(*_t(arrays), torch.from_numpy(cand[:1]), torch.from_numpy(count[:1]), k, 128)


def test_probe_dyadic_bitwise_and_all_tiles_listed_equals_scan():
    q_ids, q_w, doc_ids, doc_w = _data(15, b=10, dyadic=True)
    cand = np.tile(np.arange(4, dtype=np.int32), (2, 1))
    count = np.array([4, 4], np.int32)
    arrays = (q_ids, q_w, doc_ids, doc_w)
    got = ts.bm25_topk_probe_plain(*_t(arrays), torch.from_numpy(cand), torch.from_numpy(count), 9, 128)
    j = js.bm25_topk_pallas_probe(*_j(arrays), jnp.asarray(cand), jnp.asarray(count), k=9, block_n=128,
                                  interpret=True)
    _assert_positive_topk(got, j, exact=True)
    ref = ts.bm25_topk_v2_skip_plain(*_t(arrays), torch.from_numpy(ts.build_tile_bitmaps(doc_ids, 128)), 9,
                                     block_n=128, positive_only=True)
    assert all(map(torch.equal, got, ref))


# ------------------------------------------------------------- tile WAND
def _wand_case(name):
    """(doc arrays, queries, kwargs) of one exit of the WAND flow: 4,000 docs,
    32 tiles of 128."""
    doc_ids, doc_w = _synthetic(n_docs=4000, seed=5)
    if name == "single_pass":  # one query tile of two rare-term queries
        q_ids, q_w = _queries("rare", 2, 6)
        return doc_ids, doc_w, q_ids, q_w, dict(k=7)
    if name == "two_pass":  # pass 1 starved to one tile
        q_ids, q_w = _queries("common", 2, 7, t=4)
        return doc_ids, doc_w, q_ids, q_w, dict(k=5, pass1_tiles=1, scan_fraction=1.1)
    if name == "fallback_early":
        q_ids, q_w = _queries("common", 9, 9)
        return doc_ids, doc_w, q_ids, q_w, dict(k=5, scan_fraction=0.0)
    q_ids, q_w = _queries(name, 11, 10)
    return doc_ids, doc_w, q_ids, q_w, dict(k=7)


@pytest.mark.parametrize("case", ["single_pass", "two_pass", "fallback_early", "mixed", "common"])
def test_wand_matches_jax_exit_by_exit(case):
    doc_ids, doc_w, q_ids, q_w, kw = _wand_case(case)
    trip = ts.build_term_tile_maxw(doc_ids, doc_w, 128)
    arrays = (q_ids, q_w, doc_ids, doc_w)
    js_, ji, jstats = js.bm25_topk_wand(*_j(arrays), trip, block_n=128, interpret=True,
                                        return_stats=True, **kw)
    ts.reset_launch_counts()
    s, i, stats = ts.bm25_topk_wand(*_t(arrays), trip, block_n=128, return_stats=True, **kw)
    assert stats == jstats
    two_pass = stats["pass2_tiles_max"] > 0 and not stats["fallback_full"] and not stats["single_pass"]
    assert {"single_pass": stats["single_pass"], "two_pass": two_pass,
            "fallback_early": stats["fallback_early"]}.get(case, True)
    probes = ts.PLAIN_CALLS["bm25_topk_probe_plain"]
    assert probes == (0 if stats["fallback_early"] else 2 if two_pass else 1)
    # positive hits equal the full scan's, as the JAX package's do
    ref_s, ref_i = ts.bm25_topk_scan(*_t(arrays), kw["k"])
    for b in range(q_ids.shape[0]):
        pos = ref_s[b] > 0
        m = int(pos.sum())
        np.testing.assert_array_equal(i[b, :m].numpy(), ref_i[b, pos].numpy())
        np.testing.assert_array_equal(s[b, :m].numpy(), ref_s[b, pos].numpy())
        assert bool((s[b, m:] <= 0).all()) and bool((np.asarray(js_)[b, m:] <= 0).all())
        np.testing.assert_array_equal(np.asarray(ji)[b, :m], ref_i[b, pos].numpy())


def test_wand_fallback_is_called_and_duplicate_slots_dominated():
    doc_ids = np.full((256, 4), -1, np.int32)
    doc_w = np.zeros((256, 4), np.float32)
    doc_ids[:, 0] = np.arange(256) % 97
    doc_w[:, 0] = 1.0
    doc_ids[7], doc_w[7] = 3, 1.0  # term 3 in every slot of doc 7: it scores 4
    trip = ts.build_term_tile_maxw(doc_ids, doc_w, 128)
    q = (np.array([[3, -2]], np.int32), np.array([[1.0, 0.0]], np.float32))
    s, i = ts.bm25_topk_wand(*_t(q + (doc_ids, doc_w)), trip, 3, block_n=128, pass1_tiles=1)
    assert (float(s[0, 0]), int(i[0, 0])) == (4.0, 7)
    called = []
    s, i, stats = ts.bm25_topk_wand(
        *_t(q + (doc_ids, doc_w)), trip, 3, block_n=128, scan_fraction=0.0, return_stats=True,
        fallback=lambda: (called.append(1), ts.bm25_topk_scan(*_t(q + (doc_ids, doc_w)), 3))[1],
    )
    assert called and stats["fallback_full"] and int(i[0, 0]) == 7
