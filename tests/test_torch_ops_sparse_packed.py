"""Port ``ops/sparse.py``'s lane-packed layout and v1 pin vs the JAX package.

The same seeded numpy arrays go through both packages: the JAX Pallas kernels
in ``interpret=True`` at small ``block_n``, as the JAX package's own tests run
them on the CPU; the port's wrappers on CPU tensors, which take their plain
versions. ``pack_slots`` and the tile-WAND stats are compared exactly.
Tolerances as in ``test_torch_ops_sparse.py``: ids equal and scores
``rtol=1e-6`` (XLA may contract the t-ordered multiply-add to an FMA), an id
swap allowed only between two scores within that tolerance; bitwise on
dyadic inputs (every product and sum exact in f32). Within the port the
packed and v1 plain versions equal the v2 plain version on the flat arrays
bitwise. The CUDA kernels are held against these plain versions in
``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ops_sparse import _assert_positive_topk, _assert_topk, _j, _queries, _synthetic, _t

from autorag_research_tpu.ops import sparse as js
from autorag_research_tpu_torch.ops import sparse as ts
from autorag_research_tpu_torch.ops.topk import INT_MAX, NEG_INF

WIDTHS = [1, 3, 16, 19, 24, 33, 64]


def _short_docs(seed, n, width, b=11, t=6, vocab=400, dyadic=False):
    """[n, width] rows of unique terms, 25% of the slots padded at random
    places (pack_slots keeps pads where they lie), and ``b`` queries of
    distinct terms: query 0 all pads, query 1 one unknown term."""
    rng = np.random.default_rng(seed)
    doc_ids = np.stack([rng.choice(vocab, size=width, replace=False) for _ in range(n)]).astype(np.int32)
    if dyadic:
        doc_w = (rng.integers(1, 17, size=(n, width)) / 8.0).astype(np.float32)
    else:
        doc_w = rng.uniform(0.05, 2.5, size=(n, width)).astype(np.float32)
    pad = rng.random((n, width)) < 0.25
    pad[0] = False  # one full row
    doc_ids[pad], doc_w[pad] = -1, 0.0
    q_ids = np.full((b, t), -2, np.int32)
    q_w = np.zeros((b, t), np.float32)
    for i in range(2, b):
        m = int(rng.integers(1, t + 1))
        q_ids[i, :m] = rng.choice(vocab, size=m, replace=False)
        q_w[i, :m] = rng.integers(1, 3, size=m) if dyadic else rng.uniform(0.2, 3.0, size=m)
    q_ids[1, 0], q_w[1, 0] = vocab + 5, 1.0
    return q_ids, q_w, doc_ids, doc_w


# ------------------------------------------------------------- pack_slots
@pytest.mark.parametrize("width", WIDTHS)
def test_pack_slots_bitwise(width):
    n = 301  # N % P != 0 for every width here but 1
    _, _, doc_ids, doc_w = _short_docs(width, n, width)
    # a wider source array whose slots past ``width`` are pads
    wide_ids = np.pad(doc_ids, ((0, 0), (0, 5)), constant_values=-1)
    wide_w = np.pad(doc_w, ((0, 0), (0, 5)))
    for src in ((doc_ids, doc_w), (wide_ids, wide_w)):
        got = ts.pack_slots(*src, width)
        want = js.pack_slots(*src, width)
        assert got[2] == want[2] == max(1, 128 // width)
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    pids, _, pack = got
    stride = 128 // pack
    if pack > 1:
        assert pids.shape == (-(-n // pack), 128)
        assert (pids[:, pack * stride :] == -1).all()  # dead tail lanes
        np.testing.assert_array_equal(pids[(n - 1) // pack, ((n - 1) % pack) * stride :][:width],
                                      doc_ids[n - 1])


def test_pack_slots_refuses_live_terms_beyond_width():
    ids = np.full((4, 32), -1, np.int32)
    ids[:, :20] = 7
    w = np.ones((4, 32), np.float32)
    for pkg in (ts, js):
        with pytest.raises(ValueError, match="beyond"):
            pkg.pack_slots(ids, w, width=16)
    np.testing.assert_array_equal(ts.pack_slots(ids, w, 20)[0], js.pack_slots(ids, w, 20)[0])


# ---------------------------------------------------------- packed kernel
@pytest.mark.parametrize("k", [1, 7, 64, 50])
@pytest.mark.parametrize("width", WIDTHS)
def test_packed_plain_matches_pallas_packed(width, k):
    # k = 50 runs over a corpus of 45 documents: k beyond the corpus
    n = 45 if k == 50 else 301
    q_ids, q_w, doc_ids, doc_w = arrays = _short_docs(width + 100, n, width)
    pids, pw, pack = ts.pack_slots(doc_ids, doc_w, width)
    j = js.bm25_topk_pallas_packed(*_j((q_ids, q_w, pids, pw)), n, k, pack, block_n=128,
                                   interpret=True)
    got = ts.bm25_topk_packed(*_t((q_ids, q_w, pids, pw)), n, k, pack)
    _assert_topk(got, j)
    # within the port: bitwise the v2 plain version on the flat arrays
    flat = ts.bm25_topk_v2_plain(*_t(arrays), k)
    assert all(map(torch.equal, got, flat))
    if k > n:
        assert bool((got[0][:, n:] == NEG_INF).all()) and bool((got[1][:, n:] == INT_MAX).all())


def test_packed_dyadic_bitwise_and_zero_fill():
    q_ids, q_w, doc_ids, doc_w = _short_docs(7, 250, 19, dyadic=True)
    pids, pw, pack = ts.pack_slots(doc_ids, doc_w, 19)
    j = js.bm25_topk_pallas_packed(*_j((q_ids, q_w, pids, pw)), 250, 12, pack, block_n=128,
                                   interpret=True)
    ts.reset_launch_counts()
    got = ts.bm25_topk_packed(*_t((q_ids, q_w, pids, pw)), 250, 12, pack)
    assert ts.PLAIN_CALLS["bm25_topk_packed_plain"] == 1 and sum(ts.LAUNCHES.values()) == 0
    _assert_topk(got, j, exact=True)
    # an empty query's top-k is the first k rows with score 0
    assert got[1][0].tolist() == list(range(12)) and bool((got[0][0] == 0).all())


def test_packed_refuses_a_layout_that_is_not_pack_slots():
    q_ids, q_w, doc_ids, doc_w = _short_docs(8, 50, 16)
    pids, pw, pack = ts.pack_slots(doc_ids, doc_w, 16)
    args = _t((q_ids, q_w, pids, pw))
    with pytest.raises(ValueError, match="pack_slots"):
        ts.bm25_topk_packed(*args, 50 + 8, 5, pack)  # more documents than rows hold
    with pytest.raises(ValueError, match="pack"):
        ts.bm25_topk_packed(*args, 50, 5, 1)


# ----------------------------------------------------------- probe packed
def _probe_case(seed, width=24, block_n=16):
    doc_ids, doc_w = _synthetic(seed=seed)  # 600 docs x 24 slots, ten regions
    doc_ids, doc_w = doc_ids[:, :width], doc_w[:, :width]
    q_ids, q_w = _queries("rare", 13, seed + 30)
    pids, pw, pack = ts.pack_slots(doc_ids, doc_w, width)
    indptr, tiles = ts.build_term_tile_lists(doc_ids, block_n * pack)
    p_tiles = -(-doc_ids.shape[0] // (block_n * pack))
    cand, count, maxc = ts.probe_candidates(q_ids, indptr, tiles, 8, p_tiles)
    return (q_ids, q_w, pids, pw), doc_ids.shape[0], pack, cand, count, (doc_ids, doc_w)


@pytest.mark.parametrize("lists", ["exact", "truncated", "empty"])
@pytest.mark.parametrize("k", [1, 7, 16])
def test_probe_packed_plain_matches_pallas_probe_packed(lists, k):
    packed, n, pack, cand, count, flat = _probe_case(3)
    if lists == "truncated":
        count[1] = 1  # only its first tile is scored
    elif lists == "empty":
        count[:] = 0
    j = js.bm25_topk_pallas_probe_packed(*_j(packed), n, pack, jnp.asarray(cand), jnp.asarray(count),
                                         k=k, block_n=16, interpret=True)
    got = ts.bm25_topk_probe_packed(*_t(packed), n, pack, torch.from_numpy(cand),
                                    torch.from_numpy(count), k, block_n=16)
    _assert_positive_topk(got, j)
    # within the port: bitwise the flat probe over tiles of block_n * pack docs
    ref = ts.bm25_topk_probe_plain(*_t(packed[:2] + flat), torch.from_numpy(cand),
                                   torch.from_numpy(count), k, 16 * pack)
    assert all(map(torch.equal, got, ref))
    if lists == "empty":
        assert bool((got[0] == 0).all()) and bool((got[1] == INT_MAX).all())


def test_probe_packed_refuses_k_beyond_block_n_and_bad_lists():
    packed, n, pack, cand, count, _ = _probe_case(4)
    for pkg_call in (
        lambda: js.bm25_topk_pallas_probe_packed(*_j(packed), n, pack, jnp.asarray(cand),
                                                 jnp.asarray(count), k=17, block_n=16, interpret=True),
        lambda: ts.bm25_topk_probe_packed(*_t(packed), n, pack, torch.from_numpy(cand),
                                          torch.from_numpy(count), 17, block_n=16),
    ):
        with pytest.raises(ValueError, match="block_n"):
            pkg_call()
    with pytest.raises(ValueError, match="query tile"):
        ts.bm25_topk_probe_packed(*_t(packed), n, pack, torch.from_numpy(cand[:1]),
                                  torch.from_numpy(count[:1]), 5, block_n=16)


# -------------------------------------------------------------------- v1
@pytest.mark.parametrize("k", [1, 9, 40])
def test_v1_plain_matches_pallas_v1(k):
    from test_torch_ops_sparse import _data

    arrays = _data(20, b=19, t=9)
    j = js.bm25_topk_pallas(*_j(arrays), k=k, block_q=8, block_n=128, interpret=True)
    ts.reset_launch_counts()
    got = ts.bm25_topk(*_t(arrays), k, method="pallas")
    assert ts.PLAIN_CALLS["bm25_topk_v1_plain"] == 1 and sum(ts.LAUNCHES.values()) == 0
    _assert_topk(got, j)
    assert all(map(torch.equal, got, ts.bm25_topk_v2_plain(*_t(arrays), k)))


def test_v1_dyadic_bitwise_against_pallas_v1_and_v2():
    from test_torch_ops_sparse import _data

    arrays = _data(21, dyadic=True)
    got = ts.bm25_topk_v1(*_t(arrays), 25)
    _assert_topk(got, js.bm25_topk_pallas(*_j(arrays), k=25, block_n=128, interpret=True), exact=True)
    _assert_topk(got, js.bm25_topk_pallas_v2(*_j(arrays), k=25, block_n=128, interpret=True), exact=True)


# -------------------------------------------------------- packed tile WAND
def _wand_packed_case(name):
    """(packed args, flat arrays, queries, kwargs) of one exit of the WAND flow
    over a width-16 packed layout: 4,000 docs, pack 8, 16-row tiles of 128
    documents (32 tiles)."""
    doc_ids, doc_w = _synthetic(n_docs=4000, n_slots=16, seed=8)
    pids, pw, pack = ts.pack_slots(doc_ids, doc_w, 16)
    if name == "single_pass":
        q_ids, q_w = _queries("rare", 2, 6)
        kw = dict(k=7)
    elif name == "two_pass":
        q_ids, q_w = _queries("common", 2, 7, t=4)
        kw = dict(k=5, pass1_tiles=1, scan_fraction=1.1)
    elif name == "fallback_early":
        q_ids, q_w = _queries("common", 9, 9)
        kw = dict(k=5, scan_fraction=0.0)
    else:
        q_ids, q_w = _queries(name, 11, 10)
        kw = dict(k=7)
    return (pids, pw, 4000, pack), (doc_ids, doc_w), (q_ids, q_w), kw


@pytest.mark.parametrize("case", ["single_pass", "two_pass", "fallback_early", "mixed", "common"])
def test_wand_packed_matches_jax_exit_by_exit(case):
    (pids, pw, n, pack), flat, (q_ids, q_w), kw = _wand_packed_case(case)
    trip = ts.build_term_tile_maxw(*flat, 16 * pack)
    js_, ji, jstats = js.bm25_topk_wand(
        jnp.asarray(q_ids), jnp.asarray(q_w), None, None, trip, block_n=16, interpret=True,
        return_stats=True, packed=(jnp.asarray(pids), jnp.asarray(pw), n, pack), **kw,
    )
    ts.reset_launch_counts()
    s, i, stats = ts.bm25_topk_wand(
        *_t((q_ids, q_w)), None, None, trip, block_n=16, return_stats=True,
        packed=(torch.from_numpy(pids), torch.from_numpy(pw), n, pack), **kw,
    )
    assert stats == jstats and stats["n_tiles"] == 32
    two_pass = stats["pass2_tiles_max"] > 0 and not stats["fallback_full"] and not stats["single_pass"]
    assert {"single_pass": stats["single_pass"], "two_pass": two_pass,
            "fallback_early": stats["fallback_early"]}.get(case, True)
    calls = ts.PLAIN_CALLS
    assert calls["bm25_topk_probe_packed_plain"] == (0 if stats["fallback_early"] else 2 if two_pass else 1)
    assert calls["bm25_topk_packed_plain"] == int(stats["fallback_full"])
    assert calls["bm25_topk_probe_plain"] == calls["bm25_topk_scan"] == 0
    # positive hits equal the full scan's, as the JAX package's do
    ref_s, ref_i = ts.bm25_topk_scan(*_t((q_ids, q_w) + flat), kw["k"])
    for b in range(q_ids.shape[0]):
        pos = ref_s[b] > 0
        m = int(pos.sum())
        np.testing.assert_array_equal(i[b, :m].numpy(), ref_i[b, pos].numpy())
        np.testing.assert_array_equal(s[b, :m].numpy(), ref_s[b, pos].numpy())
        assert bool((s[b, m:] <= 0).all()) and bool((np.asarray(js_)[b, m:] <= 0).all())
        np.testing.assert_array_equal(np.asarray(ji)[b, :m], ref_i[b, pos].numpy())


# -------------------------------------------------------------- dispatch
def test_route_rules_packed_layout():
    r = ts.bm25_route
    # probe_block_n 2048 at pack 6 (width 19-21): 341 rows -> 336 (a multiple of 8)
    assert ts.packed_block_rows(2048, 6) == 336 and ts.packed_block_rows(128, 42) == 8
    assert ts.packed_block_rows(2048, 8) == 256 and ts.packed_block_rows(128, 3) == 40
    for pin in ("auto", "pallas_v2_skip", "pallas_probe", "pallas_wand"):  # pruned pins fall back
        assert r(pin, 500_000, 336, "cuda", True, "packed", 6, 2048) == "pruned_packed"
        assert r(pin, 500_000, 337, "cuda", True, "packed", 6, 2048) == "packed"
        assert r(pin, 500_000, 10, "cuda", False, "packed", 6, 2048) == "packed"
        assert r(pin, 5000, 10, "cpu", True, "packed", 6, 2048) == "packed"
    assert r("auto", 100, 5000, "cuda", True, "packed", 6, 2048) == "pruned_packed"  # k_eff = n fits
    # the explicit kernel pins take their flat route on a flat upload
    assert r("xla", 5000, 10, "cuda", True, "packed", 6) == "scan"
    assert r("pallas_v2", 5000, 10, "cuda", True, "packed", 6) == "fused"
    assert r("pallas", 5000, 10, "cpu", True, "packed", 6) == "v1"
    with pytest.raises(ValueError):
        r("nope", 100, 10, "cuda", True, "packed", 6)
    with pytest.raises(ValueError, match="layout"):
        r("auto", 100, 10, "cuda", True, "sharded")


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_route_rules_bucketed_layout(device_type):
    # flat buckets take the whole-corpus route of the method (the pruned pins
    # as auto), whatever tile_skip and k
    r = ts.bm25_route
    auto = "bucketed_fused" if device_type == "cuda" else "bucketed_scan"
    for pin in ("auto", "pallas_v2_skip", "pallas_probe", "pallas_wand"):
        for tile_skip, k in ((True, 10), (False, 10), (True, 5000)):
            assert r(pin, 500_000, k, device_type, tile_skip, "bucketed", 1, 128) == auto
    assert r("xla", 500_000, 10, device_type, True, "bucketed") == "bucketed_scan"
    assert r("pallas_v2", 500_000, 10, device_type, True, "bucketed") == "bucketed_fused"
    assert r("pallas", 500_000, 10, device_type, True, "bucketed") == "bucketed_v1"
    with pytest.raises(ValueError):
        r("nope", 100, 10, device_type, True, "bucketed")


@pytest.mark.parametrize("method,maxc,p_tiles,leg", [
    ("auto", 5, 10, "probe"), ("auto", 6, 10, "wand"), ("auto", 0, 1, "probe"),
    ("auto", 1, 1, "wand"), ("pallas_probe", 10, 10, "probe"), ("pallas_wand", 0, 10, "wand"),
])
def test_pruned_leg(method, maxc, p_tiles, leg):
    assert ts.pruned_leg(method, maxc, p_tiles) == leg
