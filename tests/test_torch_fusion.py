"""The port's ``ops/fusion.py`` against the JAX package's.

- The host fusers (``rrf_fuse``, ``cc_fuse``, ``id_tiebreak_sort``) are the
  JAX package's code: on the same leg lists they give its output bitwise,
  for every normalization, missing-score floors, documents in one or both
  lists, ties broken by id and mixed id types.
- The device fusers (``fuse_batch_rrf``, ``fuse_batch_cc``) are plain PyTorch
  in f32 over the port's ``sort_topk``; on the same padded arrays they give
  the JAX functions' ids, scores within 1e-6 (``RTOL``, ``ATOL``: f32 sums
  may add in another order), and agree row by row with the host fusers.
- The cases of ``tests/test_hybrid.py`` that touch ``ops/fusion.py``
  (``TestRRF``, ``TestCC``, ``TestDeviceCC``, ``TestReviewRegressions``,
  ``TestFusionHostDeviceFuzz``), run through both packages.
"""

import numpy as np
import pytest

from autorag_research_tpu.ops import fusion as jf
from autorag_research_tpu_torch.ops import fusion as tf
from autorag_research_tpu_torch.ops.topk import INT_MAX

RTOL, ATOL = 1e-6, 1e-6
METHODS = [("mm", (None, None)), ("tmm", (-1.0, 0.0)), ("z", (None, None)), ("dbsf", (None, None))]


def hits(pairs):
    return [{"doc_id": d, "score": s} for d, s in pairs]


def _np(out):
    """(scores, ids) of either package -> numpy."""
    s, i = out
    if hasattr(s, "detach"):
        return s.detach().cpu().numpy(), i.detach().cpu().numpy()
    return np.asarray(s), np.asarray(i)


def _legs(rng, n1, n2, pool, ids="int", ties=False):
    """Two ranked leg lists over one pool of documents: overlapping and
    disjoint parts, cosine-like and BM25-like scores (quantized to force
    ties when ``ties``)."""
    docs = rng.choice(pool, size=n1 + n2, replace=True)
    s1 = np.sort(rng.uniform(-0.5, 1.0, size=n1))[::-1]
    s2 = np.sort(rng.uniform(0.0, 20.0, size=n2))[::-1]
    if ties:
        s1, s2 = np.round(s1 * 4) / 4, np.round(s2 / 4) * 4

    def name(d):
        d = int(d)
        if ids == "str":
            return f"doc-{d}"
        if ids == "mixed":
            return f"doc-{d}" if d % 3 == 0 else d
        return d

    l1 = list(dict.fromkeys(name(d) for d in docs[:n1]))
    l2 = list(dict.fromkeys(name(d) for d in docs[n1:]))
    return hits(zip(l1, map(float, s1))), hits(zip(l2, map(float, s2)))


# --------------------------------------------------------------- host fusers
@pytest.mark.parametrize("ids", ["int", "str", "mixed"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("seed", range(6))
def test_rrf_fuse_bitwise_jax(seed, ties, ids):
    rng = np.random.default_rng(1000 + seed)
    fetch_k = int(rng.integers(1, 12))
    r1, r2 = _legs(rng, fetch_k, int(rng.integers(0, fetch_k + 1)), 3 * fetch_k, ids, ties)
    for top_k in (1, fetch_k, 3 * fetch_k):
        for k in (1, 60):
            got = tf.rrf_fuse(r1, r2, k=k, top_k=top_k, fetch_k=fetch_k)
            assert got == jf.rrf_fuse(r1, r2, k=k, top_k=top_k, fetch_k=fetch_k)


@pytest.mark.parametrize("method,mins", METHODS, ids=[m for m, _ in METHODS])
@pytest.mark.parametrize("ids", ["int", "str", "mixed"])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("seed", range(4))
def test_cc_fuse_bitwise_jax(seed, ties, ids, method, mins):
    rng = np.random.default_rng(2000 + seed)
    fetch_k = int(rng.integers(1, 12))
    r1, r2 = _legs(rng, fetch_k, int(rng.integers(0, fetch_k + 1)), 3 * fetch_k, ids, ties)
    for weight in (0.0, 0.3, 0.5, 1.0):
        for top_k in (1, 2 * fetch_k):
            kw = dict(weight=weight, top_k=top_k, normalize_method=method,
                      pipeline_1_min=mins[0], pipeline_2_min=mins[1])
            assert tf.cc_fuse(r1, r2, **kw) == jf.cc_fuse(r1, r2, **kw)


@pytest.mark.parametrize("method", ["mm", "tmm", "z", "dbsf"])
def test_cc_fuse_degenerate_lists_bitwise_jax(method):
    """Empty legs, one document, all-equal scores (the 0.5 / 0.0 cases),
    documents in one list only (the floors)."""
    mins = dict(pipeline_1_min=-1.0, pipeline_2_min=0.0) if method == "tmm" else {}
    cases = [
        ([], []),
        (hits([(1, 0.5)]), []),
        ([], hits([(2, 3.0)])),
        (hits([(1, 0.5), (2, 0.5), (3, 0.5)]), hits([(3, 7.0), (4, 7.0)])),
        (hits([(1, 1.0), (2, 0.0)]), hits([(3, 5.0), (4, 1.0)])),
        (hits([("a", -1.0), ("b", -1.0)]), hits([("a", 0.0)])),
    ]
    for r1, r2 in cases:
        kw = dict(weight=0.5, top_k=5, normalize_method=method, **mins)
        assert tf.cc_fuse(r1, r2, **kw) == jf.cc_fuse(r1, r2, **kw)


def test_host_fuser_refusals_match_jax():
    for mod in (tf, jf):
        with pytest.raises(ValueError, match="unknown normalization"):
            mod.cc_fuse(hits([(1, 1.0)]), hits([(1, 1.0)]), normalize_method="l2")
        with pytest.raises(ValueError, match="tmm normalization requires"):
            mod.cc_fuse(hits([(1, 1.0)]), hits([(1, 1.0)]), normalize_method="tmm",
                        pipeline_1_min=0.0)


@pytest.mark.parametrize("mixed", [False, True], ids=["ints", "ints-and-strs"])
def test_id_tiebreak_sort_matches_jax(mixed):
    rng = np.random.default_rng(7)
    items = [(int(i) if not (mixed and i % 2) else f"d{i}", float(s))
             for i, s in zip(rng.permutation(40), np.round(rng.uniform(0, 3, 40)))]
    got = tf.id_tiebreak_sort(items, lambda t: t[1], lambda t: t[0])
    assert got == jf.id_tiebreak_sort(items, lambda t: t[1], lambda t: t[0])


# -------------------------------------------------------------- device fusers
def _padded(rng, b, f, pool, pad, dup_rate=0.5):
    """[B, F] leg arrays with short rows padded by ``pad`` ids (scores
    NEG_INF-like) and documents shared across the legs."""
    ids_1 = np.full((b, f), pad, np.int32)
    ids_2 = np.full((b, f), pad, np.int32)
    s_1 = np.full((b, f), -3.4e38, np.float32)
    s_2 = np.full((b, f), -3.4e38, np.float32)
    for r in range(b):
        n1, n2 = int(rng.integers(0, f + 1)), int(rng.integers(0, f + 1))
        a = rng.choice(pool, size=n1, replace=False)
        shared = [d for d in a if rng.random() < dup_rate][:n2]
        rest = [d for d in rng.permutation(pool) if d not in a][: n2 - len(shared)]
        c = np.array(list(shared) + list(rest), np.int64)[:n2]
        rng.shuffle(c)
        ids_1[r, :n1], ids_2[r, : len(c)] = a, c
        s_1[r, :n1] = np.sort(rng.uniform(-0.5, 1.0, n1))[::-1]
        s_2[r, : len(c)] = np.sort(rng.uniform(0.0, 20.0, len(c)))[::-1]
    return ids_1, s_1, ids_2, s_2


def _rows_of(ids, scores):
    return [
        hits((int(i), float(s)) for i, s in zip(ir, sr) if i >= 0 and i != INT_MAX)
        for ir, sr in zip(ids, scores)
    ]


def _assert_same(got, ref):
    gs, gi = _np(got)
    rs, ri = _np(ref)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gs, rs, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pad", [-1, INT_MAX], ids=["pad-1", "pad-intmax"])
@pytest.mark.parametrize("seed", range(5))
def test_fuse_batch_rrf_matches_jax(seed, pad):
    rng = np.random.default_rng(3000 + seed)
    f = int(rng.integers(1, 12))
    ids_1, _, ids_2, _ = _padded(rng, 16, f, 3 * f + 1, pad)
    for top_k in (1, f, 2 * f, 2 * f + 3):  # past the union's width too
        got = tf.fuse_batch_rrf(ids_1, ids_2, k=60, top_k=top_k, fetch_k=f)
        _assert_same(got, jf.fuse_batch_rrf(ids_1, ids_2, k=60, top_k=top_k, fetch_k=f))


@pytest.mark.parametrize("method,mins", METHODS, ids=[m for m, _ in METHODS])
@pytest.mark.parametrize("pad", [-1, INT_MAX], ids=["pad-1", "pad-intmax"])
@pytest.mark.parametrize("seed", range(4))
def test_fuse_batch_cc_matches_jax(seed, pad, method, mins):
    rng = np.random.default_rng(4000 + seed)
    f = int(rng.integers(1, 12))
    ids_1, s_1, ids_2, s_2 = _padded(rng, 16, f, 3 * f + 1, pad)
    for top_k in (1, f, 2 * f + 3):
        kw = dict(weight=0.3, top_k=top_k, normalize_method=method,
                  pipeline_1_min=mins[0], pipeline_2_min=mins[1])
        got = tf.fuse_batch_cc(ids_1, s_1, ids_2, s_2, **kw)
        _assert_same(got, jf.fuse_batch_cc(ids_1, s_1, ids_2, s_2, **kw))


def test_fuse_batch_cc_computes_f64_input_in_f32():
    """f64 numpy scores are computed in f32, as the JAX package (x64 off)
    computes them: the same result as f32 input, bitwise."""
    rng = np.random.default_rng(5)
    ids_1, s_1, ids_2, s_2 = _padded(rng, 8, 6, 20, -1)
    s_1[s_1 < -1e30] = -1.0
    s_2[s_2 < -1e30] = -1.0
    for method, (m1, m2) in METHODS:
        kw = dict(weight=0.5, top_k=8, normalize_method=method, pipeline_1_min=m1,
                  pipeline_2_min=m2)
        a = _np(tf.fuse_batch_cc(ids_1, s_1.astype(np.float64), ids_2,
                                 s_2.astype(np.float64), **kw))
        b = _np(tf.fuse_batch_cc(ids_1, s_1, ids_2, s_2, **kw))
        assert a[0].dtype == np.float32
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        _assert_same(a, jf.fuse_batch_cc(ids_1, s_1.astype(np.float64), ids_2,
                                         s_2.astype(np.float64), **kw))


@pytest.mark.parametrize("pad", [-1, INT_MAX], ids=["pad-1", "pad-intmax"])
@pytest.mark.parametrize("seed", range(3))
def test_device_fusers_agree_with_host_fusers_row_by_row(seed, pad):
    rng = np.random.default_rng(6000 + seed)
    f = int(rng.integers(2, 12))
    ids_1, s_1, ids_2, s_2 = _padded(rng, 24, f, 3 * f + 1, pad)
    rows_1, rows_2 = _rows_of(ids_1, s_1), _rows_of(ids_2, s_2)
    top_k = 2 * f
    ds, di = _np(tf.fuse_batch_rrf(ids_1, ids_2, k=60, top_k=top_k, fetch_k=f))
    for r, (a, b) in enumerate(zip(rows_1, rows_2)):
        host = tf.rrf_fuse(a, b, k=60, top_k=top_k, fetch_k=f)
        assert [int(i) for i in di[r, : len(host)]] == [h["doc_id"] for h in host]
        np.testing.assert_allclose(ds[r, : len(host)], [h["score"] for h in host], rtol=RTOL)
        assert np.all(ds[r, len(host):] == -np.inf) or np.all(ds[r, len(host):] < -1e37)
    for method, (m1, m2) in METHODS:
        kw = dict(weight=0.4, top_k=top_k, normalize_method=method, pipeline_1_min=m1,
                  pipeline_2_min=m2)
        ds, di = _np(tf.fuse_batch_cc(ids_1, s_1, ids_2, s_2, **kw))
        for r, (a, b) in enumerate(zip(rows_1, rows_2)):
            host = tf.cc_fuse(a, b, **kw)
            np.testing.assert_allclose(
                ds[r, : len(host)], [h["score"] for h in host], rtol=RTOL, atol=ATOL
            )
            # ids equal but where two fused scores lie within the tolerance
            for j, h in enumerate(host):
                if int(di[r, j]) != h["doc_id"]:
                    assert abs(float(ds[r, j]) - h["score"]) <= ATOL + RTOL * abs(h["score"])


# ------------------------------------------- tests/test_hybrid.py, both packages
PKGS = pytest.mark.parametrize("mod", [jf, tf], ids=["jax", "torch"])


@PKGS
def test_rrf_basic_fusion(mod):
    r1 = hits([("a", 0.9), ("b", 0.8), ("c", 0.7)])
    r2 = hits([("b", 10.0), ("d", 5.0)])
    out = mod.rrf_fuse(r1, r2, k=60, top_k=4, fetch_k=3)
    by_id = {h["doc_id"]: h["score"] for h in out}
    missing = 1.0 / (60 + 3 + 1)
    assert by_id["b"] == pytest.approx(1 / 62 + 1 / 61)
    assert by_id["a"] == pytest.approx(1 / 61 + missing)
    assert by_id["d"] == pytest.approx(1 / 62 + missing)
    assert out[0]["doc_id"] == "b"
    assert out == jf.rrf_fuse(r1, r2, k=60, top_k=4, fetch_k=3)


@PKGS
def test_rrf_rank_based_ignores_scores(mod):
    out = mod.rrf_fuse(hits([("a", 1000.0)]), hits([("b", 0.001)]), k=60, top_k=2, fetch_k=1)
    assert out[0]["score"] == pytest.approx(out[1]["score"])


@PKGS
def test_rrf_device_batch_matches_host(mod):
    r1 = hits([(3, 0.9), (1, 0.8), (7, 0.7)])
    r2 = hits([(1, 10.0), (9, 5.0), (3, 1.0)])
    host = mod.rrf_fuse(r1, r2, k=60, top_k=4, fetch_k=3)
    ids_1 = np.array([[3, 1, 7]], dtype=np.int32)
    ids_2 = np.array([[1, 9, 3]], dtype=np.int32)
    scores, ids = _np(mod.fuse_batch_rrf(ids_1, ids_2, k=60, top_k=4, fetch_k=3))
    assert list(ids[0]) == [h["doc_id"] for h in host]
    np.testing.assert_allclose(scores[0], [h["score"] for h in host], rtol=1e-6)


@PKGS
def test_cc_mm_fusion(mod):
    r1 = hits([("a", 0.9), ("b", 0.5), ("c", 0.1)])
    r2 = hits([("b", 20.0), ("c", 10.0)])
    out = mod.cc_fuse(r1, r2, weight=0.5, top_k=3, normalize_method="mm")
    by_id = {h["doc_id"]: h["score"] for h in out}
    assert by_id["a"] == pytest.approx(0.5 * 1.0 + 0.5 * 0.0)
    assert by_id["b"] == pytest.approx(0.5 * 0.5 + 0.5 * 1.0)
    assert out[0]["doc_id"] == "b"


@PKGS
def test_cc_weight_extremes(mod):
    r1 = hits([("a", 1.0), ("b", 0.5)])
    r2 = hits([("b", 1.0), ("a", 0.5)])
    assert mod.cc_fuse(r1, r2, weight=1.0, top_k=2, normalize_method="mm")[0]["doc_id"] == "a"
    assert mod.cc_fuse(r1, r2, weight=0.0, top_k=2, normalize_method="mm")[0]["doc_id"] == "b"


@PKGS
def test_cc_z_floor(mod):
    out = mod.cc_fuse(hits([("a", 1.0), ("b", 0.0)]), hits([("a", 5.0)]),
                      weight=0.5, top_k=2, normalize_method="z")
    by_id = {h["doc_id"]: h["score"] for h in out}
    assert by_id["b"] == pytest.approx(0.5 * -1.0 + 0.5 * -3.0)


@PKGS
def test_cc_tmm_requires_mins(mod):
    with pytest.raises(ValueError):
        mod.cc_fuse(hits([("a", 1.0)]), hits([("a", 1.0)]), normalize_method="tmm")


@PKGS
def test_cc_tmm_with_mins(mod):
    out = mod.cc_fuse(
        hits([("a", 0.5), ("b", -0.5)]), hits([("a", 4.0), ("b", 2.0)]),
        weight=0.5, top_k=2, normalize_method="tmm", pipeline_1_min=-1.0, pipeline_2_min=0.0,
    )
    by_id = {h["doc_id"]: h["score"] for h in out}
    assert by_id["a"] == pytest.approx(0.5 * 1.0 + 0.5 * 1.0)
    assert by_id["b"] == pytest.approx(0.5 * (0.5 / 1.5) + 0.5 * 0.5)


@PKGS
@pytest.mark.parametrize("method,mins", [
    ("mm", (None, None)), ("z", (None, None)), ("dbsf", (None, None)), ("tmm", (-1.0, 0.0)),
])
def test_device_cc_matches_host(mod, method, mins):
    r1 = hits([(3, 0.9), (1, 0.5), (7, 0.2)])
    r2 = hits([(1, 12.0), (9, 6.0), (3, 1.0)])
    host = mod.cc_fuse(r1, r2, weight=0.3, top_k=4, normalize_method=method,
                       pipeline_1_min=mins[0], pipeline_2_min=mins[1])
    scores, ids = _np(mod.fuse_batch_cc(
        np.array([[3, 1, 7]], np.int32), np.array([[0.9, 0.5, 0.2]], np.float32),
        np.array([[1, 9, 3]], np.int32), np.array([[12.0, 6.0, 1.0]], np.float32),
        weight=0.3, top_k=4, normalize_method=method,
        pipeline_1_min=mins[0], pipeline_2_min=mins[1],
    ))
    assert list(ids[0]) == [h["doc_id"] for h in host]
    np.testing.assert_allclose(scores[0], [h["score"] for h in host], rtol=1e-5, atol=1e-6)


@PKGS
def test_device_rrf_ignores_intmax_pads(mod):
    scores, ids = _np(mod.fuse_batch_rrf(
        np.array([[5, 7, INT_MAX]], np.int32), np.array([[7, INT_MAX, INT_MAX]], np.int32),
        k=60, top_k=3, fetch_k=3,
    ))
    assert INT_MAX not in ids[0][:2]
    assert ids[0][0] == 7


@PKGS
def test_device_cc_ignores_intmax_pads(mod):
    scores, ids = _np(mod.fuse_batch_cc(
        np.array([[5, 7, INT_MAX]], np.int32), np.array([[0.9, 0.5, -3.4e38]], np.float32),
        np.array([[7, INT_MAX, INT_MAX]], np.int32),
        np.array([[4.0, -3.4e38, -3.4e38]], np.float32),
        weight=0.5, top_k=3, normalize_method="mm",
    ))
    host = mod.cc_fuse(hits([(5, 0.9), (7, 0.5)]), hits([(7, 4.0)]),
                       weight=0.5, top_k=3, normalize_method="mm")
    assert list(ids[0][:2]) == [h["doc_id"] for h in host[:2]]
    np.testing.assert_allclose(scores[0][:2], [h["score"] for h in host[:2]], rtol=1e-5)


@PKGS
def test_host_fusers_int_id_tiebreak(mod):
    out = mod.rrf_fuse(hits([(10, 1.0)]), hits([(2, 1.0)]), k=60, top_k=2, fetch_k=1)
    assert [h["doc_id"] for h in out] == [2, 10]


@PKGS
@pytest.mark.parametrize("seed", range(4))
def test_fuzz_rrf_agreement(mod, seed):
    rng = np.random.default_rng(300 + seed)
    fetch_k = int(rng.integers(2, 9))
    top_k = int(rng.integers(1, 2 * fetch_k + 1))
    pool = int(rng.integers(fetch_k, 4 * fetch_k))
    ids_1 = rng.choice(pool, size=fetch_k, replace=False).astype(np.int32)
    ids_2 = rng.choice(pool, size=fetch_k, replace=False).astype(np.int32)
    r1 = hits([(int(i), float(fetch_k - r)) for r, i in enumerate(ids_1)])
    r2 = hits([(int(i), float(fetch_k - r)) for r, i in enumerate(ids_2)])
    host = mod.rrf_fuse(r1, r2, k=60, top_k=top_k, fetch_k=fetch_k)
    scores, ids = _np(mod.fuse_batch_rrf(ids_1[None, :], ids_2[None, :], k=60, top_k=top_k,
                                         fetch_k=fetch_k))
    assert [int(i) for i in ids[0][: len(host)]] == [h["doc_id"] for h in host]
    np.testing.assert_allclose(scores[0][: len(host)], [h["score"] for h in host], rtol=1e-6)


@PKGS
@pytest.mark.parametrize("seed", range(4))
def test_fuzz_cc_agreement(mod, seed):
    rng = np.random.default_rng(400 + seed)
    fetch_k = int(rng.integers(2, 8))
    top_k = int(rng.integers(1, fetch_k + 2))
    weight = float(rng.uniform(0.1, 0.9))
    pool = int(rng.integers(fetch_k, 3 * fetch_k))
    ids_1 = rng.choice(pool, size=fetch_k, replace=False).astype(np.int32)
    ids_2 = rng.choice(pool, size=fetch_k, replace=False).astype(np.int32)
    s1 = np.sort(rng.uniform(-0.5, 1.0, size=fetch_k))[::-1].astype(np.float32)
    s2 = np.sort(rng.uniform(0.0, 10.0, size=fetch_k))[::-1].astype(np.float32)
    r1 = hits([(int(i), float(s)) for i, s in zip(ids_1, s1)])
    r2 = hits([(int(i), float(s)) for i, s in zip(ids_2, s2)])
    host = mod.cc_fuse(r1, r2, weight=weight, top_k=top_k, normalize_method="mm")
    scores, ids = _np(mod.fuse_batch_cc(ids_1[None, :], s1[None, :], ids_2[None, :],
                                        s2[None, :], weight=weight, top_k=top_k,
                                        normalize_method="mm"))
    assert [int(i) for i in ids[0][: len(host)]] == [h["doc_id"] for h in host]
    np.testing.assert_allclose(scores[0][: len(host)], [h["score"] for h in host],
                               rtol=1e-5, atol=1e-6)
