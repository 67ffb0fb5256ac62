"""The port's corpus-sharded retrieval (``parallel/*``) against the JAX
package's, on the CPU.

The JAX side runs on the root conftest's 8 virtual CPU devices with
``corpus_mesh(n_corpus=P)``; the port's side on a mesh that lists the CPU P
times (``corpus_mesh(n_corpus=P, devices=[cpu] * P)``), its stand-in for
virtual devices. Data are seeded numpy, awkward sizes (17-203 rows), exact
duplicate rows (ties across shards), a query whose every real score is
negative (zero pad rows would displace real documents without the
overfetch), and k above a shard's rows.

Tolerances: ids equal, in ``(-score, id)`` order. The engines' operands are
dyadic (multiples of 1/4, small), so f32 products and sums are exact in
both packages and exact-mode scores agree to 1e-6 absolute; the index
wrappers' normalized data to 1e-5 (cosine) and 1e-6 relative (BM25), as in
``tests/test_torch_slice.py``. int8 modes give the JAX package's ids and
scores (1e-6 relative) and, against f32 exact on Gaussian data, at least the
0.9 top-10 agreement ``chip_smoke.py`` gates on (the JAX package documents
98% at scale). The whole file runs in about 30 s.
"""

import importlib
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SHARDS = (1, 2, 3, 4, 8)
ATOL = 1e-6


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


_JAX_REFS: dict = {}


def jax_ref(key, fn):
    """``fn()`` once a key: a JAX reference that every P of a test reuses
    (the JAX package's sharded results do not depend on P, which its own
    ``tests/test_shard_properties.py`` holds), so that each JAX program
    compiles once."""
    if key not in _JAX_REFS:
        _JAX_REFS[key] = tuple(np.asarray(x) for x in fn())
    return _JAX_REFS[key]


def jmesh(p):
    return _mod(JAX, "parallel.mesh").corpus_mesh(n_corpus=p)


def tmesh(p):
    return _mod(TORCH, "parallel.mesh").corpus_mesh(n_corpus=p, devices=[CPU] * p)


def dyadic(rng, shape):
    return (rng.integers(-4, 5, size=shape) / 4).astype(np.float32)


def dense_data(seed, n=101):
    """[n, 16] dyadic rows with duplicates (n = 101 leaves pad rows at P =
    2, 3, 4 and 8, and fewer rows a shard at P = 8 than k = 40); 5 queries,
    the first of which scores every row negative."""
    rng = np.random.default_rng(seed)
    c = dyadic(rng, (n, 16))
    for i, src in enumerate(rng.integers(0, n, size=max(2, n // 6))):
        c[(src + i + 1) % n] = c[src]
    c[:, 0] = -np.abs(c[:, 0]) - 0.25
    q = dyadic(rng, (5, 16))
    q[0] = 0.0
    q[0, 0] = 1.0
    return c, q


def assert_ordered(scores, ids):
    """Each row in ``(-score, id)`` order (sentinel pads last)."""
    s = np.asarray(scores, np.float64)
    i = np.asarray(ids, np.int64)
    for row_s, row_i in zip(s, i):
        keys = list(zip(-row_s, row_i))
        assert keys == sorted(keys)


def assert_same(t_out, j_out, atol=ATOL):
    ts, ti = (np.asarray(x) for x in t_out)
    js, ji = (np.asarray(x) for x in j_out)
    assert ti.tolist() == ji.tolist()
    np.testing.assert_allclose(ts, js, atol=atol, rtol=0)
    assert_ordered(ts, ti)


# ------------------------------------------------------------------ engines
# Each engine draws one data set for every P and runs the JAX engine once, at
# P = 4 (jax_ref), except IVF, whose sub-indexes depend on P.
def _dense(p):
    js, ts = _mod(JAX, "parallel.sharded"), _mod(TORCH, "parallel.sharded")
    c, q = dense_data(0)
    n = c.shape[0]
    tc = ts.shard_corpus(c, tmesh(p))
    for k in (3, 40):
        assert_same(ts.sharded_dense_topk(torch.from_numpy(q), tc, k, n, tmesh(p)),
                    jax_ref(("dense", k), lambda: js.sharded_dense_topk(
                        jnp.asarray(q), js.shard_corpus(jnp.asarray(c), jmesh(4)), k, n, jmesh(4))))


def _dense_int8(p):
    js, ts = _mod(JAX, "parallel.sharded"), _mod(TORCH, "parallel.sharded")
    c, q = dense_data(1)
    n = c.shape[0]
    tm = tmesh(p)
    jq, jsc = _mod(JAX, "ops.dense").quantize_int8(jnp.asarray(c))
    tq, tsc = _mod(TORCH, "ops.dense").quantize_int8(c)
    np.testing.assert_array_equal(np.asarray(jq), tq)
    tc = ts.shard_corpus_int8(torch.from_numpy(tq), torch.from_numpy(tsc), tm)
    for k in (3, 40):
        t_out = ts.sharded_dense_topk_int8(torch.from_numpy(q), *tc, k, n, tm)
        j_out = jax_ref(("dense_int8", k), lambda: js.sharded_dense_topk_int8(
            jnp.asarray(q), *js.shard_corpus_int8(jq, jsc, jmesh(4)), k, n, jmesh(4)))
        assert np.asarray(t_out[1]).tolist() == np.asarray(j_out[1]).tolist()
        np.testing.assert_allclose(np.asarray(t_out[0]), np.asarray(j_out[0]), rtol=1e-6)
        assert_ordered(*t_out)


def _dense_verified(p):
    js, ts = _mod(JAX, "parallel.sharded"), _mod(TORCH, "parallel.sharded")
    c, q = dense_data(2)
    n = c.shape[0]
    tm = tmesh(p)
    j_side = _mod(JAX, "ops.dense").build_verified_sidecar(c, rep="bf16")
    t_side = _mod(TORCH, "ops.dense").build_verified_sidecar(c, rep="bf16")
    assert (t_side["nd_max"], t_side["r_max"]) == (j_side["nd_max"], j_side["r_max"])
    tc, tlo = ts.shard_corpus_verified(c, t_side, tm)
    for k in (3, 40):
        t_out = ts.sharded_dense_topk_verified(torch.from_numpy(q), tc, tlo, t_side["nd_max"],
                                               t_side["r_max"], k, n, tm, return_stats=True)
        assert_same(t_out[:2], jax_ref(("dense_verified", k), lambda: js.sharded_dense_topk_verified(
            jnp.asarray(q), *js.shard_corpus_verified(jnp.asarray(c), j_side, jmesh(4)),
            j_side["nd_max"], j_side["r_max"], k, n, jmesh(4))))
        # equal to the sharded exact engine
        assert_same(t_out[:2], ts.sharded_dense_topk(torch.from_numpy(q), ts.shard_corpus(c, tm),
                                                     k, n, tm))


def _bm25_data(seed, n=101):
    rng = np.random.default_rng(100 + seed)
    vocab = [f"term{i}" for i in range(30)]
    docs = [" ".join(rng.choice(vocab, size=rng.integers(3, 12))) for _ in range(n)]
    for i in range(n // 5):
        docs[(i * 7 + 3) % n] = docs[i]
    return docs, [" ".join(rng.choice(vocab, size=3)) for _ in range(4)]


def _bm25(p):
    js, ts = _mod(JAX, "parallel.sharded"), _mod(TORCH, "parallel.sharded")
    docs, queries = _bm25_data(0)
    n = len(docs)
    jidx = _mod(JAX, "index.sparse").SparseIndex(list(range(n)), docs).to_device(jmesh(4))
    q_ids, q_w = jidx.encode_queries(queries)
    tm = tmesh(p)
    pad = _mod(TORCH, "ops.sparse").DOC_PAD
    t_ids = ts.place_rows(jidx._slot_ids, tm, pad_value=pad)
    t_w = ts.place_rows(jidx._slot_weights, tm)
    for k in (3, 40):
        t_out = ts.sharded_bm25_topk(torch.from_numpy(q_ids), torch.from_numpy(q_w), t_ids, t_w,
                                     k, n, tm)
        j_out = jax_ref(("bm25", k), lambda: js.sharded_bm25_topk(
            jnp.asarray(q_ids), jnp.asarray(q_w), *jidx._device, k, n, jidx._mesh))
        assert np.asarray(t_out[1]).tolist() == np.asarray(j_out[1]).tolist()
        np.testing.assert_allclose(np.asarray(t_out[0]), np.asarray(j_out[0]), rtol=1e-6)
        assert_ordered(*t_out)


def _ivf(p):
    """The engine on hand-made sub-indexes (random cells, members and
    centroids; empty tail shards all padding), the same arrays for both."""
    js, ts = _mod(JAX, "parallel.sharded"), _mod(TORCH, "parallel.sharded")
    rng = np.random.default_rng(300 + p)
    n, d, n_cells = int(rng.integers(17, 204)), 16, 4
    ns = -(-n // p)
    corpus = np.zeros((p, ns + 1, d), np.float32)
    members = np.full((p, n_cells, 2 * (-(-ns // n_cells)) + 1), ns, np.int32)
    for s in range(p):
        rows = max(0, min(n, (s + 1) * ns) - s * ns)
        corpus[s, :rows] = dyadic(rng, (rows, d))
        cells = rng.integers(0, n_cells, size=rows)
        for c in range(n_cells):
            m = np.nonzero(cells == c)[0]
            members[s, c, : m.size] = m
    corpus[0, 1] = corpus[min(1, p - 1), 0]  # a tie across shards
    centroids = dyadic(rng, (p, n_cells, d))
    q = dyadic(rng, (4, d))
    for k, nprobe in ((3, 2), (40, 4)):
        j_out = js.sharded_ivf_topk(jnp.asarray(q), jnp.asarray(corpus), jnp.asarray(centroids),
                                    jnp.asarray(members), k=k, nprobe=nprobe,
                                    cell_pad=members.shape[2], shard_rows=ns, n_total=n,
                                    mesh=jmesh(p))
        tm = tmesh(p)
        t_out = ts.sharded_ivf_topk(torch.from_numpy(q), ts.place_rows(corpus, tm),
                                    ts.place_rows(centroids, tm), ts.place_rows(members, tm),
                                    k, nprobe, ns, n, tm)
        assert_same(t_out, j_out)


def maxsim_data(seed, n=83):
    rng = np.random.default_rng(200 + seed)
    td, d = 6, 16
    docs = dyadic(rng, (n, td, d))
    lens = rng.integers(1, td + 1, size=n).astype(np.int32)
    for i in range(max(2, n // 6)):
        j = (i * 5 + 2) % n
        docs[j], lens[j] = docs[i], lens[i]
    docs[np.arange(td)[None, :] >= lens[:, None]] = 0.0
    q = dyadic(rng, (4, 5, d))
    q_lens = np.array([5, 3, 1, 4], np.int32)
    q[np.arange(5)[None, :] >= q_lens[:, None]] = 0.0
    return docs, lens, q, q_lens


def _pad_to(x, p):
    pad = (-x.shape[0]) % p
    return np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)]) if pad else x


def _maxsim(p):
    js, ts = _mod(JAX, "parallel.sharded"), _mod(TORCH, "parallel.sharded")
    docs, lens, q, ql = maxsim_data(1)
    n = docs.shape[0]
    tm = tmesh(p)
    for k in (3, 40):
        t_out = ts.sharded_maxsim_topk(torch.from_numpy(q), torch.from_numpy(ql),
                                       ts.place_rows(docs, tm), ts.place_rows(lens, tm), k, n, tm)
        j_out = jax_ref(("maxsim", k), lambda: js.sharded_maxsim_topk(
            jnp.asarray(q), jnp.asarray(ql), jnp.asarray(_pad_to(docs, 4)),
            jnp.asarray(_pad_to(lens, 4)), k, n, jmesh(4)))
        assert_same(t_out, j_out)


def _maxsim_int8(p):
    js, ts = _mod(JAX, "parallel.sharded"), _mod(TORCH, "parallel.sharded")
    docs, lens, q, ql = maxsim_data(0)
    n = docs.shape[0]
    dq, sc = _mod(TORCH, "ops.maxsim").quantize_int8_tokens(docs)
    jdq, jsc = _mod(JAX, "ops.maxsim").quantize_int8_tokens(jnp.asarray(docs))
    np.testing.assert_array_equal(dq, np.asarray(jdq))
    tm = tmesh(p)
    for k in (3, 40):
        t_out = ts.sharded_maxsim_topk_int8(
            torch.from_numpy(q), torch.from_numpy(ql), ts.place_rows(dq, tm), ts.place_rows(sc, tm),
            ts.place_rows(lens, tm), k, n, tm)
        j_out = jax_ref(("maxsim_int8", k), lambda: js.sharded_maxsim_topk_int8(
            jnp.asarray(q), jnp.asarray(ql), jnp.asarray(_pad_to(dq, 4)),
            jnp.asarray(_pad_to(np.asarray(jsc), 4)), jnp.asarray(_pad_to(lens, 4)), k, n, jmesh(4)))
        assert np.asarray(t_out[1]).tolist() == np.asarray(j_out[1]).tolist()
        np.testing.assert_allclose(np.asarray(t_out[0]), np.asarray(j_out[0]), rtol=1e-6)
        assert_ordered(*t_out)


def _maxsim_verified(p):
    js, ts = _mod(JAX, "parallel.sharded"), _mod(TORCH, "parallel.sharded")
    docs, lens, q, ql = maxsim_data(0)
    n = docs.shape[0]
    side = _mod(TORCH, "ops.maxsim").build_maxsim_sidecar(docs, lens)
    j_side = _mod(JAX, "ops.maxsim").build_maxsim_sidecar(jnp.asarray(docs), jnp.asarray(lens))
    assert (side["nd_max"], side["r_max"]) == (float(j_side["nd_max"]), float(j_side["r_max"]))
    tm = tmesh(p)
    t_docs, t_lens = ts.place_rows(docs, tm), ts.place_rows(lens, tm)
    for k in (3, 40):
        t_out = ts.sharded_maxsim_topk_verified(
            torch.from_numpy(q), torch.from_numpy(ql), t_docs, t_lens,
            ts.place_rows(side["docs_lo"], tm), side["nd_max"], side["r_max"], k, n, tm,
            return_stats=True)
        j_out = jax_ref(("maxsim_verified", k), lambda: js.sharded_maxsim_topk_verified(
            jnp.asarray(q), jnp.asarray(ql), jnp.asarray(_pad_to(docs, 4)),
            jnp.asarray(_pad_to(lens, 4)), jnp.asarray(_pad_to(np.asarray(j_side["docs_lo"]), 4)),
            j_side["nd_max"], j_side["r_max"], k, n, jmesh(4)))
        assert_same(t_out[:2], j_out)
        assert_same(t_out[:2], ts.sharded_maxsim_topk(torch.from_numpy(q), torch.from_numpy(ql),
                                                      t_docs, t_lens, k, n, tm))


ENGINES = {
    "dense": _dense, "dense_int8": _dense_int8, "dense_verified": _dense_verified,
    "bm25": _bm25, "ivf": _ivf, "maxsim": _maxsim, "maxsim_int8": _maxsim_int8,
    "maxsim_verified": _maxsim_verified,
}


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_matches_jax(engine, p):
    ENGINES[engine](p)


# ----------------------------------------------------------- index wrappers
def _hits(rows):
    return [[(h.doc_id, h.score) for h in row] for row in rows]


def assert_hits(got, want, rtol=0.0, atol=1e-5):
    assert [[h[0] for h in r] for r in got] == [[h[0] for h in r] for r in want]
    np.testing.assert_allclose([h[1] for r in got for h in r], [h[1] for r in want for h in r],
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode", ["exact", "verified", "int8", "approx"])
def test_dense_index_to_device_mesh(mode):
    """``DenseIndex.to_device(mesh)`` in every mode at every P against the
    JAX index over a 4-device mesh; int8 also against f32 exact."""
    rng = np.random.default_rng(5)
    n = 203
    emb = rng.normal(size=(n, 24)).astype(np.float32)
    for i in range(n // 6):
        emb[(i * 7 + 1) % n] = emb[i]
    q = rng.normal(size=(6, 24)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    TI, JI = _mod(TORCH, "index.dense").DenseIndex, _mod(JAX, "index.dense").DenseIndex
    exact = _hits(TI(ids, emb, device="cpu").search(q, 10))
    want = _hits(JI(ids, emb, mode=mode).to_device(jmesh(4)).search(q, 10))
    for p in SHARDS:
        t = TI(ids, emb, mode=mode, device="cpu").to_device(tmesh(p))
        got = _hits(t.search(q, 10))
        assert_hits(got, want)
        assert t._sharded == (p > 1) and t.device_bytes() > 0
        if mode == "int8":
            agree = np.mean([len({h[0] for h in a} & {h[0] for h in b}) / 10
                             for a, b in zip(got, exact)])
            assert agree >= 0.9
        else:
            assert_hits(got, exact)
        if mode == "verified":
            assert t.last_stats[1] is True


def test_dense_index_verified_memory_counted_by_device(monkeypatch):
    """Verified mode refuses a mesh whose shards on one device exceed that
    device's memory: four shards on one device need four shards' bytes."""
    dense = _mod(TORCH, "index.dense")
    emb = np.ones((5000, 8), np.float32)
    one_shard = 2048 * 8 * 6  # rows of a shard (a multiple of 2048) x 6 bytes a dim
    monkeypatch.setattr(dense, "_device_memory_bytes", lambda dev: int(one_shard * 2 / 0.85))
    with pytest.raises(dense.IndexNotBuiltError, match="4 of 4 shard"):
        dense.DenseIndex(list(range(5000)), emb, mode="verified", device="cpu").to_device(tmesh(4))
    mesh = _mod(TORCH, "parallel.mesh").corpus_mesh(devices=[CPU, "cpu:1", "cpu:2", "cpu:3"])
    assert mesh.shards_per_device() == 1


@pytest.mark.parametrize("method", ["auto", "xla", "pallas_wand"])
def test_sparse_index_to_device_mesh(method):
    """``SparseIndex.to_device(mesh)`` keeps the flat layout at every P; the
    pruned pins fall back to ``auto``, as in the JAX package."""
    docs, queries = _bm25_data(7)
    ids = list(range(len(docs)))
    TI, JI = _mod(TORCH, "index.sparse").SparseIndex, _mod(JAX, "index.sparse").SparseIndex
    want = _hits(JI(ids, docs).search(queries, 40, method="xla"))
    for p in SHARDS:
        t = TI(ids, docs, device="cpu").to_device(tmesh(p))
        assert t._layout() == "flat" and t.device_bytes() > 0
        assert_hits(_hits(t.search(queries, 40, method=method)), want, rtol=1e-6, atol=0)
    j = JI(ids, docs).to_device(jmesh(4))
    assert_hits(_hits(j.search(queries, 40, method=method)), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", ["exact", "verified", "int8"])
def test_multi_vector_index_to_device_mesh(mode, caplog):
    """``MultiVectorIndex.to_device(mesh)`` in every mode at every P,
    bucketize > 1 included (a mesh keeps the flat layout), against the JAX
    index over a 4-device mesh; ``prefilter`` warns and runs the exact
    scan."""
    rng = np.random.default_rng(11)
    n = 57
    mats = [rng.normal(size=(int(rng.integers(2, 9)), 16)).astype(np.float32) for _ in range(n)]
    for i in range(n // 6):
        mats[(i * 5 + 2) % n] = mats[i]
    queries = [rng.normal(size=(int(rng.integers(2, 5)), 16)).astype(np.float32) for _ in range(4)]
    ids = [f"m{i}" for i in range(n)]
    TI = _mod(TORCH, "index.multi_vector").MultiVectorIndex
    JI = _mod(JAX, "index.multi_vector").MultiVectorIndex
    want = _hits(JI(ids, mats, mode=mode, bucketize=2).to_device(jmesh(4)).search(queries, 20))
    for p in SHARDS:
        t = TI(ids, mats, mode=mode, bucketize=2, device="cpu").to_device(tmesh(p))
        assert t._device_buckets is None and t.device_bytes() > 0
        assert_hits(_hits(t.search(queries, 20)), want)
    if mode == "exact":
        t = TI(ids, mats, device="cpu").to_device(tmesh(3))
        with caplog.at_level("WARNING"):
            got = _hits(t.search(queries, 10, prefilter=2))
        assert "prefilter=2 is ignored" in caplog.text
        assert_hits(got, _hits(TI(ids, mats, device="cpu").search(queries, 10)))


def test_ivf_index_to_device_mesh():
    """``IVFIndex.to_device(mesh)``: P sub-indexes, each of its own k-means
    from seed p, over well-separated clusters (so that both packages' k-means
    agree) against the JAX index over its mesh; recall against exact."""
    rng = np.random.default_rng(13)
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 4
    emb = (centers[rng.integers(0, 8, size=181)] + rng.normal(size=(181, 16)) * 0.05).astype(np.float32)
    q = (centers[rng.integers(0, 8, size=6)] + rng.normal(size=(6, 16)) * 0.05).astype(np.float32)
    ids = list(range(181))
    TI, JI = _mod(TORCH, "index.ivf").IVFIndex, _mod(JAX, "index.ivf").IVFIndex
    exact = _hits(_mod(TORCH, "index.dense").DenseIndex(ids, emb, device="cpu").search(q, 10))
    for p in SHARDS:
        t = TI(ids, emb, n_cells=8, nprobe=4, device="cpu").to_device(tmesh(p))
        j = JI(ids, emb, n_cells=8, nprobe=4).to_device(jmesh(p))
        got = _hits(t.search(q, 10))
        assert_hits(got, _hits(j.search(q, 10)))
        assert t.device_bytes() > 0
        recall = np.mean([len({h[0] for h in a} & {h[0] for h in b}) / 10 for a, b in zip(got, exact)])
        assert recall >= 0.9


def test_non_mesh_refused():
    for cls, args in (("dense.DenseIndex", ([0], np.ones((1, 4), np.float32))),
                      ("sparse.SparseIndex", ([0], ["a"])),
                      ("multi_vector.MultiVectorIndex", ([0], [np.ones((2, 4), np.float32)])),
                      ("ivf.IVFIndex", ([0], np.ones((1, 4), np.float32)))):
        mod, name = cls.split(".")
        idx = getattr(_mod(TORCH, f"index.{mod}"), name)(*args, device="cpu")
        with pytest.raises(TypeError, match="DeviceMesh"):
            idx.to_device(mesh=object())


def test_mesh_helpers():
    mesh_mod = _mod(TORCH, "parallel.mesh")
    m = mesh_mod.corpus_mesh(n_corpus=2, n_dp=2, devices=[CPU] * 4)
    assert m.shape == {"dp": 2, "corpus": 2} and m.axis_names == ("dp", "corpus")
    assert mesh_mod.hybrid_corpus_mesh(devices=[CPU] * 3).shape == {"dp": 1, "corpus": 3}
    assert mesh_mod.device_corpus_mesh("cpu").size == 1
    with pytest.raises(ValueError, match="needs 6 devices"):
        mesh_mod.corpus_mesh(n_corpus=3, n_dp=2, devices=[CPU] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.corpus_mesh()
    mesh_mod.set_default_mesh(m)
    try:
        assert mesh_mod.get_default_mesh() is m
    finally:
        mesh_mod.set_default_mesh(None)
    assert set(_mod(TORCH, "parallel").__all__) == set(_mod(JAX, "parallel").__all__)


def test_distinct_devices_search_in_threads():
    """Shards on distinct devices run in one thread a device (distinct
    ``cpu:i`` here) and give the one-device results."""
    import threading

    ts = _mod(TORCH, "parallel.sharded")
    mesh = _mod(TORCH, "parallel.mesh").corpus_mesh(devices=[f"cpu:{i}" for i in range(4)])
    barrier = threading.Barrier(4, timeout=10)  # passes only if all four run at once
    seen = ts._run_shards(mesh, lambda p, dev: (barrier.wait(), dev))
    assert {p: dev for p, (_, dev) in seen.items()} == dict(enumerate(mesh.corpus_devices()))
    c, q = dense_data(3)
    want = ts.sharded_dense_topk(torch.from_numpy(q), ts.shard_corpus(c, tmesh(4)), 40, 101, tmesh(4))
    assert_same(ts.sharded_dense_topk(torch.from_numpy(q), ts.shard_corpus(c, mesh), 40, 101, mesh),
                want, atol=0)


def test_initialize_distributed_single_host(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert _mod(TORCH, "parallel.distributed").initialize_distributed() is False
    assert _mod(JAX, "parallel.distributed").initialize_distributed() is False


# ------------------------------------------------------------- two processes
_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    sys.path.insert(0, {repo!r})
    from autorag_research_tpu_torch.index.dense import DenseIndex
    from autorag_research_tpu_torch.index.sparse import SparseIndex
    from autorag_research_tpu_torch.parallel.distributed import global_corpus_mesh, initialize_distributed
    rank = int(sys.argv[1])
    assert initialize_distributed("tcp://127.0.0.1:{port}", 2, rank, backend="gloo") is True
    mesh = global_corpus_mesh(local_devices=[torch.device("cpu")] * 2)
    data = np.load({data!r})
    out = {{}}
    for mode in ("exact", "verified"):
        idx = DenseIndex(list(range(len(data["emb"]))), data["emb"], mode=mode, device="cpu")
        s, r = idx.to_device(mesh).topk_rows(data["q"], 12)
        out[mode] = [r.tolist(), s.tolist()]
    docs = [str(t) for t in data["docs"]]
    s, r = SparseIndex(list(range(len(docs))), docs, device="cpu").to_device(mesh).topk_rows(
        [str(t) for t in data["queries"]], 12)
    out["bm25"] = [r.tolist(), s.tolist()]
    out["ranks"] = mesh.ranks
    print(json.dumps(out))
""")


def test_two_processes_match_four_shards(tmp_path):
    """Two gloo processes on the CPU, two shards each of one 4-shard mesh,
    give the single-process 4-shard results (dense exact and verified,
    BM25). Each process has 60 s."""
    rng = np.random.default_rng(17)
    emb = rng.normal(size=(150, 16)).astype(np.float32)
    emb[7] = emb[120]
    q = rng.normal(size=(5, 16)).astype(np.float32)
    docs, queries = _bm25_data(3)
    np.savez(tmp_path / "data.npz", emb=emb, q=q, docs=np.array(docs), queries=np.array(queries))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=str(REPO), port=port, data=str(tmp_path / "data.npz")))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in (0, 1)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=60)
            assert proc.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    assert outs[0] == outs[1] and outs[0]["ranks"] == [[0, 0, 1, 1]]
    m4 = tmesh(4)
    TD, TS = _mod(TORCH, "index.dense").DenseIndex, _mod(TORCH, "index.sparse").SparseIndex
    for mode in ("exact", "verified"):
        s, r = TD(list(range(150)), emb, mode=mode, device="cpu").to_device(m4).topk_rows(q, 12)
        assert outs[0][mode] == [r.tolist(), s.tolist()]
    s, r = TS(list(range(len(docs))), docs, device="cpu").to_device(m4).topk_rows(queries, 12)
    assert outs[0]["bm25"] == [r.tolist(), s.tolist()]


# ------------------------------------------------------ Executor, CLI, serve
def _catalog(path):
    """A small catalog of both packages' schema: dense and multi-vector
    chunk embeddings, texts, GT."""
    from autorag_research_tpu.store.catalog import Catalog
    from autorag_research_tpu.store.gt import or_all

    rng = np.random.default_rng(19)
    n = 97
    vocab = [f"w{i}" for i in range(40)]
    texts = [" ".join(rng.choice(vocab, size=rng.integers(4, 12))) for _ in range(n)]
    emb = rng.normal(size=(n, 16)).astype(np.float32)
    emb[5] = emb[60]
    cat = Catalog(path, embedding_dim=16)
    cat.add_chunks({"id": i, "contents": t, "embedding": e} for i, (t, e) in enumerate(zip(texts, emb)))
    cat.set_multi_embeddings("chunk", [
        (i, rng.normal(size=(int(rng.integers(2, 6)), 16)).astype(np.float32)) for i in range(n)])
    gold = rng.integers(0, n, size=12)
    cat.add_queries({"id": j, "contents": " ".join(texts[g].split()[:3]),
                     "embedding": emb[g] + rng.normal(size=16).astype(np.float32) * 0.1}
                    for j, g in enumerate(gold))
    cat.set_multi_embeddings("query", [
        (j, rng.normal(size=(3, 16)).astype(np.float32)) for j in range(len(gold))])
    for j, g in enumerate(gold):
        cat.add_retrieval_gt(j, or_all([int(g)]))
    cat.close()


def _run_executor(pkg, db, mesh):
    config = _mod(pkg, "config")
    r = _mod(pkg, "pipelines.retrieval")
    registry = _mod(pkg, "index.registry")
    cat = _mod(pkg, "store.catalog").Catalog(db)
    cfg = config.ExecutorConfig(
        pipelines=[
            r.VectorSearchConfig(name="dense_verified", index_options={"mode": "verified"}),
            r.VectorSearchConfig(name="maxsim", search_mode="multi"),
            r.BM25Config(name="bm25"),
        ],
        metrics=[config.BaseMetricConfig(name="recall")],
    )
    ctx = config.BuildContext(device="cpu", mesh=mesh) if pkg == TORCH else config.BuildContext(mesh=mesh)
    try:
        result = _mod(pkg, "executor").Executor(cat, cfg, ctx).run()
        assert result.success, result.report()
        return {
            p.name: [(q, x["doc_id"], x["rel_score"]) for q in cat.get_all_query_ids()
                     for x in cat.get_retrieved(q, p.stats["pipeline_id"])]
            for p in result.pipelines
        }
    finally:
        registry.invalidate(cat)
        cat.close()


def _assert_rows(got, want):
    assert got.keys() == want.keys()
    for name in want:
        assert [x[:2] for x in got[name]] == [x[:2] for x in want[name]], name
        np.testing.assert_allclose([x[2] for x in got[name]], [x[2] for x in want[name]],
                                   rtol=1e-5, atol=1e-6)


def test_executor_with_mesh_matches_jax(tmp_path):
    """``BuildContext(mesh=)`` through both Executors at 4 shards, on copies
    of one catalog: the persisted rows are equal."""
    _catalog(tmp_path / "src.db")
    rows = {}
    for name, pkg, mesh in (("jax", JAX, jmesh(4)), ("torch", TORCH, tmesh(4))):
        (tmp_path / name).mkdir()
        shutil.copy(tmp_path / "src.db", tmp_path / name / "ws.db")
        rows[name] = _run_executor(pkg, tmp_path / name / "ws.db", mesh)
    _assert_rows(rows["torch"], rows["jax"])
    assert all(len(r) == 12 * 10 for r in rows["torch"].values())


def _rows(db):
    import sqlite3

    with sqlite3.connect(db) as con:
        return con.execute(
            "SELECT p.name, r.query_id, r.chunk_id, r.rel_score FROM chunk_retrieved_result r "
            "JOIN pipeline p ON p.id = r.pipeline_id ORDER BY p.name, r.query_id, r.rel_score DESC, "
            "r.chunk_id").fetchall()


def test_cli_run_and_serve_with_mesh(tmp_path, monkeypatch):
    """``run --mesh --device cpu`` persists the rows of ``run --device cpu``
    (dense exact and verified, BM25, RRF), and ``serve_workspace(mesh=True,
    device="cpu")`` answers as without it (``--mesh`` on the CPU is a
    one-device mesh: dense runs unsharded, BM25 through the engine at P =
    1)."""
    import yaml

    cli = _mod(TORCH, "cli.app")
    server = _mod(TORCH, "serving.server")
    registry = _mod(TORCH, "index.registry")
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--device", "cpu", "init"]) == 0
    (tmp_path / "configs" / "experiment.yaml").write_text(yaml.safe_dump({
        "pipelines": {"retrieval": ["vector_search", "vector_search_verified", "bm25", "hybrid_rrf"],
                      "generation": []},
        "metrics": {"retrieval": ["recall"], "generation": []},
        "executor": {"health_check": True, "health_check_queries": 2},
    }))
    dense_yaml = tmp_path / "configs" / "pipelines" / "retrieval" / "vector_search_verified.yaml"
    spec = yaml.safe_load(dense_yaml.read_text())
    dense_yaml.write_text(yaml.safe_dump({**spec, "embedding_model": "mock"}))
    for ws in ("ws", "ws_mesh"):
        assert cli.main(["--device", "cpu", "ingest", "--name", "synthetic", "--db", ws, "--extra",
                         "n_docs=200", "--extra", "n_queries=12", "--embedding-model", "mock"]) == 0
    assert cli.main(["--device", "cpu", "run", "--db", "ws"]) == 0
    registry.invalidate()
    assert cli.main(["--device", "cpu", "run", "--db", "ws_mesh", "--mesh"]) == 0
    registry.invalidate()
    a, b = _rows(tmp_path / "ws" / "catalog.db"), _rows(tmp_path / "ws_mesh" / "catalog.db")
    assert len(a) == 4 * 12 * 10 and [x[:3] for x in a] == [x[:3] for x in b]
    np.testing.assert_allclose([x[3] for x in a], [x[3] for x in b], rtol=1e-6)

    answers = []
    for mesh in (False, True):
        handle = server.serve_workspace("ws", retrieval=["vector_search_verified", "bm25"], port=0,
                                        mesh=mesh, device="cpu")
        try:
            answers.append([handle.search(["topic words", "w1 w7"], top_k=5, pipeline=name)
                            for name in ("vector_search_verified", "bm25")])
            idx = handle.retrieval_pipelines["vector_search_verified"]._index()
            assert (idx._mesh is not None) == mesh
        finally:
            handle.stop()
            registry.invalidate()
    assert answers[0] == answers[1]
