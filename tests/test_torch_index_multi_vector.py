"""Port ``MultiVectorIndex`` (+ registry) vs the JAX package's, on CPU tensors.

Hits (doc ids in order, MaxSim / n_query_vectors scores at ``rtol=1e-5``)
agree in the exact, verified, prefilter and bucketed layouts, over a corpus
with empty documents and ragged queries; artifacts cross between the
packages both ways.
"""

import numpy as np
import pytest

from autorag_research_tpu.index.multi_vector import MultiVectorIndex as JaxMultiVectorIndex
from autorag_research_tpu_torch.exceptions import IndexNotBuiltError
from autorag_research_tpu_torch.index import registry
from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex, pad_ragged


def _corpus(seed=0, n=64, d=24, nq=6, empty=(5, 40)):
    rng = np.random.default_rng(seed)
    mats = [rng.normal(size=(int(rng.integers(1, 24)), d)).astype(np.float32) for _ in range(n)]
    for e in empty:
        mats[e] = np.zeros((0, d), np.float32)
    queries = [rng.normal(size=(int(rng.integers(2, 9)), d)).astype(np.float32) for _ in range(nq)]
    queries[1] = mats[7][:3] * 2.0  # a query made of one document's tokens
    return [f"d{i}" for i in range(n)], mats, queries


def _hits(rows):
    return [[h.doc_id for h in r] for r in rows], [[h.score for h in r] for r in rows]


def _assert_same_hits(port_rows, jax_rows):
    p_ids, p_s = _hits(port_rows)
    j_ids, j_s = _hits(jax_rows)
    assert p_ids == j_ids
    for a, b in zip(p_s, j_s):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "opts,search_kw",
    [
        ({}, {}),
        ({"mode": "verified"}, {}),
        ({"mode": "verified"}, {"kprime": 3}),
        ({}, {"prefilter": 2}),
        ({"bucketize": 3}, {}),
        ({"bucketize": 3, "mode": "verified"}, {}),
    ],
    ids=["exact", "verified", "verified-fallback", "prefilter", "bucketed", "bucketed-verified"],
)
@pytest.mark.parametrize("k", [5, 17])
def test_search_matches_jax(opts, search_kw, k):
    ids, mats, queries = _corpus()
    port = MultiVectorIndex(ids, mats, device="cpu", **opts)
    jax_idx = JaxMultiVectorIndex(ids, mats, **opts)
    got = port.search(queries, k, **search_kw)
    _assert_same_hits(got, jax_idx.search(queries, k, **search_kw))
    assert got[1][0].doc_id == "d7"
    assert all("d5" not in [h.doc_id for h in row] for row in got)  # empty docs never surface
    if opts.get("mode") == "verified":
        n_fail, covered = port.last_stats
        assert covered == (n_fail == 0) and (n_fail > 0) == ("kprime" in search_kw)


def test_k_beyond_corpus_and_max_tokens():
    ids, mats, queries = _corpus(1, n=10, empty=(3,))
    for kw in ({}, {"max_tokens": 6}):
        port = MultiVectorIndex(ids, mats, device="cpu", **kw)
        _assert_same_hits(port.search(queries, 30), JaxMultiVectorIndex(ids, mats, **kw).search(queries, 30))
        assert all(len(row) == 9 for row in port.search(queries, 30))
        assert port.max_doc_tokens == JaxMultiVectorIndex(ids, mats, **kw).max_doc_tokens


def test_pad_ragged_and_device_bytes():
    ids, mats, _ = _corpus(2)
    docs, lens = pad_ragged(mats, 12)
    from autorag_research_tpu.index.multi_vector import pad_ragged as jax_pad_ragged

    jd, jl = jax_pad_ragged(mats, 12)
    np.testing.assert_array_equal(docs, jd)
    np.testing.assert_array_equal(lens, jl)
    flat = MultiVectorIndex(ids, mats, device="cpu").to_device()
    bucketed = MultiVectorIndex(ids, mats, device="cpu", bucketize=3).to_device()
    assert 0 < bucketed.device_bytes() < flat.device_bytes()
    verified = MultiVectorIndex(ids, mats, device="cpu", mode="verified").to_device()
    assert verified.device_bytes() == flat.device_bytes() * 3 // 2  # + the bf16 sidecar


def test_modes_and_refusals():
    ids, mats, queries = _corpus(3)
    # int8 constructs and searches, with the JAX index's hits
    got = MultiVectorIndex(ids, mats, mode="int8", device="cpu").search(queries, 5)
    assert _hits(got)[0] == _hits(JaxMultiVectorIndex(ids, mats, mode="int8").search(queries, 5))[0]
    with pytest.raises(ValueError):
        MultiVectorIndex(ids, mats, device="cpu", mode="int8").search(queries, 5, prefilter=2)
    with pytest.raises(ValueError):
        MultiVectorIndex(ids, mats, mode="fast", device="cpu")
    with pytest.raises(NotImplementedError):
        MultiVectorIndex(ids, mats, device="cpu").to_device(mesh=object())
    with pytest.raises(ValueError):
        MultiVectorIndex(ids, mats, device="cpu", mode="verified").search(queries, 5, prefilter=2)
    with pytest.raises(ValueError):
        MultiVectorIndex(ids, mats, device="cpu", bucketize=2).search(queries, 5, prefilter=2)
    with pytest.raises(IndexNotBuiltError):
        MultiVectorIndex([], [], device="cpu").search(queries, 5)
    # the scan pin and the fused-kernel pin (its plain version on the CPU)
    idx = MultiVectorIndex(ids, mats, device="cpu")
    ref = _hits(idx.search(queries, 7))[0]
    assert _hits(idx.search(queries, 7, method="xla"))[0] == ref
    assert _hits(idx.search(queries, 7, method="pallas_v2"))[0] == ref
    # the v1 and v3 pins (their plain versions on the CPU)
    assert _hits(idx.search(queries, 7, method="pallas"))[0] == ref
    assert _hits(idx.search(queries, 7, method="pallas_v3"))[0] == ref


@pytest.mark.parametrize("mode", ["exact", "verified"])
def test_artifacts_cross_packages(tmp_path, mode):
    ids, mats, queries = _corpus(4)
    ref = JaxMultiVectorIndex(ids, mats, mode=mode, bucketize=2).search(queries, 8)
    JaxMultiVectorIndex(ids, mats, mode=mode, bucketize=2, search_method="xla").save(tmp_path / "jax")
    port = MultiVectorIndex.load(tmp_path / "jax", device="cpu")
    assert (port.mode, port.bucketize, port.search_method, port.ids) == (mode, 2, "xla", ids)
    _assert_same_hits(port.search(queries, 8), ref)
    MultiVectorIndex(ids, mats, mode=mode, device="cpu").save(tmp_path / "port")
    back = JaxMultiVectorIndex.load(tmp_path / "port")
    assert back.mode == mode
    _assert_same_hits(back.search(queries, 8), ref)


def test_registry_loads_multi_vector_artifact(tmp_path):
    from autorag_research_tpu_torch.store.catalog import Catalog

    ids, mats, _ = _corpus(5, n=30, empty=())
    cat = Catalog(tmp_path / "ws.db", embedding_dim=24)
    cat.add_chunks([{"id": i, "contents": f"c{i}"} for i in range(30)])
    cat.set_multi_embeddings("chunk", list(enumerate(mats)))
    built = []

    def builder():
        built.append(1)
        return MultiVectorIndex.from_catalog(cat, device="cpu", mode="verified")

    a = registry.get_or_build(cat, "multi_vector", "chunk", builder=builder, device="cpu", mode="verified")
    registry.invalidate(cat)
    b = registry.get_or_build(cat, "multi_vector", "chunk", builder=builder, device="cpu", mode="verified")
    assert len(built) == 1 and b is not a and isinstance(b, MultiVectorIndex)
    assert (b.mode, str(b.device)) == ("verified", "cpu")
    np.testing.assert_array_equal(b._docs, a._docs)
    registry.invalidate(cat)
    cat.close()
