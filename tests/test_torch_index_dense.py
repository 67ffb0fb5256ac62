"""Port ``DenseIndex`` (+ registry) vs the JAX package's, on CPU tensors."""

import numpy as np
import pytest
import torch

from autorag_research_tpu.index.dense import DenseIndex as JaxDenseIndex
from autorag_research_tpu_torch.exceptions import IndexNotBuiltError
from autorag_research_tpu_torch.index import dense as tdense
from autorag_research_tpu_torch.index import registry
from autorag_research_tpu_torch.index.dense import DenseIndex


def _data(seed=0, n=1500, d=32, nq=20):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb[100] = emb[7]  # exact duplicate -> tie broken by row id
    emb[5] = 0.0  # zero row stays zero under normalization
    qs = rng.normal(size=(nq, d)).astype(np.float32)
    qs[2] = emb[7] * 3.0
    ids = [f"doc-{i}" for i in range(n)]
    return ids, emb, qs


@pytest.mark.parametrize("mode", ["exact", "verified"])
def test_topk_rows_matches_jax(mode):
    ids, emb, qs = _data()
    js, jr = JaxDenseIndex(ids, emb, mode=mode).topk_rows(qs, 10)
    ts, tr = DenseIndex(ids, emb, mode=mode, device="cpu").topk_rows(qs, 10)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-7)
    assert tr[2][0] == 7 and tr[2][1] == 100


def test_search_hits_and_tensor_queries():
    ids, emb, qs = _data(1)
    idx = DenseIndex(ids, emb, mode="verified", device="cpu")
    hits = idx.search(qs, 5)
    jhits = JaxDenseIndex(ids, emb, mode="verified").search(qs, 5)
    assert [[h.doc_id for h in row] for row in hits] == [[h.doc_id for h in row] for row in jhits]
    # a tensor (unnormalized, 1-D) is normalized on the device and chained
    s_np, r_np = idx.topk_rows(qs[3], 5)
    s_t, r_t = idx.topk_rows(torch.from_numpy(qs[3] * 7.0), 5)
    np.testing.assert_array_equal(r_t, r_np)
    np.testing.assert_allclose(s_t, s_np, rtol=1e-6)
    # the search's own proof outcome stays on the index
    assert idx.last_stats == (0, True)


def test_k_beyond_corpus_and_ip_metric():
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(6, 8)).astype(np.float32)
    emb[4] = emb[1]
    qs = rng.normal(size=(3, 8)).astype(np.float32)
    ids = list(range(6))
    for metric in ("cosine", "ip"):
        js, jr = JaxDenseIndex(ids, emb, metric=metric).topk_rows(qs, 9)
        ts, tr = DenseIndex(ids, emb, metric=metric, device="cpu").topk_rows(qs, 9)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-7)


def test_jax_saved_index_loads_in_port(tmp_path):
    ids, emb, qs = _data(3)
    JaxDenseIndex(ids, emb, mode="verified").save(tmp_path / "jax")
    port = DenseIndex.load(tmp_path / "jax", device="cpu")
    assert (port.mode, port.metric, port.ids) == ("verified", "cosine", ids)
    ref = JaxDenseIndex(ids, emb, mode="verified").topk_rows(qs, 10)
    np.testing.assert_array_equal(port.topk_rows(qs, 10)[1], ref[1])
    # and the other way round
    DenseIndex(ids, emb, device="cpu").save(tmp_path / "port")
    back = JaxDenseIndex.load(tmp_path / "port")
    np.testing.assert_array_equal(back.topk_rows(qs, 10)[1], ref[1])


def test_modes_and_capacity_refusal(monkeypatch):
    ids, emb, qs = _data(4, n=300)
    # the serving modes construct and search, with the JAX index's ids
    for mode in ("approx", "int8"):
        got = DenseIndex(ids, emb, mode=mode, device="cpu").topk_rows(qs, 10)
        ref = JaxDenseIndex(ids, emb, mode=mode).topk_rows(qs, 10)
        np.testing.assert_array_equal(got[1], ref[1])
    with pytest.raises(ValueError):
        DenseIndex(ids, emb, mode="fast", device="cpu")
    idx = DenseIndex(ids, emb, mode="verified", device="cpu")
    assert idx.verified_device_bytes() == JaxDenseIndex(ids, emb, mode="verified").verified_device_bytes()
    monkeypatch.setattr(tdense, "_device_memory_bytes", lambda device: 1 << 16)
    with pytest.raises(IndexNotBuiltError):
        idx.to_device()


def test_registry_reloads_artifact_on_device(tmp_path):
    from autorag_research_tpu_torch.store.catalog import Catalog

    cat = Catalog(tmp_path / "ws.db", embedding_dim=16)
    rng = np.random.default_rng(5)
    cat.add_chunks(
        [{"id": i, "contents": f"c{i}", "embedding": rng.normal(size=16)} for i in range(40)]
    )
    built = []

    def builder():
        built.append(1)
        return DenseIndex.from_catalog(cat, device="cpu", mode="verified")

    a = registry.get_or_build(cat, "dense", "chunk", builder=builder, device="cpu", mode="verified")
    registry.invalidate(cat)
    b = registry.get_or_build(cat, "dense", "chunk", builder=builder, device="cpu", mode="verified")
    assert len(built) == 1 and b is not a and b.device == torch.device("cpu")
    assert (tmp_path / "indexes").is_dir()
    np.testing.assert_array_equal(b._host, a._host)
    registry.invalidate(cat)
