"""Port ``index/ivf_contiguous.py`` against the JAX package's.

- Search on block state the JAX package built, carried across by its
  ``save`` and the port's ``load``: ids equal (but swaps of near-ties within
  1e-6) and scores within 1e-6 relative of the JAX
  ``IVFContiguousIndex.search`` at several ``nprobe_blocks``, in
  both placements; a port ``save`` loads in the JAX package (its ``device``
  mode kept) and searches the same.
- From the same seed the port packs the JAX package's blocks, row ids and
  keys bitwise (on these well-separated clusters the assignments agree);
  every row lands in exactly one block; recall is monotone in
  ``nprobe_blocks`` and a full probe equals the exact ``DenseIndex`` (ids
  equal, scores within 1e-6 relative); two builds with one seed are bitwise
  equal.
- ``placement="host"`` (the JAX ``device="host"``) gives the device
  placement's ids and scores on CPU tensors; the pipeline takes
  ``index_type="ivf_contiguous"`` with the JAX package's options.

Everything runs on the CPU (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from autorag_research_tpu.index.ivf_contiguous import IVFContiguousIndex as JCC
from autorag_research_tpu_torch.index import registry
from autorag_research_tpu_torch.index.dense import DenseIndex
from autorag_research_tpu_torch.index.ivf_contiguous import IVFContiguousIndex, placement_of

RTOL = 1e-6
CPU = "cpu"


@pytest.fixture(scope="module")
def clustered():
    """``tests/test_ivf_contiguous.py``'s corpus: 2,000 rows around 16
    centres, d = 64, 12 queries."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(16, 64)).astype(np.float32)
    assign = rng.integers(0, 16, size=2000)
    emb = centers[assign] + 0.15 * rng.normal(size=(2000, 64)).astype(np.float32)
    q = centers[rng.integers(0, 16, size=12)] + 0.15 * rng.normal(size=(12, 64)).astype(np.float32)
    return list(range(2000)), emb, q


def _ids(hits):
    return [[h.doc_id for h in row] for row in hits]


def _assert_same(got, want):
    """Ids equal and scores within RTOL; two ids may swap only where their
    scores are within RTOL of each other (a near-tie: the packages' f32 dot
    products sum in different orders)."""
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        gs, ws = np.array([h.score for h in g]), np.array([h.score for h in w])
        np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=0)
        for r, (a, b) in enumerate(zip(g, w)):
            if a.doc_id != b.doc_id:
                assert any(abs(ws[r] - ws[x]) <= RTOL * abs(ws[r]) for x in (r - 1, r + 1) if 0 <= x < len(w))


def _recall(approx_hits, exact_hits):
    return float(np.mean([
        len({h.doc_id for h in a} & {h.doc_id for h in e}) / max(len(e), 1)
        for a, e in zip(approx_hits, exact_hits)
    ]))


@pytest.fixture(scope="module")
def jax_index(clustered, tmp_path_factory):
    ids, emb, _ = clustered
    j = JCC(ids, emb, n_cells=32, block_rows=64, seed=1)
    path = tmp_path_factory.mktemp("jcc")
    j.save(path)
    return j, path


@pytest.mark.parametrize("placement", ["device", "host"])
@pytest.mark.parametrize("nprobe_blocks", [1, None, 8, 10_000])
def test_search_on_jax_state_matches_jax(jax_index, clustered, nprobe_blocks, placement):
    j, path = jax_index
    _, _, q = clustered
    t = IVFContiguousIndex.load(path, device=CPU)
    assert (t.n_blocks, t.nprobe_blocks, t.placement) == (j.n_blocks, j.nprobe_blocks, "device")
    t.placement = placement
    for k in (1, 10, 50):
        _assert_same(t.search(q, k, nprobe_blocks=nprobe_blocks), j.search(q, k, nprobe_blocks=nprobe_blocks))


def test_same_seed_packs_the_jax_blocks(jax_index, clustered):
    j, _ = jax_index
    ids, emb, _ = clustered
    t = IVFContiguousIndex(ids, emb, n_cells=32, block_rows=64, seed=1, device=CPU)
    np.testing.assert_allclose(t.centroids, j.centroids, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t._row_ids, j._row_ids)
    np.testing.assert_array_equal(t._blocks, j._blocks)
    np.testing.assert_array_equal(t._keys, j._keys)
    assert (t.n_blocks, t.nprobe_blocks) == (j.n_blocks, j.nprobe_blocks)


def test_every_row_lands_in_exactly_one_block(clustered):
    ids, emb, _ = clustered
    t = IVFContiguousIndex(ids, emb, n_cells=32, block_rows=64, device=CPU)
    real = t._row_ids[t._row_ids < len(ids)]
    assert len(real) == len(ids) and len(np.unique(real)) == len(ids)
    # pad rows are zero and carry the pad id
    np.testing.assert_array_equal(t._blocks[t._row_ids == len(ids)], 0.0)


def test_recall_monotone_and_full_probe_exact(clustered):
    ids, emb, q = clustered
    exact = DenseIndex(ids, emb, device=CPU).search(q, 10)
    t = IVFContiguousIndex(ids, emb, n_cells=32, block_rows=64, seed=1, device=CPU)
    recalls = [_recall(t.search(q, 10, nprobe_blocks=p), exact) for p in (1, 2, 4, 8, 16)]
    assert recalls == sorted(recalls) and recalls[-1] >= 0.95
    _assert_same(t.search(q, 10, nprobe_blocks=t.n_blocks), exact)


def test_two_builds_with_one_seed_are_bitwise_equal(clustered):
    ids, emb, _ = clustered
    a = IVFContiguousIndex(ids, emb, n_cells=24, block_rows=64, seed=5, device=CPU)
    b = IVFContiguousIndex(ids, emb, n_cells=24, block_rows=64, seed=5, device=CPU)
    for name in ("centroids", "_blocks", "_row_ids", "_keys"):
        assert getattr(a, name).tobytes() == getattr(b, name).tobytes(), name
    assert set(a.build_seconds) == {"normalize", "upload", "kmeans", "assign", "pack"}


@pytest.mark.parametrize("nprobe_blocks", [1, 8, 40])
def test_host_placement_equals_device_placement(clustered, nprobe_blocks):
    ids, emb, q = clustered
    dev = IVFContiguousIndex(ids, emb, n_cells=32, block_rows=64, seed=5, device=CPU)
    host = IVFContiguousIndex(ids, emb, n_cells=32, block_rows=64, seed=5, device=CPU, placement="host")
    assert host.to_device()._device[2] is None and dev.to_device()._device[2] is not None
    assert host.device_bytes() == host.n_blocks * 64 * 4 < dev.device_bytes()
    for k in (3, 10):
        a, b = dev.topk_rows(q, k, nprobe_blocks), host.topk_rows(q, k, nprobe_blocks)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[0], b[0])


def test_jax_device_modes_map_to_placements(clustered):
    ids, emb, _ = clustered
    assert placement_of("tpu") == "device" and placement_of("host") == "host"
    assert placement_of("device") == "device"
    with pytest.raises(ValueError, match="placement"):
        placement_of("gpu0")
    with pytest.raises(ValueError, match="placement"):
        IVFContiguousIndex(ids[:10], emb[:10], device=CPU, placement="tpu0")
    if not torch.cuda.is_available():  # the default is the card, never the CPU in its place
        with pytest.raises((RuntimeError, AssertionError)):
            IVFContiguousIndex(ids[:10], emb[:10])


@pytest.mark.parametrize("placement", ["device", "host"])
def test_save_load_both_ways(clustered, tmp_path, placement):
    ids, emb, q = clustered
    t = IVFContiguousIndex(ids, emb, n_cells=32, block_rows=64, seed=2, device=CPU, placement=placement)
    t.save(tmp_path / "cc")
    j = JCC.load(tmp_path / "cc")
    assert j.device_mode == ("host" if placement == "host" else "tpu")
    np.testing.assert_array_equal(j._blocks, t._blocks)
    _assert_same(t.search(q, 5), j.search(q, 5))
    back = IVFContiguousIndex.load(tmp_path / "cc", device=CPU)
    assert back.placement == placement
    _assert_same(back.search(q, 5), t.search(q, 5))


@pytest.mark.parametrize("options", [
    {"n_cells": 16, "block_rows": 64, "nprobe_blocks": 8},
    {"n_cells": 16, "block_rows": 64, "nprobe_blocks": 8, "device": "host"},
])
def test_pipeline_index_type(tmp_path, clustered, options):
    from autorag_research_tpu.index import registry as jregistry
    from autorag_research_tpu.pipelines.retrieval.vector_search import VectorSearchPipeline as JPipe
    from autorag_research_tpu.store.catalog import Catalog as JCatalog
    from autorag_research_tpu_torch.pipelines.retrieval.vector_search import VectorSearchPipeline
    from autorag_research_tpu_torch.store.catalog import Catalog

    registry.invalidate()
    jregistry.invalidate()
    ids, emb, q = clustered
    rows = [{"id": i, "contents": f"doc {i}", "embedding": e} for i, e in zip(ids[:500], emb[:500])]
    cat, jcat = Catalog(tmp_path / "cc.db"), JCatalog(tmp_path / "jcc.db")
    for c in (cat, jcat):
        c.add_chunks(rows)
        c.add_queries([{"id": 0, "contents": "q", "embedding": q[0]}])
    pipe = VectorSearchPipeline(cat, "vs_cc", index_type="ivf_contiguous", index_options=options, device=CPU)
    res = pipe.run(top_k=5)
    assert res["total_results"] == 5
    idx = pipe._index()
    assert isinstance(idx, IVFContiguousIndex)
    assert idx.placement == ("host" if "device" in options else "device") and idx.device.type == "cpu"
    jpipe = JPipe(jcat, "vs_cc", index_type="ivf_contiguous", index_options=options)
    for qv in q:
        got, want = pipe.search_by_embedding(qv, 5), jpipe.search_by_embedding(qv, 5)
        assert [h["doc_id"] for h in got] == [h["doc_id"] for h in want]
        np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want], rtol=1e-5)
    # the artifact reloads with the same placement
    registry.invalidate()
    assert pipe._index().placement == idx.placement
    registry.invalidate()
    jregistry.invalidate()
    cat.close()
    jcat.close()


def test_query_tensors_and_single_vectors(clustered):
    ids, emb, q = clustered
    t = IVFContiguousIndex(ids, emb, n_cells=16, block_rows=64, device=CPU)
    _assert_same(t.search(torch.from_numpy(q), 7), t.search(q, 7))
    assert t.search(q[0], 3)[0] == t.search(q[:1], 3)[0]
