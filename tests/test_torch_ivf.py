"""Port ``index/ivf.py`` against the JAX package's, and IVF through the
port's entry points (``VectorSearchConfig``, ``Executor``, the CLI's ``run``
with the ``vector_search_ivf.yaml`` template, ``serve_workspace``).

- ``_kmeans`` from the same initial rows: centroids within 1e-5 absolute,
  assignments equal on well-separated clusters; ``train_centroids`` draws the
  same sample and initial rows.
- Search on index state the JAX package built, carried across by its
  ``save`` and the port's ``load`` (so k-means near-ties do not matter):
  ids equal (but swaps of near-ties within 1e-6) and scores within 1e-6
  relative of the JAX ``IVFIndex.search``
  at nprobe 1, the default and every cell; a port ``save`` loads in the JAX
  package and searches the same.
- A full probe equals the exact ``DenseIndex`` (ids equal, scores within
  1e-6 relative); recall@10 at 4 of 20 cells above the JAX test's 0.9.
- No document is dropped or doubled, with small pad factors and a tiny
  corpus; two builds with one seed are bitwise equal; a mesh that is not a
  ``DeviceMesh`` is refused.
- The Executor: the JAX and the port Executor over copies of one catalog
  retrieve the same ids; the CLI's ``run`` persists what a direct search
  returns; a served IVF workspace answers as the pipeline does.

Everything runs on the CPU (``device="cpu"``), as the port's CPU tests do.
"""

import importlib
import json
import shutil
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from autorag_research_tpu.index.ivf import IVFIndex as JIVF
from autorag_research_tpu.index.ivf import _kmeans as j_kmeans
from autorag_research_tpu_torch.index.dense import DenseIndex, l2_normalize
from autorag_research_tpu_torch.index.ivf import IVFIndex, _kmeans, train_centroids

RTOL = 1e-6
CPU = "cpu"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def clear_cache():
    for pkg in ("autorag_research_tpu", "autorag_research_tpu_torch"):
        _mod(pkg, "index.registry").invalidate()
    yield
    for pkg in ("autorag_research_tpu", "autorag_research_tpu_torch"):
        _mod(pkg, "index.registry").invalidate()


@pytest.fixture(scope="module")
def clustered():
    """``tests/test_ivf.py``'s corpus: 20 centres x 100 points, d = 48."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(20, 48)).astype(np.float32) * 3
    points = np.concatenate([c + rng.normal(size=(100, 48)).astype(np.float32) * 0.3 for c in centers])
    queries = np.concatenate([c + rng.normal(size=(2, 48)).astype(np.float32) * 0.3 for c in centers])
    return [f"d{i}" for i in range(len(points))], points, queries


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


def recall_at_k(approx_hits, exact_hits, k):
    return float(np.mean([
        len({h.doc_id for h in a[:k]} & {h.doc_id for h in e[:k]}) / max(len(e[:k]), 1)
        for a, e in zip(approx_hits, exact_hits)
    ]))


# ---------------------------------------------------------------- k-means
@pytest.mark.parametrize("n_cells,iterations", [(20, 8), (12, 3)])
def test_kmeans_matches_jax_from_the_same_rows(clustered, n_cells, iterations):
    import jax.numpy as jnp

    _, points, _ = clustered
    data = l2_normalize(points)
    init = np.random.default_rng(7).choice(len(data), size=n_cells, replace=False)
    want = np.asarray(j_kmeans(jnp.asarray(data), jnp.asarray(init), n_cells=n_cells,
                               iterations=iterations))
    got = _kmeans(torch.from_numpy(data), torch.from_numpy(init), n_cells, iterations).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np.argmax(data @ got.T, axis=1), np.argmax(data @ want.T, axis=1))


def test_train_centroids_draws_the_jax_rows(clustered):
    from autorag_research_tpu.index.ivf import train_centroids as j_train

    _, points, _ = clustered
    data = l2_normalize(points)
    want = np.asarray(j_train(data, 20, 8, np.random.default_rng(3)))
    got = train_centroids(torch.from_numpy(data), 20, 8, np.random.default_rng(3)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_empty_cells_keep_their_centroid():
    data = l2_normalize(np.eye(4, dtype=np.float32)[[0, 0, 1, 1]])
    init = np.array([0, 1, 2])  # rows 0 and 1 are equal: cell 1 never wins
    got = _kmeans(torch.from_numpy(data), torch.from_numpy(init), 3, 2).numpy()
    np.testing.assert_array_equal(got[1], data[1])


# ------------------------------------------------------ carried-over state
@pytest.fixture(scope="module")
def jax_index(clustered, tmp_path_factory):
    ids, points, _ = clustered
    j = JIVF(ids, points, n_cells=20, seed=0)
    path = tmp_path_factory.mktemp("jivf")
    j.save(path)
    return j, path


@pytest.mark.parametrize("nprobe", [1, None, 20])
@pytest.mark.parametrize("k", [1, 10, 37])
def test_search_on_jax_state_matches_jax(jax_index, clustered, nprobe, k):
    j, path = jax_index
    _, _, queries = clustered
    t = IVFIndex.load(path, device=CPU)
    assert (t.n_cells, t.nprobe, t.cell_pad) == (j.n_cells, j.nprobe, j.cell_pad)
    _assert_same(t.search(queries, k, nprobe=nprobe), j.search(queries, k, nprobe=nprobe))


def test_query_tensors_search_as_numpy(jax_index, clustered):
    _, path = jax_index
    _, _, queries = clustered
    t = IVFIndex.load(path, device=CPU)
    _assert_same(t.search(torch.from_numpy(queries), 10), t.search(queries, 10))
    _assert_same(t.search(queries[3], 5), t.search(queries[3:4], 5))


def test_gather_budget_does_not_change_results(jax_index, clustered, monkeypatch):
    from autorag_research_tpu_torch.index import ivf

    _, path = jax_index
    _, _, queries = clustered
    t = IVFIndex.load(path, device=CPU)
    whole = t.search(queries, 10, nprobe=6)
    monkeypatch.setattr(ivf, "GATHER_BUDGET_BYTES", 1)  # one query a step
    _assert_same(t.search(queries, 10, nprobe=6), whole)


def test_port_save_loads_in_jax(clustered, tmp_path):
    ids, points, queries = clustered
    t = IVFIndex(ids, points, n_cells=16, seed=4, device=CPU)
    t.save(tmp_path / "ivf")
    j = JIVF.load(tmp_path / "ivf")
    np.testing.assert_array_equal(j.members, t.members)
    np.testing.assert_array_equal(j.centroids, t.centroids)
    _assert_same(t.search(queries, 10), j.search(queries, 10))
    back = IVFIndex.load(tmp_path / "ivf", device=CPU)
    _assert_same(back.search(queries, 10), t.search(queries, 10))


# ------------------------------------------------------------- the index
def test_full_probe_equals_exact(clustered):
    ids, points, queries = clustered
    exact = DenseIndex(ids, points, device=CPU).search(queries, 10)
    t = IVFIndex(ids, points, n_cells=20, nprobe=4, seed=0, device=CPU)
    _assert_same(t.search(queries, 10, nprobe=20), exact)
    assert recall_at_k(t.search(queries, 10), exact, 10) > 0.9


@pytest.mark.parametrize("pad_factor", [2.0, 1.2, 0.5])
def test_no_docs_dropped(clustered, pad_factor):
    ids, points, _ = clustered
    t = IVFIndex(ids, points, n_cells=16, pad_factor=pad_factor, device=CPU)
    packed = t.members[t.members < len(ids)]
    assert len(packed) == len(ids) and len(set(packed.tolist())) == len(ids)
    assert int(t.cell_counts.sum()) == len(ids)


def test_tiny_corpus():
    rng = np.random.default_rng(1)
    points = rng.normal(size=(5, 16)).astype(np.float32)
    t = IVFIndex(list(range(5)), points, device=CPU)
    j = JIVF(list(range(5)), points)
    assert (t.n_cells, t.nprobe, t.cell_pad) == (j.n_cells, j.nprobe, j.cell_pad) == (5, 1, 8)
    assert t.search(points[:1], 3)[0][0].doc_id == 0
    assert sorted(t.members[t.members < 5].tolist()) == list(range(5))


def test_two_builds_with_one_seed_are_bitwise_equal(clustered):
    ids, points, _ = clustered
    a = IVFIndex(ids, points, n_cells=24, seed=9, device=CPU)
    b = IVFIndex(ids, points, n_cells=24, seed=9, device=CPU)
    assert a.centroids.tobytes() == b.centroids.tobytes()
    np.testing.assert_array_equal(a.members, b.members)
    assert set(a.build_seconds) == {"normalize", "upload", "kmeans", "assign", "pack"}


def test_device_placement_and_mesh_refused(clustered):
    ids, points, _ = clustered
    t = IVFIndex(ids, points, n_cells=8, device=CPU)
    assert all(x.device.type == "cpu" for x in t._device)
    assert t.device_bytes() == (len(ids) + 1) * 48 * 4 + 8 * 48 * 4 + t.members.size * 4
    with pytest.raises(TypeError, match="DeviceMesh"):  # sharding: tests/test_torch_parallel.py
        t.to_device(mesh=object())
    if not torch.cuda.is_available():  # the default is the card, never the CPU in its place
        with pytest.raises((RuntimeError, AssertionError)):
            IVFIndex(ids, points, n_cells=8)


# ------------------------------------------------------- the entry points
def _clustered_catalog(path, n_clusters=12, per=30, dim=32, n_queries=24):
    """A port catalog of well-separated clusters with query embeddings and
    one gold document a query."""
    from autorag_research_tpu_torch.store.catalog import Catalog

    rng = np.random.default_rng(5)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32) * 3
    emb = np.concatenate([c + 0.1 * rng.normal(size=(per, dim)).astype(np.float32) for c in centers])
    cat = Catalog(path, embedding_dim=dim)
    cat.add_chunks([{"id": i, "contents": f"doc {i}", "embedding": e} for i, e in enumerate(emb)])
    gold = rng.choice(len(emb), size=n_queries, replace=False)
    cat.add_queries([{"id": j, "contents": f"query {j}",
                      "embedding": emb[g] + 0.05 * rng.normal(size=dim).astype(np.float32)}
                     for j, g in enumerate(gold)])
    for j, g in enumerate(gold):
        cat.add_retrieval_gt(j, int(g))
    cat.close()


@pytest.mark.parametrize("index_type", ["ivf", "ivf_contiguous"])
def test_executor_retrieves_the_jax_executors_ids(tmp_path, index_type):
    _clustered_catalog(tmp_path / "src.db")
    rows, stats = {}, {}
    for pkg in ("autorag_research_tpu", "autorag_research_tpu_torch"):
        shutil.copy(tmp_path / "src.db", tmp_path / f"{pkg}.db")
        cat = _mod(pkg, "store.catalog").Catalog(tmp_path / f"{pkg}.db")
        config = _mod(pkg, "config")
        vs = _mod(pkg, "pipelines.retrieval.vector_search")
        cfg = config.ExecutorConfig(
            pipelines=[vs.VectorSearchConfig(name="ivf_vs", index_type=index_type, top_k=5)],
            metrics=[config.BaseMetricConfig(name="recall")],
            health_check=True,
            health_check_queries=2,
        )
        args = (config.BuildContext(device="cpu"),) if pkg.endswith("torch") else ()
        result = _mod(pkg, "executor").Executor(cat, cfg, *args).run()
        assert result.success, result.report()
        pid = result.pipelines[0].stats["pipeline_id"]
        rows[pkg] = [[(r["doc_id"], r["rel_score"]) for r in cat.get_retrieved(q, pid)]
                     for q in cat.get_all_query_ids()]
        stats[pkg] = (result.pipelines[0].stats["total_results"], result.pipelines[0].metrics[0].average)
        cat.close()
    j, t = rows["autorag_research_tpu"], rows["autorag_research_tpu_torch"]
    assert [[d for d, _ in r] for r in t] == [[d for d, _ in r] for r in j]
    for a, b in zip(t, j):
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b], rtol=1e-5)
    # (the contiguous default probes one block of these 37, whose tail may
    # hold fewer than 5 rows: both packages persist what they found)
    assert stats["autorag_research_tpu"] == stats["autorag_research_tpu_torch"]
    assert stats["autorag_research_tpu_torch"][0] >= (120 if index_type == "ivf" else 100)


def _cli_workspace(root, monkeypatch, experiment):
    from autorag_research_tpu_torch.cli.app import main

    root.mkdir()
    monkeypatch.chdir(root)
    assert main(["init"]) == 0
    (root / "configs" / "experiment.yaml").write_text(yaml.safe_dump(experiment))
    assert main(["--device", "cpu", "ingest", "--name", "synthetic", "--db", "ws", "--extra",
                 "n_docs=300", "--extra", "n_queries=20", "--embedding-model", "mock"]) == 0
    return main


def test_cli_run_with_the_ivf_template(tmp_path, monkeypatch, capsys):
    """``run`` of an experiment naming ``vector_search_ivf`` (the template
    ``init`` writes): every query's rows are those of a direct search of the
    index built from the same catalog, and ``report`` lists it."""
    from autorag_research_tpu_torch.store.catalog import Catalog

    root = tmp_path / "ws_root"
    experiment = {"pipelines": {"retrieval": ["vector_search_ivf"], "generation": []},
                  "metrics": {"retrieval": ["recall", "ndcg"], "generation": []},
                  "executor": {"health_check": True, "health_check_queries": 2}}
    main = _cli_workspace(root, monkeypatch, experiment)
    template = yaml.safe_load((root / "configs/pipelines/retrieval/vector_search_ivf.yaml").read_text())
    assert template["index_type"] == "ivf"
    assert main(["--device", "cpu", "run", "--db", "ws"]) == 0
    assert "vector_search_ivf" in capsys.readouterr().out
    cat = Catalog(root / "ws" / "catalog.db")
    pid = cat.get_pipeline("vector_search_ivf")["id"]
    qids = cat.get_all_query_ids()
    idx = IVFIndex.from_catalog(cat, device=CPU)
    embs = np.stack([cat.get_embedding("query", q) for q in qids])
    direct = idx.search(embs, 10)
    for q, hits in zip(qids, direct):
        got = [(r["doc_id"], r["rel_score"]) for r in cat.get_retrieved(q, pid)]
        assert [d for d, _ in got] == [h.doc_id for h in hits]
        np.testing.assert_allclose([s for _, s in got], [h.score for h in hits], rtol=RTOL)
    assert list((root / "ws" / "indexes").glob("ivf_chunk*"))  # artifact persisted
    cat.close()
    assert main(["report", "--db", "ws"]) == 0
    assert "vector_search_ivf" in capsys.readouterr().out


def test_serve_workspace_serves_an_ivf_pipeline(tmp_path, monkeypatch):
    from autorag_research_tpu_torch.serving.server import serve_workspace
    from autorag_research_tpu_torch.store.catalog import Catalog

    root = tmp_path / "ws_root"
    _cli_workspace(root, monkeypatch, {"pipelines": {"retrieval": [], "generation": []},
                                       "metrics": {"retrieval": [], "generation": []}})
    ivf_yaml = root / "configs/pipelines/retrieval/vector_search_ivf.yaml"
    ivf_yaml.write_text(ivf_yaml.read_text() + "embedding_model: mock\n")
    h = serve_workspace(str(root / "ws"), config_path=str(root / "configs"),
                        retrieval=["vector_search_ivf"], port=0, device=CPU)
    try:
        cat = Catalog(root / "ws" / "catalog.db")
        queries = [r["contents"] for r in cat.get_queries(limit=6)]
        cat.close()
        req = urllib.request.Request(
            f"http://127.0.0.1:{h.port}/search",
            data=json.dumps({"queries": queries, "top_k": 10, "pipeline": "vector_search_ivf"}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status == 200
            served = json.loads(resp.read())["results"]
        pipe = h.retrieval_pipelines["vector_search_ivf"]
        direct = pipe._retrieve_batch_by_texts(queries, 10)
        assert len(served) == len(direct) == 6 and all(served)
        for s, d in zip(served, direct):
            assert [x["doc_id"] for x in s] == [x["doc_id"] for x in d]
            np.testing.assert_allclose([x["score"] for x in s], [x["score"] for x in d], rtol=1e-5)
    finally:
        h.stop()
