"""The port's cross-encoder (``models/cross_encoder.py``) and its reranker
(``rerankers/torch_cross.py``, kind ``torch_cross_encoder``) against the JAX
package's ``models/cross_encoder.py`` and ``rerankers/jax_cross.py``.

Weights are carried by ``cross_params_from_jax`` (or the ``.npz`` that the
JAX ``CrossEncoderTrainer.save`` writes). ``pair_tokenize`` is host numpy and
must be bitwise equal. Scores are f32 and must agree within ``TOL`` = 1e-5
absolute (reduction order; 3e-8 measured at these widths); rerank orders are
equal wherever two scores differ by more than ``TOL``. The port runs on the
CPU here (``device="cpu"``); its default device is ``cuda``, where
``chip_smoke.py`` (phase 21) holds the card's scores against the CPU's.
"""

import importlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from autorag_research_tpu.embeddings.jax_encoder import _flatten_params
from autorag_research_tpu.models import cross_encoder as jce
from autorag_research_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from autorag_research_tpu.rerankers.jax_cross import JaxCrossEncoderReranker
from autorag_research_tpu_torch.models import cross_encoder as tce
from autorag_research_tpu_torch.models.encoder import EncoderConfig
from autorag_research_tpu_torch.rerankers.torch_cross import TorchCrossEncoderReranker

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, max_len=32, out_dim=16)
TOL = 1e-5
LONG = " ".join(f"word{i}" for i in range(80))
QUERIES = ["what is x", "", "ünïcode quéry ☃ here", LONG, "capital of France"]
DOCS = ["x is a thing", "a doc for the empty query", "", LONG[::-1], "Paris is in France"]
TEXTS = ["Paris is the capital of France", "Berlin is in Germany", "dogs are pets",
         "the capital city of france is paris", "", "café ☃ unicode passage", LONG,
         "France borders Spain", "capital letters", "nothing relevant at all"]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def jax_model(seed=0, **kw):
    enc = jce.CrossEncoder(JaxEncoderConfig(**{**SMALL, **kw}))
    return enc, enc.init(seed)


def torch_model(params, **kw):
    model = tce.CrossEncoder(EncoderConfig(**{**SMALL, **kw}), device="cpu")
    model.load_state_dict(tce.cross_params_from_jax(_flatten_params(params)))
    return model


def assert_orders_equal_but_near_ties(got, ref):
    """``got`` / ``ref``: RerankResult lists. Scores within TOL; the orders
    equal, except that two entries may swap where their scores are within
    TOL of each other."""
    assert len(got) == len(ref)
    ref_score = {r.index: r.score for r in ref}
    for g in got:
        assert abs(g.score - ref_score[g.index]) <= TOL
    for g, r in zip(got, ref):
        if g.index != r.index:
            assert abs(ref_score[g.index] - r.score) <= 2 * TOL


# -------------------------------------------------------------- pair_tokenize


@pytest.mark.parametrize("max_len", [8, 32, 128])
def test_pair_tokenize_bitwise(max_len):
    """Empty, long and non-ASCII legs: ids and mask bitwise the JAX ones; SEP
    sits right after the query's real tokens."""
    got = tce.pair_tokenize(QUERIES, DOCS, 512, max_len)
    ref = jce.pair_tokenize(QUERIES, DOCS, 512, max_len)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape and np.array_equal(g, r)
    ids, mask = got
    half = max(1, (max_len - 1) // 2)
    for i, q in enumerate(QUERIES):
        ql = max(1, min(len(q.split()), half))  # an empty leg keeps one masked slot
        assert ids[i, ql] == tce.SEP_TOKEN and mask[i, : ql + 1].all()
    assert tce.SEP_TOKEN == jce.SEP_TOKEN


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("max_len", [16, 32])
def test_forward_matches_jax(seed, max_len):
    enc, params = jax_model(seed, max_len=max_len)
    model = torch_model(params, max_len=max_len)
    ids, mask = tce.pair_tokenize(QUERIES * 3, DOCS[::-1] * 3, 512, max_len)
    ref = np.asarray(enc(params, jnp.asarray(ids), jnp.asarray(mask)))
    got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape == (15,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_params_carry_both_ways():
    _, params = jax_model(2)
    flat = _flatten_params(params)
    model = torch_model(params)
    assert set(model.state_dict()) == set(flat)
    assert "out_proj" not in flat and flat["score.w"].shape == (64, 1) and flat["score.b"].shape == (1,)
    back = tce.cross_params_to_jax(model)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


def test_seeded_init_shapes_and_zero_bias():
    """Random init from the seed: repeatable, layer norms at (1, 0), the score
    bias at 0, every matrix drawn (JAX's PRNG stream differs by design)."""
    a = tce.CrossEncoder(EncoderConfig(**SMALL), device="cpu", seed=3)
    b = tce.CrossEncoder(EncoderConfig(**SMALL), device="cpu", seed=3)
    c = tce.CrossEncoder(EncoderConfig(**SMALL), device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
    assert torch.equal(sa["score.b"], torch.zeros(1)) and torch.equal(sa["final_ln.scale"], torch.ones(64))
    assert float(sa["score.w"].std()) > 0.01


# ----------------------------------------------------------------- reranker


def test_trained_checkpoint_reranks_as_jax(tmp_path):
    """A JAX ``CrossEncoderTrainer`` checkpoint (``tests/test_cross_encoder.py``'s
    catalog, a few steps) through ``TorchCrossEncoderReranker(params_path=)``:
    scores within TOL and equal orders of JAX's reranker on the same file."""
    from autorag_research_tpu.store.catalog import Catalog
    from autorag_research_tpu.store.gt import or_all

    cat = Catalog(tmp_path / "ce.db")
    docs = [f"topic {chr(97 + i)} document body {i}" for i in range(8)]
    cat.add_chunks([{"id": i, "contents": d} for i, d in enumerate(docs)])
    cat.add_queries([{"id": i, "contents": f"find topic {chr(97 + i)}"} for i in range(8)])
    for i in range(8):
        cat.add_retrieval_gt(i, or_all([i]))
    trainer = jce.CrossEncoderTrainer(JaxEncoderConfig(**SMALL), lr=0.01, batch_size=8)
    report = trainer.train(cat, epochs=20, max_steps=20)
    assert report.steps == 20
    path = tmp_path / "ce_params.npz"
    trainer.save(path)
    jr = JaxCrossEncoderReranker(JaxEncoderConfig(**SMALL), params_path=path)
    tr = TorchCrossEncoderReranker(EncoderConfig(**SMALL), params_path=path, device="cpu")
    for i in range(8):
        q = f"find topic {chr(97 + i)}"
        assert_orders_equal_but_near_ties(tr.rerank(q, docs), jr.rerank(q, docs))
        got, ref = tr.rerank(q, docs, top_k=3), jr.rerank(q, docs, top_k=3)
        assert len(got) == 3 and [g.text for g in got] == [r.text for r in ref]


@pytest.mark.parametrize("batch_size", [1, 3, 4, 64])
def test_unpadded_chunks_score_as_padded(batch_size):
    """JAX pads each chunk to ``batch_size`` with empty texts; the port scores
    the chunk as it is. The real rows' scores agree within TOL, and the port
    at any batch size agrees with itself at one batch."""
    enc, params = jax_model(1)
    jr = JaxCrossEncoderReranker(JaxEncoderConfig(**SMALL), batch_size=batch_size)
    jr.params = params
    tr = TorchCrossEncoderReranker(EncoderConfig(**SMALL), batch_size=batch_size, device="cpu")
    tr.model.load_state_dict(tce.cross_params_from_jax(_flatten_params(params)))
    one = TorchCrossEncoderReranker(EncoderConfig(**SMALL), batch_size=len(TEXTS), device="cpu")
    one.model.load_state_dict(tr.model.state_dict())
    q = "capital of france"
    got = tr.rerank(q, TEXTS)
    assert_orders_equal_but_near_ties(got, jr.rerank(q, TEXTS))
    assert_orders_equal_but_near_ties(got, one.rerank(q, TEXTS))
    assert tr.rerank(q, []) == [] and len(tr.rerank(q, TEXTS, top_k=4)) == 4


def test_reranker_device_defaults_to_cuda():
    """Construction on the default device raises where there is no GPU; it
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        TorchCrossEncoderReranker(EncoderConfig(**SMALL))
    with pytest.raises((AssertionError, RuntimeError)):
        _mod(TORCH, "injection").ModelRegistry().load_reranker("torch_cross_encoder")


# ----------------------------------------------------------------- registry


def test_registry_torch_cross_encoder_from_yaml(tmp_path):
    """YAML widths map to ``EncoderConfig`` as the JAX registry maps them for
    ``jax_cross_encoder``; with the same ``params_path`` both rerank alike."""
    _, params = jax_model(4)
    path = tmp_path / "w.npz"
    np.savez(path, **_flatten_params(params))
    (tmp_path / "reranker").mkdir()
    spec = {**{k: SMALL[k] for k in ("vocab_size", "hidden", "layers", "heads", "max_len")},
            "out_dim": 16, "params_path": str(path), "batch_size": 4}
    (tmp_path / "reranker" / "ce.yaml").write_text(yaml.dump({"type": "torch_cross_encoder", **spec}))
    (tmp_path / "reranker" / "jce.yaml").write_text(yaml.dump({"type": "jax_cross_encoder", **spec}))
    reg = _mod(TORCH, "injection").ModelRegistry(tmp_path, device="cpu")
    rr = reg.load_reranker("ce")
    assert isinstance(rr, TorchCrossEncoderReranker) and rr.device.type == "cpu"
    assert rr.config == EncoderConfig(**SMALL) and rr.batch_size == 4
    assert reg.load_reranker("ce") is rr  # cached
    jrr = _mod(JAX, "injection").ModelRegistry(tmp_path).load_reranker("jce")
    assert_orders_equal_but_near_ties(rr.rerank("capital", TEXTS), jrr.rerank("capital", TEXTS))
    # the bare builtin name resolves on the registry's device, at EncoderConfig's defaults
    bare = _mod(TORCH, "injection").ModelRegistry(device="cpu").load_reranker("torch_cross_encoder")
    assert bare.config == EncoderConfig() and bare.model_name == "torch_cross_encoder"


def test_registry_refuses_jax_cross_encoder():
    with pytest.raises(_mod(TORCH, "exceptions").ModelLoadError, match="'torch_cross_encoder'"):
        _mod(TORCH, "injection").ModelRegistry(device="cpu").load_reranker("jax_cross_encoder")


def test_template_replaces_the_jax_cross_encoder_file():
    from autorag_research_tpu.cli.templates import DEFAULT_CONFIGS as JAX_CONFIGS
    from autorag_research_tpu_torch.cli.templates import DEFAULT_CONFIGS

    assert "reranker/jax_cross_encoder.yaml" not in DEFAULT_CONFIGS
    got = DEFAULT_CONFIGS["reranker/torch_cross_encoder.yaml"]
    ref = JAX_CONFIGS["reranker/jax_cross_encoder.yaml"]
    assert got == ref.replace("jax_cross_encoder", "torch_cross_encoder")


# ------------------------------------------------------- through the Executor


def _rerank_catalog(cat):
    """``tests/test_cross_encoder.py``'s rerank catalog, with more passages."""
    docs = ["Paris is the capital of France", "Berlin is in Germany", "dogs are pets",
            "the capital of France is a large city", "France and Germany are neighbours",
            "capital gains tax in France"]
    cat.add_chunks([{"id": i, "contents": d} for i, d in enumerate(docs)])
    cat.add_queries([{"id": 0, "contents": "capital of France"},
                     {"id": 1, "contents": "where is Berlin"}])
    cat.add_retrieval_gt(0, 0)
    cat.add_retrieval_gt(1, 1)


def test_rerank_through_both_executors(tmp_path):
    """``rerank`` over ``bm25`` with the cross-encoder on carried weights,
    through each package's ``Executor`` on copies of one catalog: equal ids in
    equal order, scores within TOL, equal recall."""
    src = tmp_path / "src.db"
    cat = _mod(TORCH, "store.catalog").Catalog(src)
    _rerank_catalog(cat)
    cat.close()
    _, params = jax_model(6)
    weights = tmp_path / "w.npz"
    np.savez(weights, **_flatten_params(params))
    (tmp_path / "configs" / "reranker").mkdir(parents=True)
    spec = {**SMALL, "params_path": str(weights)}
    for kind in ("torch_cross_encoder", "jax_cross_encoder"):
        (tmp_path / "configs" / "reranker" / f"{kind}.yaml").write_text(
            yaml.dump({"type": kind, **spec}))
    out = {}
    for pkg, kind in ((JAX, "jax_cross_encoder"), (TORCH, "torch_cross_encoder")):
        _mod(pkg, "index.registry").invalidate()
        (tmp_path / pkg).mkdir()
        shutil.copy(src, tmp_path / pkg / "rr.db")
        pcat = _mod(pkg, "store.catalog").Catalog(tmp_path / pkg / "rr.db")
        cfg = _mod(pkg, "config")
        dev = {"device": "cpu"} if pkg == TORCH else {}
        config = cfg.ExecutorConfig(
            pipelines=[_mod(pkg, "pipelines.retrieval.rerank").RerankConfig(
                name="rr", inner_retrieval_pipeline_name="bm25_leg", reranker=kind, top_k=3)],
            metrics=[cfg.BaseMetricConfig(name="recall")], health_check=False)
        context = cfg.BuildContext(
            models=_mod(pkg, "injection").ModelRegistry(tmp_path / "configs", health_check=False, **dev),
            pipeline_configs={"bm25_leg": _mod(pkg, "pipelines.retrieval.bm25").BM25Config(
                name="bm25_leg", top_k=3)}, **dev)
        result = _mod(pkg, "executor").Executor(pcat, config, context).run()
        assert result.success, result.report()
        pres = result.pipelines[0]
        pid = pres.stats["pipeline_id"]
        out[pkg] = ({q: [(r["doc_id"], r["rel_score"]) for r in pcat.get_retrieved(q, pid)]
                     for q in (0, 1)}, pres.metrics[0].average)
        _mod(pkg, "index.registry").invalidate()
    (got, recall), (ref, jrecall) = out[TORCH], out[JAX]
    assert recall == jrecall
    for q in (0, 1):
        assert [d for d, _ in got[q]] == [d for d, _ in ref[q]], q
        assert len(got[q]) == 3
        np.testing.assert_allclose([s for _, s in got[q]], [s for _, s in ref[q]], rtol=0, atol=TOL)
