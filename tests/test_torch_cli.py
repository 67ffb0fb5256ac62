"""The port's CLI, config resolver, model registry, reporting and plugins
against the JAX package's, case by case with ``tests/test_cli.py``.

Each workspace case runs both CLIs (the port's with ``--device cpu``) in
directories of their own from the same inputs. ``init`` writes the same
tree but for the model files of the JAX package's own models
(``embedding/jax_encoder*.yaml`` become ``embedding/torch_encoder*.yaml``,
``llm/jax_lm.yaml`` becomes ``llm/torch_lm.yaml`` and
``reranker/jax_cross_encoder.yaml`` becomes ``reranker/torch_cross_encoder.yaml``,
each with the same defaults).
``ingest`` then ``run`` give equal result rows
(ids equal; the dense legs' scores within 1e-5 relative, BM25's within
1e-6; the fused scores within 1e-5 absolute plus 1e-6 relative, ids equal up
to near-ties within that) and equal metric averages; ``report`` prints the
same leaderboard. ``health-check`` runs on the CPU; ``train`` writes weights
that the JAX package's loaders read; ``--device cuda`` without a GPU is
refused; ``train --mesh`` and the hub actions (``data upload`` /
``download``, ``show dumps``, against a stand-in ``huggingface_hub``) run
(``run --mesh`` and ``serve --mesh``: ``tests/test_torch_parallel.py``).
"""

import importlib
import json
import re
import sqlite3
import tarfile

import numpy as np
import pytest
import torch
import yaml

from autorag_research_tpu.cli.app import main as jax_main
from autorag_research_tpu_torch.cli.app import main as torch_main

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, max_len=16, out_dim=32)
MAINS = {JAX: jax_main, TORCH: lambda argv: torch_main(["--device", "cpu", *argv])}
JAX_MODEL_FILES = {"llm/jax_lm.yaml", "reranker/jax_cross_encoder.yaml",
                   "embedding/jax_encoder.yaml", "embedding/jax_encoder_multi.yaml"}
TORCH_MODEL_FILES = {"embedding/torch_encoder.yaml", "embedding/torch_encoder_multi.yaml",
                     "llm/torch_lm.yaml", "reranker/torch_cross_encoder.yaml"}
EXACT = ("vector_search", "vector_search_verified", "bm25", "hybrid_rrf")
FUSED = ("hybrid_cc",)
EXPERIMENT = {
    "pipelines": {"retrieval": [*EXACT, *FUSED], "generation": []},
    "metrics": {"retrieval": ["recall", "ndcg", "mrr"], "generation": []},
    "executor": {"health_check": True, "health_check_queries": 2},
}


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def clear_cache():
    for pkg in (JAX, TORCH):
        _mod(pkg, "index.registry").invalidate()
    yield
    for pkg in (JAX, TORCH):
        _mod(pkg, "index.registry").invalidate()


def _docs_dir(root):
    data = root / "data"
    data.mkdir()
    docs = ["quick brown fox", "lazy dog", "gpu vector search", "rag systems"]
    (data / "corpus.jsonl").write_text(
        "\n".join(json.dumps({"id": i, "contents": d}) for i, d in enumerate(docs))
    )
    (data / "queries.jsonl").write_text(
        json.dumps({"id": 100, "contents": "fox", "gt": [[0]], "generation_gt": ["fox"]})
        + "\n"
        + json.dumps({"id": 101, "contents": "gpu search", "gt": [[2]]})
    )


@pytest.fixture
def workspaces(tmp_path, monkeypatch):
    """``tests/test_cli.py``'s workspace, once per package."""
    out = {}
    for pkg in (JAX, TORCH):
        root = tmp_path / pkg
        root.mkdir()
        monkeypatch.chdir(root)
        assert MAINS[pkg](["init"]) == 0
        _docs_dir(root)
        assert MAINS[pkg](["ingest", "--name", "local", "--db", "ws", "--extra", "data_dir=data",
                           "--embedding-model", "mock"]) == 0
        out[pkg] = root
    return out


def _rows(db):
    """Result rows per pipeline name, and metric averages per (pipeline, metric)."""
    with sqlite3.connect(db) as conn:
        rows = conn.execute(
            "SELECT p.name, r.query_id, r.chunk_id, r.rel_score FROM chunk_retrieved_result r "
            "JOIN pipeline p ON p.id = r.pipeline_id ORDER BY p.name, r.query_id, r.rel_score DESC, "
            "r.chunk_id"
        ).fetchall()
        avgs = conn.execute(
            "SELECT p.name, m.name, AVG(e.value), COUNT(e.value) FROM evaluation_result e "
            "JOIN pipeline p ON p.id = e.pipeline_id JOIN metric m ON m.id = e.metric_id "
            "GROUP BY p.name, m.name ORDER BY p.name, m.name"
        ).fetchall()
    by = {}
    for name, q, c, s in rows:
        by.setdefault(name, {}).setdefault(q, []).append((c, s))
    return by, avgs


def _assert_runs_equal(db_j, db_t, exact=EXACT, fused=FUSED):
    (rj, aj), (rt, at) = _rows(db_j), _rows(db_t)
    assert sorted(rt) == sorted(rj) == sorted([*exact, *fused])
    for name in rj:
        assert rt[name].keys() == rj[name].keys(), name
        for q in rj[name]:
            tj, tt = rj[name][q], rt[name][q]
            sj = np.array([s for _, s in tj])
            st = np.array([s for _, s in tt])
            if name in exact:
                assert [c for c, _ in tt] == [c for c, _ in tj], (name, q)
                rtol = 1e-6 if name == "bm25" else 1e-5
                np.testing.assert_allclose(st, sj, rtol=rtol, err_msg=f"{name} {q}")
            else:
                np.testing.assert_allclose(st, sj, rtol=1e-6, atol=1e-5, err_msg=f"{name} {q}")
                score_j = dict(tj)
                for (cj, s), (ct, _) in zip(tj, tt):
                    # ids equal up to fused near-ties within the tolerance
                    assert ct == cj or abs(score_j.get(ct, np.inf) - s) <= 1e-5 + 1e-6 * abs(s)
    assert at == aj


def test_init_idempotent_and_same_tree(tmp_path, monkeypatch):
    trees = {}
    for pkg in (JAX, TORCH):
        root = tmp_path / pkg
        root.mkdir()
        monkeypatch.chdir(root)
        assert MAINS[pkg](["init"]) == 0
        assert (root / "configs" / "experiment.yaml").exists()
        assert MAINS[pkg](["init"]) == 0  # second call: no overwrite, still ok
        trees[pkg] = {p.relative_to(root / "configs").as_posix(): p.read_text()
                      for p in (root / "configs").rglob("*.yaml")}
    assert set(trees[JAX]) - set(trees[TORCH]) == JAX_MODEL_FILES
    assert set(trees[TORCH]) - set(trees[JAX]) == TORCH_MODEL_FILES
    for rel in set(trees[JAX]) & set(trees[TORCH]):
        assert trees[TORCH][rel] == trees[JAX][rel], rel
    for suffix in ("", "_multi"):
        jspec = yaml.safe_load(trees[JAX][f"embedding/jax_encoder{suffix}.yaml"])
        tspec = yaml.safe_load(trees[TORCH][f"embedding/torch_encoder{suffix}.yaml"])
        assert tspec.pop("type") == "torch_encoder" and jspec.pop("type") == "jax_encoder"
        assert tspec == jspec
    jspec = yaml.safe_load(trees[JAX]["llm/jax_lm.yaml"])
    tspec = yaml.safe_load(trees[TORCH]["llm/torch_lm.yaml"])
    assert tspec.pop("type") == "torch_lm" and jspec.pop("type") == "jax_lm"
    assert tspec == jspec
    assert trees[TORCH]["reranker/torch_cross_encoder.yaml"] == \
        trees[JAX]["reranker/jax_cross_encoder.yaml"].replace("jax_cross_encoder", "torch_cross_encoder")


def test_full_run_and_report(workspaces, capsys, monkeypatch):
    """``test_full_run_and_report`` through both CLIs: the template's
    experiment, then ``report --html``."""
    out = {}
    for pkg, root in workspaces.items():
        monkeypatch.chdir(root)
        capsys.readouterr()
        assert MAINS[pkg](["run", "--db", "ws"]) == 0
        text = capsys.readouterr().out
        assert "vector_search" in text and "hybrid_rrf" in text and "recall" in text
        assert MAINS[pkg](["report", "--db", "ws", "--html", "report.html"]) == 0
        out[pkg] = capsys.readouterr().out.split("wrote")[0]
        html = (root / "report.html").read_text()
        assert "hybrid_rrf" in html and "Borda" in html
    assert out[TORCH] == out[JAX]
    _assert_runs_equal(workspaces[JAX] / "ws" / "catalog.db", workspaces[TORCH] / "ws" / "catalog.db",
                       exact=("vector_search", "bm25", "hybrid_rrf"), fused=())


def test_synthetic_ingest_run_report_match(tmp_path, capsys, monkeypatch):
    """The synthetic ingestor at ``scripts/parity_run.py``'s smoke scale,
    embedded by ``mock``, through both CLIs: an experiment of the dense
    legs (exact and verified), BM25, RRF and CC. Rows, averages, the
    printed leaderboard and ``show`` agree."""
    boards = {}
    for pkg in (JAX, TORCH):
        root = tmp_path / pkg
        root.mkdir()
        monkeypatch.chdir(root)
        main = MAINS[pkg]
        assert main(["init"]) == 0
        (root / "configs" / "experiment.yaml").write_text(yaml.safe_dump(EXPERIMENT))
        assert main(["ingest", "--name", "synthetic", "--db", "ws", "--extra", "n_docs=300",
                     "--extra", "n_queries=20", "--embedding-model", "mock"]) == 0
        assert main(["run", "--db", "ws"]) == 0
        capsys.readouterr()
        assert main(["report", "--db", "ws"]) == 0
        boards[pkg] = capsys.readouterr().out
        assert main(["show", "databases"]) == 0
        assert "ws" in capsys.readouterr().out
    _assert_runs_equal(tmp_path / JAX / "ws" / "catalog.db", tmp_path / TORCH / "ws" / "catalog.db")
    assert boards[TORCH] == boards[JAX]


def test_run_resume_is_a_noop(workspaces, monkeypatch):
    monkeypatch.chdir(workspaces[TORCH])
    assert MAINS[TORCH](["run", "--db", "ws"]) == 0
    before = _rows(workspaces[TORCH] / "ws" / "catalog.db")
    _mod(TORCH, "index.registry").invalidate()
    assert MAINS[TORCH](["run", "--db", "ws"]) == 0
    assert _rows(workspaces[TORCH] / "ws" / "catalog.db") == before


def test_dump_restore_cycle(workspaces, monkeypatch):
    for pkg, root in workspaces.items():
        monkeypatch.chdir(root)
        main = MAINS[pkg]
        assert main(["data", "dump", "--db", "ws", "--file", "ws.tar.gz"]) == 0
        assert main(["data", "restore", "--db", "ws2", "--file", "ws.tar.gz"]) == 0
        assert (root / "ws2" / "catalog.db").exists()
        assert (root / "ws" / "catalog.db").exists()  # original untouched
        assert main(["data", "restore", "--db", "ws2", "--file", "ws.tar.gz"]) == 1


def test_drop(workspaces, monkeypatch):
    for pkg, root in workspaces.items():
        monkeypatch.chdir(root)
        assert MAINS[pkg](["drop", "--db", "ws", "-y"]) == 0
        assert not (root / "ws").exists()
        assert MAINS[pkg](["drop", "--db", "ws", "-y"]) == 1


@pytest.mark.parametrize("what,needle", [("ingestors", "synthetic"), ("pipelines", "hybrid_rrf"),
                                         ("metrics", "ndcg")])
def test_show_variants(workspaces, capsys, monkeypatch, what, needle):
    monkeypatch.chdir(workspaces[TORCH])
    capsys.readouterr()
    assert MAINS[TORCH](["show", what]) == 0
    assert needle in capsys.readouterr().out


def test_show_lists_what_the_port_has(capsys):
    assert torch_main(["show", "pipelines"]) == 0
    names = {line.split()[0] for line in capsys.readouterr().out.splitlines()}
    assert names == set(_mod(TORCH, "config").BasePipelineConfig.registry)
    assert torch_main(["show", "metrics"]) == 0
    out = capsys.readouterr().out
    assert "recall" in out
    assert jax_main(["show", "metrics"]) == 0
    assert out == capsys.readouterr().out  # the generation metrics too


def test_health_check(workspaces, capsys, monkeypatch):
    monkeypatch.chdir(workspaces[TORCH])
    capsys.readouterr()
    assert MAINS[TORCH](["health-check", "--db", "ws", "--embedding", "mock"]) == 0
    out = capsys.readouterr().out
    assert "db ok" in out and "embedding 'mock' ok" in out and "device cpu" in out
    assert MAINS[TORCH](["health-check", "--llm", "mock"]) == 0
    assert "llm 'mock' ok" in capsys.readouterr().out
    assert MAINS[TORCH](["health-check", "--llm", "jax_lm"]) == 1
    assert "'torch_lm'" in capsys.readouterr().out
    assert MAINS[TORCH](["health-check", "--llm", "no_such_model"]) == 1
    assert MAINS[TORCH](["health-check", "--db", "nope.db"]) == 1


@pytest.mark.parametrize("argv", [
    ["run", "--db", "ws"],
    ["ingest", "--name", "local", "--db", "ws", "--extra", "data_dir=data"],
    ["serve", "--db", "ws"],
    ["health-check"],
    ["train", "--db", "ws", "--out", "p.npz"],
], ids=["run", "ingest", "serve", "health-check", "train"])
def test_cuda_without_gpu_fails(workspaces, capsys, monkeypatch, argv):
    """The default ``--device cuda`` on a machine with no GPU fails before
    the command does anything; it does not carry on on the CPU."""
    import torch

    monkeypatch.chdir(workspaces[TORCH])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = _rows(workspaces[TORCH] / "ws" / "catalog.db")
    capsys.readouterr()
    assert torch_main(argv) == 2
    assert "no CUDA GPU" in capsys.readouterr().err
    assert _rows(workspaces[TORCH] / "ws" / "catalog.db") == before


@pytest.mark.parametrize("argv,item", [
    (["train", "--db", "ws", "--out", "p.npz", "--mesh", "--epochs", "2", "--hidden", "32",
      "--layers", "1"], "item 6b"),
    (["data", "upload", "--db", "ws", "--ingestor", "local"], "item 7"),
    (["data", "download", "--db", "ws3", "--ingestor", "local"], "item 7"),
    (["show", "dumps", "--ingestor", "local"], "item 7"),
], ids=["train", "upload", "download", "show-dumps"])
def test_refused_commands_name_their_item(workspaces, capsys, monkeypatch, tmp_path, argv, item):
    """The commands that ROADMAP.md items 6b and 7 once kept out of the port
    now run: ``train --mesh`` trains over a (dp, tp) mesh of ``--device``
    and writes weights the JAX loader reads; the hub actions do what the
    JAX CLI's do against one stand-in ``huggingface_hub`` (``hub_stub.py``):
    the same calls, output lines and restored workspace."""
    import sys

    from hub_stub import StubHub

    monkeypatch.delenv("HF_TOKEN", raising=False)
    if argv[0] == "train":
        from autorag_research_tpu.embeddings.jax_encoder import load_params
        from autorag_research_tpu.models.encoder import EncoderConfig, RetrievalEncoder

        monkeypatch.chdir(workspaces[TORCH])
        capsys.readouterr()
        assert MAINS[TORCH](argv) == 0
        assert "saved params to p.npz" in capsys.readouterr().out
        template = RetrievalEncoder(EncoderConfig(hidden=32, layers=1, out_dim=16)).init(0)
        load_params(template, workspaces[TORCH] / "p.npz")
        return
    outs, calls = {}, {}
    for pkg, root in workspaces.items():
        hub = StubHub(tmp_path / f"hub_{pkg}")
        monkeypatch.setitem(sys.modules, "huggingface_hub", hub.module())
        monkeypatch.chdir(root)
        with tarfile.open(tmp_path / f"{pkg}.tar.gz", "w:gz") as tar:
            tar.add(root / "ws", arcname="ws")
        hub.put("autorag-research-tpu/local-dumps", tmp_path / f"{pkg}.tar.gz", "ws3.dump.tar.gz")
        capsys.readouterr()
        assert MAINS[pkg](argv) == 0
        # a download restores from a temporary directory of its own
        outs[pkg] = re.sub(r"\S*/(\S+\.dump\.tar\.gz)", r"<dir>/\1", capsys.readouterr().out)
        calls[pkg] = hub.calls
    assert outs[TORCH] == outs[JAX] and calls[TORCH] == calls[JAX] and calls[JAX]
    if argv[1] == "download":
        assert _rows(workspaces[TORCH] / "ws3" / "catalog.db") == _rows(
            workspaces[TORCH] / "ws" / "catalog.db")
    if argv[1] == "upload":
        assert (tmp_path / f"hub_{TORCH}" / "autorag-research-tpu/local-dumps/ws.dump.tar.gz").exists()
    if argv[0] == "show":
        assert outs[TORCH].split() == ["local", "ws3.dump.tar.gz"]


@pytest.mark.parametrize("model", ["bi", "cross", "lm"])
def test_cli_train_command(tmp_path, capsys, model):
    """``tests/test_cli.py::test_cli_train_command`` on the port, plus
    ``--model lm``: the same arguments, printed lines and output file, and
    the ``.npz`` gives the JAX package's loaders (``load_params``,
    ``JaxCrossEncoderReranker(params_path=)``, ``JaxLM(checkpoint=)``) the
    outputs that the port's wrappers give on it (within 1e-5)."""
    from autorag_research_tpu_torch.store.catalog import Catalog
    from autorag_research_tpu_torch.store.gt import or_all

    ws = tmp_path / "trainws"
    ws.mkdir()
    cat = Catalog(ws / "catalog.db")
    docs = [f"topic {chr(97 + i)} text" for i in range(6)]
    cat.add_chunks([{"id": i, "contents": d} for i, d in enumerate(docs)])
    cat.add_queries([{"id": i, "contents": f"find {chr(97 + i)}", "generation_gt": [docs[i]]}
                     for i in range(6)])
    for i in range(6):
        cat.add_retrieval_gt(i, or_all([i]))
    cat.close()

    out = tmp_path / f"{model}.npz"
    extra = ["--seq-len", "64"] if model == "lm" else []
    rc = MAINS[TORCH]([
        "train", "--db", str(ws), "--model", model, "--out", str(out), "--epochs", "3",
        "--batch-size", "6", "--hidden", "32", "--layers", "1", *extra,
    ])
    assert rc == 0 and out.exists()
    captured = capsys.readouterr().out
    assert "trained" in captured and "saved params" in captured

    texts = ["find a", "topic b text", ""]
    if model == "bi":
        from autorag_research_tpu.embeddings.jax_encoder import JaxEncoderEmbedding, load_params
        from autorag_research_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
        from autorag_research_tpu_torch.embeddings.torch_encoder import TorchEncoderEmbedding
        from autorag_research_tpu_torch.models.encoder import EncoderConfig

        jemb = JaxEncoderEmbedding(JaxEncoderConfig(hidden=32, out_dim=16, layers=1))
        jemb.params = load_params(jemb.params, out)
        temb = TorchEncoderEmbedding(EncoderConfig(hidden=32, out_dim=16, layers=1),
                                     params_path=out, device="cpu")
        np.testing.assert_allclose(temb.embed_texts(texts), jemb.embed_texts(texts), atol=1e-5)
    elif model == "cross":
        from autorag_research_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
        from autorag_research_tpu.rerankers.jax_cross import JaxCrossEncoderReranker
        from autorag_research_tpu_torch.models.encoder import EncoderConfig
        from autorag_research_tpu_torch.rerankers.torch_cross import TorchCrossEncoderReranker

        jr = JaxCrossEncoderReranker(JaxEncoderConfig(hidden=32, out_dim=16, layers=1),
                                     params_path=out)
        tr = TorchCrossEncoderReranker(EncoderConfig(hidden=32, out_dim=16, layers=1),
                                       params_path=out, device="cpu")
        ref = [(r.index, r.score) for r in jr.rerank("find a", texts)]
        got = [(r.index, r.score) for r in tr.rerank("find a", texts)]
        assert [i for i, _ in got] == [i for i, _ in ref]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], atol=1e-5)
    else:
        from autorag_research_tpu.llm.jax_lm import JaxLM
        from autorag_research_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
        from autorag_research_tpu_torch.llm.torch_lm import TorchLM
        from autorag_research_tpu_torch.models.decoder import DecoderConfig

        kw = dict(max_prompt_len=48, max_new_tokens=8, checkpoint=str(out))
        jlm = JaxLM(JaxDecoderConfig(hidden=32, layers=1), **kw)
        tlm = TorchLM(DecoderConfig(hidden=32, layers=1), device="cpu", **kw)
        ids, mask = _mod(JAX, "models.decoder").byte_tokenize(texts, 48)
        ref = np.asarray(jlm.decoder(jlm.params, ids, mask))
        with torch.no_grad():
            got = tlm.decoder(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_python_dash_m_entry(tmp_path):
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-m", "autorag_research_tpu_torch.cli", "--help"],
                         cwd=repo, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and "--device" in out.stdout


class TestInjection:
    def test_builtin_and_yaml(self, tmp_path):
        reg_t = _mod(TORCH, "injection").ModelRegistry
        (tmp_path / "embedding").mkdir()
        (tmp_path / "embedding" / "small.yaml").write_text(yaml.dump({"type": "mock", "dim": 8}))
        reg = reg_t(tmp_path, device="cpu")
        emb = reg.load_embedding("small")
        assert emb.dim == 8
        assert reg.load_embedding("small") is emb  # cached
        jemb = _mod(JAX, "injection").ModelRegistry(tmp_path).load_embedding("small")
        assert emb.embed_texts(["a b"]).tobytes() == jemb.embed_texts(["a b"]).tobytes()

    def test_nested_model_resolution_refused(self, tmp_path):
        """Nested model names resolve through the registry (refused until the
        rerankers were ported): ``llm_listwise``'s ``llm: mock`` is the
        registry's own cached ``mock`` LLM, as in the JAX registry."""
        (tmp_path / "reranker").mkdir()
        (tmp_path / "reranker" / "lw.yaml").write_text(
            yaml.dump({"type": "llm_listwise", "llm": "mock"}))
        reg = _mod(TORCH, "injection").ModelRegistry(tmp_path, device="cpu")
        rr = reg.load_reranker("lw")
        assert type(rr).__module__ == f"{TORCH}.rerankers.llm"
        assert rr.llm is reg.load_llm("mock")
        jrr = _mod(JAX, "injection").ModelRegistry(tmp_path).load_reranker("lw")
        assert [(r.index, r.score) for r in rr.rerank("q", ["a", "b", "c"])] == \
            [(r.index, r.score) for r in jrr.rerank("q", ["a", "b", "c"])]

    def test_unknown_raises(self):
        with pytest.raises(_mod(TORCH, "exceptions").ModelLoadError, match="unknown llm"):
            _mod(TORCH, "injection").ModelRegistry().load_llm("nope")

    @pytest.mark.parametrize("kind,name,item", [
        ("llm", "mock", "builds"), ("llm", "openai", "builds remote"),
        ("llm", "jax_lm", "'torch_lm'"),
        ("embedding", "openai", "builds remote"), ("embedding", "colpali", "builds remote"),
        ("embedding", "infinity", "builds remote"), ("embedding", "jax_encoder", "torch_encoder"),
        ("reranker", "mock", "builds"), ("reranker", "colbert", "builds"),
        ("reranker", "jax_cross_encoder", "'torch_cross_encoder'"),
    ])
    def test_deferred_kinds_name_their_item(self, kind, name, item):
        reg = _mod(TORCH, "injection").ModelRegistry(device="cpu")
        if item == "builds":  # ported since: it loads as the JAX package's does
            model = getattr(reg, f"load_{kind}")(name)
            assert type(model).__module__.startswith(TORCH)
            return
        if item == "builds remote":  # ported since; its health check would call a
            # remote endpoint or need a checkpoint, so it is built without one
            reg = _mod(TORCH, "injection").ModelRegistry(device="cpu", health_check=False)
            model = getattr(reg, f"load_{kind}")(name)
            assert type(model).__module__.startswith(TORCH)
            assert name not in _mod(TORCH, "injection").DEFERRED[kind]
            return
        with pytest.raises(_mod(TORCH, "exceptions").ModelLoadError, match=item):
            getattr(reg, f"load_{kind}")(name)

    @pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
    def test_torch_encoder_on_registry_device_matches_jax(self, tmp_path, multi):
        """``torch_encoder`` on the registry's device, carried JAX weights:
        within 1e-5 of ``jax_encoder``; ``multi_vector: true`` gives the
        token-level class."""
        from autorag_research_tpu.embeddings.jax_encoder import save_params
        from autorag_research_tpu.models import encoder as jenc
        from autorag_research_tpu_torch.embeddings.torch_encoder import (
            TorchEncoderEmbedding,
            TorchEncoderMultiVectorEmbedding,
        )

        params = tmp_path / "enc.npz"
        save_params(jenc.RetrievalEncoder(jenc.EncoderConfig(multi_vector=multi, **SMALL)).init(5),
                    params)
        (tmp_path / "embedding").mkdir()
        for t in ("jax_encoder", "torch_encoder"):
            (tmp_path / "embedding" / f"{t}.yaml").write_text(yaml.dump(
                {"type": t, "multi_vector": multi, "params_path": str(params), **SMALL}))
        temb = _mod(TORCH, "injection").ModelRegistry(tmp_path, device="cpu").load_embedding(
            "torch_encoder")
        jemb = _mod(JAX, "injection").ModelRegistry(tmp_path).load_embedding("jax_encoder")
        assert type(temb) is (TorchEncoderMultiVectorEmbedding if multi else TorchEncoderEmbedding)
        assert str(temb.device) == "cpu"
        texts = ["find the gpu", "a b c", ""]
        if multi:
            for a, b in zip(temb.embed_texts_multi(texts), jemb.embed_texts_multi(texts)):
                np.testing.assert_allclose(a, b, atol=1e-5)
        else:
            np.testing.assert_allclose(temb.embed_texts(texts), jemb.embed_texts(texts), atol=1e-5)

    def test_default_device_is_cuda(self):
        assert _mod(TORCH, "injection").ModelRegistry().device == "cuda"


class TestReporting:
    def test_borda(self, workspaces, monkeypatch):
        frames = {}
        for pkg, root in workspaces.items():
            monkeypatch.chdir(root)
            assert MAINS[pkg](["run", "--db", "ws"]) == 0
            service = _mod(pkg, "reporting.service").ReportingService([root / "ws"])
            lb = service.leaderboard()
            assert set(lb.pipeline) == {"vector_search", "bm25", "hybrid_rrf"}
            borda = service.borda_ranking()
            assert borda.iloc[0].borda_points >= borda.iloc[-1].borda_points
            cross = service.cross_dataset("recall")
            assert "ws" in cross.columns
            frames[pkg] = (lb, borda, cross, service.summary())
        for a, b in zip(frames[TORCH], frames[JAX]):
            assert a.equals(b)

    def test_html_and_live_ui(self, workspaces, monkeypatch):
        import urllib.request

        monkeypatch.chdir(workspaces[TORCH])
        assert MAINS[TORCH](["run", "--db", "ws"]) == 0
        ui = _mod(TORCH, "reporting.ui").serve_report([workspaces[TORCH] / "ws"], port=0)
        try:
            with urllib.request.urlopen(ui.url, timeout=10) as resp:
                page = resp.read().decode()
        finally:
            ui.shutdown()
        service = _mod(TORCH, "reporting.service").ReportingService([workspaces[TORCH] / "ws"])
        assert page == _mod(TORCH, "reporting.html").render_html(service)
        assert "hybrid_rrf" in page


class TestPlugins:
    def test_scaffold(self, tmp_path):
        import sys

        root = _mod(TORCH, "plugin_registry").create_plugin_scaffold("my_torch_plugin", tmp_path)
        assert (root / "pyproject.toml").exists()
        assert "autorag_research_tpu_torch.pipelines" in (root / "pyproject.toml").read_text()
        assert (root / "my_torch_plugin" / "configs" / "pipelines" / "retrieval"
                / "my_torch_plugin.yaml").exists()
        sys.path.insert(0, str(root))
        try:
            importlib.import_module("my_torch_plugin.pipeline")
            registry = _mod(TORCH, "config").BasePipelineConfig.registry
            assert "my_torch_plugin" in registry
            assert "my_torch_plugin" not in _mod(JAX, "config").BasePipelineConfig.registry
        finally:
            sys.path.remove(str(root))
            registry.pop("my_torch_plugin", None)

    def test_register_metric(self):
        from autorag_research_tpu_torch.evaluation.metrics.retrieval import RETRIEVAL_METRICS

        plugins = _mod(TORCH, "plugin_registry")
        plugins.register_metric("always_one", "retrieval", lambda inputs: [1.0] * len(inputs))
        try:
            assert "always_one" in RETRIEVAL_METRICS
        finally:
            del RETRIEVAL_METRICS["always_one"]
        from autorag_research_tpu_torch.evaluation.metrics.generation import GENERATION_METRICS

        plugins.register_metric("always_two", "generation", lambda inputs: [2.0])
        try:
            assert "always_two" in GENERATION_METRICS
        finally:
            del GENERATION_METRICS["always_two"]

    def test_sync_and_cli(self, tmp_path, capsys, monkeypatch):
        monkeypatch.chdir(tmp_path)
        assert torch_main(["plugin", "create", "--name", "cli_plugin", "--dir", "."]) == 0
        assert (tmp_path / "cli_plugin" / "pyproject.toml").exists()
        assert torch_main(["plugin", "sync"]) == 0  # no installed plugin: nothing to copy
        assert "no plugin configs" in capsys.readouterr().out


class TestConfigResolver:
    def test_experiment_with_wrapper_deps(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        torch_main(["init"])
        resolver = _mod(TORCH, "cli.config_resolver").ConfigResolver(tmp_path / "configs")
        config = resolver.load_experiment()
        names = [p.name for p in config.pipelines]
        assert names == ["vector_search", "bm25", "hybrid_rrf"]
        assert all(type(p).__module__.startswith(TORCH) for p in config.pipelines)
        assert config.extra_pipeline_configs == {}
        m = resolver.resolve_metric("retrieval", "mrr")
        assert m.name == "mrr"

    def test_transitive_dependency_resolved(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        torch_main(["init"])
        (tmp_path / "configs" / "experiment.yaml").write_text(yaml.safe_dump(
            {"pipelines": {"retrieval": ["hybrid_cc"]}, "metrics": {"retrieval": ["recall"]}}))
        config = _mod(TORCH, "cli.config_resolver").ConfigResolver(
            tmp_path / "configs").load_experiment()
        assert sorted(config.extra_pipeline_configs) == ["bm25", "vector_search"]


def test_every_template_pipeline_config_resolves_or_names_its_item(tmp_path, monkeypatch):
    """Every shipped pipeline YAML resolves to the port's typed config, of
    the same class name and fields as the JAX package's from the same
    file: every retrieval pipeline and all 17 generation pipelines (the
    refusal naming a ROADMAP.md item went with the last of them)."""
    monkeypatch.chdir(tmp_path)
    torch_main(["init"])
    resolver = _mod(TORCH, "cli.config_resolver").ConfigResolver(tmp_path / "configs")
    jresolver = _mod(JAX, "cli.config_resolver").ConfigResolver(tmp_path / "configs")
    assert not hasattr(_mod(TORCH, "cli.config_resolver"), "UNPORTED_PIPELINES")
    resolved = 0
    for kind in ("retrieval", "generation"):
        names = resolver.all_pipeline_names(kind)
        assert names, kind
        for name in names:
            ref = jresolver.resolve_pipeline(kind, name)
            config = resolver.resolve_pipeline(kind, name)
            assert config.name == ref.name == name and config.kind == ref.kind == kind
            assert type(config).__name__ == type(ref).__name__, name
            assert config.config_type == ref.config_type, name
            resolved += 1
    # the dense, MaxSim, BM25 and hybrid presets, the six wrappers, heaven
    # and the 17 generation pipelines
    assert resolved >= 35


GENERATION_TEMPLATES = (
    "basic_rag", "ircot", "search_r1", "self_rag", "adaptive_rag", "deep_rag", "dynamic_rag",
    "et2rag", "spd_rag", "main_rag", "rag_critic", "interact_rag", "hybrid_deep_searcher", "ras",
    "autothinkrag", "question_decomposition_gen", "visrag_gen",
)


@pytest.mark.parametrize("name", GENERATION_TEMPLATES)
def test_init_tree_resolves_every_generation_name(tmp_path, monkeypatch, name):
    """``init``'s tree names 17 generation pipelines; each resolves in the
    port to a config equal field by field to the JAX package's, and builds
    through an experiment that names it (its legs resolved with it)."""
    monkeypatch.chdir(tmp_path)
    torch_main(["init"])
    configs = tmp_path / "configs"
    assert sorted(_mod(TORCH, "cli.config_resolver").ConfigResolver(configs).all_pipeline_names(
        "generation")) == sorted(GENERATION_TEMPLATES)
    out = {}
    for pkg in (JAX, TORCH):
        resolver = _mod(pkg, "cli.config_resolver").ConfigResolver(configs)
        config = resolver.resolve_pipeline("generation", name)
        deps = resolver.resolve_transitive_dependencies([config])
        fields = {k: v for k, v in vars(config).items() if isinstance(v, (str, int, float, type(None)))}
        out[pkg] = (type(config).__name__, config.config_type, fields, sorted(deps))
    assert out[TORCH] == out[JAX]
    assert out[TORCH][3], name  # every generation template names its leg


@pytest.mark.parametrize("pkg", [JAX, TORCH])
def test_unknown_pipeline_type_refused_as_from_dict(tmp_path, pkg):
    """An unknown ``type`` is refused by ``BasePipelineConfig.from_dict`` in
    both packages, with its message (known types listed)."""
    path = tmp_path / "pipelines" / "generation" / "nope.yaml"
    path.parent.mkdir(parents=True)
    path.write_text("type: not_a_pipeline\nllm: mock\n")
    resolver = _mod(pkg, "cli.config_resolver").ConfigResolver(tmp_path)
    with pytest.raises(KeyError) as got:
        resolver.resolve_pipeline("generation", "nope")
    with pytest.raises(KeyError) as ref:
        _mod(pkg, "config").BasePipelineConfig.from_dict({"type": "not_a_pipeline", "llm": "mock",
                                                          "name": "nope"})
    assert str(got.value) == str(ref.value)
    assert "unknown pipeline type 'not_a_pipeline'" in str(got.value)
    assert "ircot" in str(got.value) and "rag_critic" in str(got.value)


def test_every_model_preset_type_is_registered_or_deferred():
    from autorag_research_tpu_torch.cli.templates import DEFAULT_CONFIGS
    from autorag_research_tpu_torch.injection import _FACTORIES, DEFERRED

    checked = 0
    for rel, content in DEFAULT_CONFIGS.items():
        kind = rel.split("/", 1)[0]
        if kind not in ("llm", "embedding", "reranker"):
            continue
        t = yaml.safe_load(content)["type"]
        assert t in _FACTORIES[kind] or t in DEFERRED[kind], f"{rel}: type '{t}'"
        checked += 1
    assert checked >= 30


class TestIndexArtifacts:
    def test_artifact_persist_and_reload(self, workspaces):
        registry = _mod(TORCH, "index.registry")
        DenseIndex = _mod(TORCH, "index.dense").DenseIndex
        cat = _mod(TORCH, "store.catalog").Catalog(workspaces[TORCH] / "ws" / "catalog.db")
        idx = registry.get_or_build(cat, "dense", "chunk", device="cpu",
                                    builder=lambda: DenseIndex.from_catalog(cat, device="cpu"))
        assert (workspaces[TORCH] / "ws" / "indexes" / "dense_chunk" / "fingerprint.json").exists()
        registry.invalidate()

        def explode():
            raise AssertionError("builder should not be called; artifact present")

        idx2 = registry.get_or_build(cat, "dense", "chunk", builder=explode, device="cpu")
        assert idx2.ids == idx.ids
        cat.close()

    def test_artifact_stale_on_growth(self, workspaces):
        registry = _mod(TORCH, "index.registry")
        DenseIndex = _mod(TORCH, "index.dense").DenseIndex
        cat = _mod(TORCH, "store.catalog").Catalog(workspaces[TORCH] / "ws" / "catalog.db")
        registry.get_or_build(cat, "dense", "chunk", device="cpu",
                              builder=lambda: DenseIndex.from_catalog(cat, device="cpu"))
        registry.invalidate()
        emb = _mod(TORCH, "embeddings").MockEmbedding(dim=64)
        cat.add_chunks([{"id": 999, "contents": "new doc", "embedding": emb.embed_query("new doc")}])
        built = []
        idx = registry.get_or_build(
            cat, "dense", "chunk", device="cpu",
            builder=lambda: (built.append(1), DenseIndex.from_catalog(cat, device="cpu"))[1],
        )
        assert built == [1]  # stale artifact rebuilt
        assert 999 in idx.ids
        cat.close()

    def test_concurrent_misses_build_once(self, workspaces):
        """Eight threads miss the cache at once: one build, one index."""
        import sys
        import threading

        registry = _mod(TORCH, "index.registry")
        cat = _mod(TORCH, "store.catalog").Catalog(workspaces[TORCH] / "ws" / "catalog.db")
        calls, got = [], []
        start = threading.Barrier(8)

        def builder():
            calls.append(1)
            return object()

        def worker():
            start.wait(timeout=10)
            got.append(registry.get_or_build(cat, "probe", "chunk", builder=builder,
                                             persist=False, device="cpu"))

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert len(calls) == 1 and len(got) == 8 and all(g is got[0] for g in got)
        cat.close()
