"""The port's rerankers (``rerankers/*``) and ``utils/text.py`` against the
JAX package's, case by case with ``tests/test_wrapper_pipelines.py``'s
reranker cases, ``tests/test_cross_encoder.py``'s format-specific ones and
``tests/test_utils.py``'s text helpers.

Host rerankers (mock, embedding similarity, ColBERT, the listwise LLM) give
equal results: indices, texts and scores. The HF rerankers run tiny random
checkpoints built offline (``tests/tiny_models.py``) on the CPU in both
packages: indices equal, scores within 1e-6 absolute (the same PyTorch
model; only batch placement differs). The API rerankers post to a local mock
server: the request bodies, headers and parsed results are equal.
"""

import importlib
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)
HF_TOL = 1e-6
TEXTS = ["the capital of france is paris", "cats sit on mats", "a city in europe",
         "quantum flux capacitors", "", "paris paris paris"]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def as_tuples(results):
    return [(r.index, r.text, r.score) for r in results]


def both(fn):
    """``fn(pkg)`` for each package: (port, JAX)."""
    return fn(TORCH), fn(JAX)


# ------------------------------------------------------------ base._finalize


@pytest.mark.parametrize("scored,top_k", [
    ([(0, "a", 1.0), (1, "b", 1.0), (2, "c", 2.0)], None),
    ([(3, "d", 0.5), (1, "b", 0.5), (2, "c", 0.5), (0, "a", 0.5)], 2),
    ([(0, "a", -1.0), (1, "b", float("inf")), (2, "c", -1.0)], 5),
    ([], 3),
])
def test_finalize_orders_by_score_then_index(scored, top_k):
    got, ref = both(lambda pkg: _mod(pkg, "rerankers.base").BaseReranker._finalize(
        list(scored), top_k))
    assert as_tuples(got) == as_tuples(ref)
    keys = [(-r.score, r.index) for r in got]
    assert keys == sorted(keys)


def test_arerank_batch_matches_sequential():
    from autorag_research_tpu_torch.rerankers import MockReranker
    from autorag_research_tpu_torch.utils.concurrency import run_async

    rr = MockReranker()
    queries = ["paris capital", "cats", "europe city"]
    batched = run_async(rr.arerank_batch(queries, [TEXTS] * 3, top_k=2, max_concurrency=2))
    assert [as_tuples(b) for b in batched] == [as_tuples(rr.rerank(q, TEXTS, 2)) for q in queries]


# ------------------------------------------------------------ host rerankers


@pytest.mark.parametrize("query", ["quick fox", "paris capital", "", "cats on mats"])
def test_mock_reranker(query):
    got, ref = both(lambda pkg: _mod(pkg, "rerankers").MockReranker().rerank(query, TEXTS))
    assert as_tuples(got) == as_tuples(ref)


@pytest.mark.parametrize("top_k", [None, 1, 3])
def test_embedding_similarity(top_k):
    def run(pkg):
        emb = _mod(pkg, "embeddings").MockEmbedding(dim=32)
        return _mod(pkg, "rerankers").EmbeddingSimilarityReranker(emb).rerank(
            "the capital of france is paris", TEXTS, top_k=top_k)

    got, ref = both(run)
    assert as_tuples(got) == as_tuples(ref)
    assert got[0].text == TEXTS[0] and got[0].score == pytest.approx(1.0, abs=1e-5)
    assert both(lambda pkg: _mod(pkg, "rerankers").EmbeddingSimilarityReranker(
        _mod(pkg, "embeddings").MockEmbedding()).rerank("q", [])) == ([], [])


@pytest.mark.parametrize("top_k", [None, 2])
def test_colbert_reranker(top_k):
    def run(pkg):
        emb = _mod(pkg, "embeddings").MockMultiVectorEmbedding(dim=32)
        return _mod(pkg, "rerankers.colbert").ColBERTReranker(emb).rerank(
            "quick fox", ["quick fox", "unrelated text entirely", "", "fox"], top_k=top_k)

    got, ref = both(run)
    assert as_tuples(got) == as_tuples(ref)
    assert got[0].text == "quick fox" and got[0].score == pytest.approx(1.0, abs=1e-5)


def test_colbert_over_the_token_level_encoder_matches_jax():
    """ColBERT over each package's token-level encoder on carried weights:
    equal order, scores within 1e-5."""
    from autorag_research_tpu.embeddings.jax_encoder import (
        JaxEncoderMultiVectorEmbedding,
        _flatten_params,
    )
    from autorag_research_tpu.models.encoder import EncoderConfig as JCfg
    from autorag_research_tpu_torch.embeddings.torch_encoder import TorchEncoderMultiVectorEmbedding
    from autorag_research_tpu_torch.models.encoder import EncoderConfig, from_jax_params

    small = dict(vocab_size=512, hidden=32, layers=2, heads=2, max_len=16, out_dim=16,
                 multi_vector=True)
    jemb = JaxEncoderMultiVectorEmbedding(JCfg(**small), seed=2)
    temb = TorchEncoderMultiVectorEmbedding(EncoderConfig(**small), device="cpu")
    temb.encoder.load_state_dict(from_jax_params(_flatten_params(jemb.params)))
    got = _mod(TORCH, "rerankers.colbert").ColBERTReranker(temb).rerank("capital of france", TEXTS)
    ref = _mod(JAX, "rerankers.colbert").ColBERTReranker(jemb).rerank("capital of france", TEXTS)
    assert [r.index for r in got] == [r.index for r in ref]
    np.testing.assert_allclose([r.score for r in got], [r.score for r in ref], rtol=0, atol=1e-5)


def test_registry_colbert_defaults_to_the_token_level_encoder(tmp_path):
    """A bare ``colbert`` builds over ``torch_encoder`` (``multi_vector``) on
    the registry's device; a YAML's ``embedding_model`` name resolves."""
    from autorag_research_tpu_torch.embeddings.torch_encoder import TorchEncoderMultiVectorEmbedding
    from autorag_research_tpu_torch.injection import ModelRegistry

    rr = ModelRegistry(device="cpu").load_reranker("colbert")
    assert isinstance(rr.embedding_model, TorchEncoderMultiVectorEmbedding)
    assert rr.embedding_model.device.type == "cpu"
    assert len(rr.rerank("capital", TEXTS, top_k=2)) == 2
    (tmp_path / "reranker").mkdir()
    (tmp_path / "reranker" / "cb.yaml").write_text("type: colbert\nembedding_model: mock_multi\n")
    named = ModelRegistry(tmp_path, device="cpu").load_reranker("cb")
    jnamed = _mod(JAX, "injection").ModelRegistry(tmp_path).load_reranker("cb")
    assert as_tuples(named.rerank("cats", TEXTS)) == as_tuples(jnamed.rerank("cats", TEXTS))


# ------------------------------------------------------------ listwise LLM


@pytest.mark.parametrize("reply,n", [("3 > 1 > 2", 3), ("2", 3), ("[2] > [9] > [2] > 0", 4),
                                     ("no numbers", 2), ("4 3 2 1 5", 5)])
def test_parse_ranking(reply, n):
    got, ref = both(lambda pkg: _mod(pkg, "rerankers").LLMListwiseReranker._parse_ranking(reply, n))
    assert got == ref and sorted(got) == list(range(n))


@pytest.mark.parametrize("reply,want", [("3 > 1 > 2", [2, 0, 1]), ("2", [1, 0, 2])])
def test_llm_listwise_one_window(reply, want):
    def run(pkg):
        llm = _mod(pkg, "llm").MockLLM(responder=lambda p: reply)
        return _mod(pkg, "rerankers").LLMListwiseReranker(llm).rerank("q", ["a", "b", "c"]), llm

    (got, llm), (ref, jllm) = both(run)
    assert as_tuples(got) == as_tuples(ref) and [r.index for r in got] == want
    assert llm.calls == jllm.calls


@pytest.mark.parametrize("n,window", [(10, 4), (9, 4), (30, 20), (5, 2)])
def test_llm_listwise_sliding_window(n, window):
    """RankGPT's pass from tail to head, stride window // 2: the same prompts
    in the same order, the same permutation; a strong tail candidate reaches
    the front and no prompt holds more than ``window`` passages."""
    def responder(p):
        nums = re.findall(r"\[(\d+)\] (\w+)", p)
        order = sorted(nums, key=lambda t: (t[1] != "best", -int(t[0])))
        return " > ".join(num for num, _ in order)

    texts = [f"doc{i}" for i in range(n - 1)] + ["best"]

    def run(pkg):
        llm = _mod(pkg, "llm").MockLLM(responder=responder)
        rr = _mod(pkg, "rerankers").LLMListwiseReranker(llm, window=window)
        return rr.rerank("q", texts), llm.calls

    (got, calls), (ref, jcalls) = both(run)
    assert as_tuples(got) == as_tuples(ref) and calls == jcalls
    assert got[0].text == "best" and sorted(r.index for r in got) == list(range(n))
    assert all(len(re.findall(r"\[\d+\]", p)) <= window for p in calls)


def test_llm_listwise_with_scripted_llm():
    """A ``ScriptedLLM`` answers the two windows of 6 passages at window 4."""
    def run(pkg):
        llm = _mod(pkg, "llm").ScriptedLLM(responses=["4 > 3", "1 > 2 > 4"])
        return _mod(pkg, "rerankers").LLMListwiseReranker(llm, window=4).rerank(
            "q", [f"t{i}" for i in range(6)], top_k=4)

    got, ref = both(run)
    assert as_tuples(got) == as_tuples(ref) and len(got) == 4


def test_registry_llm_listwise_resolves_its_nested_llm(tmp_path):
    (tmp_path / "reranker").mkdir()
    (tmp_path / "reranker" / "lw.yaml").write_text("type: llm_listwise\nllm: mock\nwindow: 3\n")
    got = _mod(TORCH, "injection").ModelRegistry(tmp_path, device="cpu").load_reranker("lw")
    ref = _mod(JAX, "injection").ModelRegistry(tmp_path).load_reranker("lw")
    assert type(got.llm).__module__ == f"{TORCH}.llm.base" and got.window == ref.window == 3
    assert as_tuples(got.rerank("q", TEXTS)) == as_tuples(ref.rerank("q", TEXTS))


# ------------------------------------------------------------ HF checkpoints


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    pytest.importorskip("transformers")
    from tiny_models import (
        build_causal_checkpoint,
        build_seq2seq_checkpoint,
        build_seqcls_checkpoint,
    )

    root = tmp_path_factory.mktemp("ckpt")
    return {
        "seqcls": build_seqcls_checkpoint(str(root / "cls")),
        "seqcls1": build_seqcls_checkpoint(str(root / "cls1"), num_labels=1),
        "seq2seq": build_seq2seq_checkpoint(str(root / "s2s")),
        "causal": build_causal_checkpoint(str(root / "gpt")),
    }


HF_CASES = [
    ("CrossEncoderReranker", "seqcls", {}),
    ("CrossEncoderReranker", "seqcls1", {"batch_size": 4}),
    ("MonoT5Reranker", "seq2seq", {"batch_size": 4}),
    ("UPRReranker", "seq2seq", {"batch_size": 2}),
    ("FlagLLMReranker", "causal", {"batch_size": 2}),
    ("TARTReranker", "seqcls", {"instruction": "retrieval question answer"}),
]


@pytest.mark.parametrize("cls,ckpt,kw", HF_CASES, ids=[f"{c}-{k}" for c, k, _ in HF_CASES])
def test_hf_rerankers_match_jax(checkpoints, cls, ckpt, kw):
    def run(pkg):
        extra = {"device": "cpu"} if pkg == TORCH else {}
        rr = getattr(_mod(pkg, "rerankers.hf"), cls)(checkpoints[ckpt], **kw, **extra)
        return rr.rerank("the capital of france", TEXTS), rr.rerank("cats", TEXTS, top_k=2)

    (got, got2), (ref, ref2) = both(run)
    for g, r in ((got, ref), (got2, ref2)):
        assert [x.index for x in g] == [x.index for x in r]
        np.testing.assert_allclose([x.score for x in g], [x.score for x in r], rtol=0, atol=HF_TOL)
    assert len(got) == len(TEXTS) and len(got2) == 2
    assert all(np.isfinite(x.score) for x in got)


@pytest.mark.parametrize("cls", ["CrossEncoderReranker", "MonoT5Reranker", "UPRReranker",
                                 "FlagLLMReranker", "TARTReranker"])
def test_hf_rerankers_ask_for_cuda_by_default(checkpoints, cls):
    """A torch-backed reranker on its default device raises where there is no
    GPU (after loading its checkpoint); it never scores on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    ckpt = {"MonoT5Reranker": "seq2seq", "UPRReranker": "seq2seq",
            "FlagLLMReranker": "causal"}.get(cls, "seqcls")
    rr = getattr(_mod(TORCH, "rerankers.hf"), cls)(checkpoints[ckpt])
    assert rr.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rr.rerank("q", ["a"])


@pytest.mark.parametrize("cls", ["CrossEncoderReranker", "MonoT5Reranker", "UPRReranker",
                                 "FlagLLMReranker", "TARTReranker"])
def test_hf_rerankers_without_checkpoint_raise_model_load_error(tmp_path, cls):
    for pkg in PKGS:
        rr = getattr(_mod(pkg, "rerankers.hf"), cls)(str(tmp_path / "missing"))
        with pytest.raises(_mod(pkg, "exceptions").ModelLoadError):
            rr.rerank("q", ["a"])


@pytest.mark.parametrize("cls,match", [("FlashRankReranker", "onnxruntime"),
                                       ("OpenVINOReranker", "optimum-intel")])
def test_runtime_rerankers_raise_cleanly(tmp_path, cls, match):
    for pkg in PKGS:
        with pytest.raises(_mod(pkg, "exceptions").ModelLoadError, match=match):
            getattr(_mod(pkg, "rerankers.hf"), cls)(str(tmp_path)).rerank("q", ["a"])


HF_KINDS = [("cross_encoder", {"checkpoint": "x"}), ("monot5", {}), ("upr", {}),
            ("flag_embedding", {}), ("koreranker", {}), ("sentence_transformer", {}),
            ("flag_embedding_llm", {}), ("tart", {}), ("flashrank", {}), ("openvino", {})]


@pytest.mark.parametrize("kind,spec", HF_KINDS, ids=[k for k, _ in HF_KINDS])
def test_registry_hf_kinds_as_jax(kind, spec):
    """Each HF kind builds the same class with the same default checkpoint as
    the JAX registry; the torch-backed ones take the registry's device."""
    got = _mod(TORCH, "injection").ModelRegistry(device="cpu")._instantiate(
        "reranker", {"type": kind, **spec})
    ref = _mod(JAX, "injection").ModelRegistry()._instantiate("reranker", {"type": kind, **spec})
    assert type(got).__name__ == type(ref).__name__ and got.checkpoint == ref.checkpoint
    assert type(got).__module__ == f"{TORCH}.rerankers.hf"
    assert getattr(got, "device", "cpu") == "cpu"


# ------------------------------------------------------------ HTTP APIs


@pytest.fixture(scope="module")
def rerank_server():
    requests = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            requests.append((self.path, body, self.headers["Authorization"]))
            if self.path == "/fail":
                self.send_response(500)
                self.end_headers()
                return
            docs = body.get("documents", body.get("input"))
            # Cohere / Jina / Voyage answer "results" with relevance_score,
            # Mixedbread "data" with score
            rows = [{"index": i, "relevance_score": 1.0 / (i + 1)} for i in range(len(docs))][::-1]
            if self.path == "/mixedbread":
                rows = [{"index": r["index"], "score": r["relevance_score"]} for r in rows]
                payload = {"data": rows}
            else:
                payload = {"results": rows}
            data = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", requests
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


API_CASES = [("CohereReranker", "documents", "top_n", "/cohere"),
             ("JinaReranker", "documents", "top_n", "/jina"),
             ("VoyageReranker", "documents", "top_k", "/voyage"),
             ("MixedbreadReranker", "input", "top_k", "/mixedbread")]


@pytest.mark.parametrize("cls,docs_key,topk_key,path", API_CASES, ids=[c[0] for c in API_CASES])
@pytest.mark.parametrize("top_k", [None, 2])
def test_api_rerankers_post_as_jax(rerank_server, cls, docs_key, topk_key, path, top_k):
    url, requests = rerank_server

    def run(pkg):
        rr = getattr(_mod(pkg, "rerankers.api"), cls)(api_key="k", timeout=10)
        rr.endpoint = url + path
        out = rr.rerank("q", ["a", "b", "c"], top_k=top_k)
        return out, requests[-1], rr.model_name

    (got, req, name), (ref, jreq, jname) = both(run)
    assert as_tuples(got) == as_tuples(ref) and req == jreq and name == jname
    _, body, auth = req
    assert body[docs_key] == ["a", "b", "c"] and body[topk_key] == (top_k or 3)
    assert auth == "Bearer k"
    assert [r.index for r in got] == [0, 1, 2][: top_k or 3]


def test_api_rerankers_gate_on_key_and_errors(rerank_server, monkeypatch):
    url, _ = rerank_server
    for pkg in PKGS:
        api = _mod(pkg, "rerankers.api")
        LLMError = _mod(pkg, "exceptions").LLMError
        monkeypatch.delenv("COHERE_API_KEY", raising=False)
        with pytest.raises(LLMError, match="no API key"):
            api.CohereReranker(api_key=None).rerank("q", ["a"])
        rr = api.JinaReranker(api_key="k", timeout=10)
        rr.endpoint = url + "/fail"
        with pytest.raises(LLMError, match="rerank call failed"):
            rr.rerank("q", ["a"])
        monkeypatch.setenv("VOYAGE_API_KEY", "env-key")
        assert api.VoyageReranker().api_key == "env-key"


@pytest.mark.parametrize("kind", ["cohere", "jina", "voyageai", "mixedbreadai"])
def test_registry_api_kinds_as_jax(kind):
    got = _mod(TORCH, "injection").ModelRegistry(device="cpu")._instantiate(
        "reranker", {"type": kind, "api_key": "k"})
    ref = _mod(JAX, "injection").ModelRegistry()._instantiate("reranker", {"type": kind, "api_key": "k"})
    assert (type(got).__name__, got.model, got.endpoint) == (type(ref).__name__, ref.model, ref.endpoint)


# ------------------------------------------------------------ utils/text.py


class _FakeTok:
    def encode(self, t):
        return t.split()

    def decode(self, ids):
        return " ".join(ids)


@pytest.mark.parametrize("text,max_tokens,tok", [
    ("word " * 1000, 10, None), ("short", 100, None), ("a" * 100, 5, None), ("", 3, None),
    ("café ☃ " * 20, 4, None), ("a b c d e", 3, _FakeTok()), ("a b", 3, _FakeTok()),
])
def test_truncate_text(text, max_tokens, tok):
    got, ref = both(lambda pkg: _mod(pkg, "utils.text").truncate_text(text, max_tokens, tok))
    assert got == ref
    assert both(lambda pkg: _mod(pkg, "utils.text").truncate_texts([text, "b"], max_tokens, tok)) \
        == ([got, "b"], [ref, "b"])


@pytest.mark.parametrize("value", [None, [1, 2], np.array([1, 2]), "x", (1, 2), {3}, 5, np.float32(1.5)])
def test_to_list(value):
    got, ref = both(lambda pkg: _mod(pkg, "utils.text").to_list(value))
    assert got == ref


@pytest.mark.parametrize("text", ["abcd" * 5, "", "a", "café"])
def test_approx_token_count(text):
    got, ref = both(lambda pkg: _mod(pkg, "utils.text").approx_token_count(text))
    assert got == ref


@pytest.mark.parametrize("targets", [None, ["yes"], ["no"], ["YES", "."]])
def test_extract_token_logprobs(targets):
    def run(pkg):
        res = _mod(pkg, "llm.base").LLMResult(
            text="Yes", logprobs=[{"token": "Yes", "logprob": -0.1}, {"token": ".", "logprob": -2.0},
                                  {"token": " ", "logprob": -3.0}, {"logprob": -1.0}])
        return (_mod(pkg, "utils.text").extract_token_logprobs(res, targets),
                _mod(pkg, "utils.text").extract_token_logprobs(
                    _mod(pkg, "llm.base").LLMResult(text="x")))

    got, ref = both(run)
    assert got == ref and got[1] is None
