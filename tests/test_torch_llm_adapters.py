"""The port's remote model clients against the JAX package's.

Mirrors ``tests/test_llm_adapters.py``: every client talks to a local stub
server (``127.0.0.1``, no other host) or to an injected transport, and each
case runs through both packages. The requests each package sends (path,
JSON body, the headers that carry the dialect) and the results it parses
(text, token usage, logprobs, metadata, embedding matrices) must be equal;
the error shapes raise each package's ``LLMError`` / ``ModelLoadError``.
``sign_v4`` gives AWS's published IAM ListUsers signature in both packages
and equal signatures on a fixed date. The model registry builds every remote
kind of the JAX registry with the same settings (no health check: that would
call the remote endpoint).
"""

import base64
import importlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _run(coro):
    return _mod(TORCH, "utils.concurrency").run_async(coro)


def _result(res):
    return (res.text, res.token_usage, res.logprobs, res.metadata)


def _chat_payload(body):
    content = body["messages"][0]["content"]
    text = content if isinstance(content, str) else f"multimodal x{len(content) - 1}"
    return {
        "choices": [{
            "message": {"content": f"echo: {text}"},
            "finish_reason": "stop",
            "logprobs": {"content": [{"token": "echo", "logprob": -0.25}]}
            if body.get("logprobs") else None,
        }],
        "usage": {"prompt_tokens": 7, "completion_tokens": 3, "total_tokens": 10},
    }


def _embedding_payload(path, body):
    inputs = body["input"]
    if path.startswith("/infm/"):  # token-level: a [T, 3] matrix an input
        return {"data": [{"embedding": [[float(len(t)), float(j), 1.0] for j in range(2 + i % 2)]}
                         for i, t in enumerate(inputs)]}
    rows = [{"index": i, "embedding": [float(len(t)), float(i), 0.5]}
            for i, t in enumerate(inputs)]
    return {"data": rows[::-1]}  # out of order: 'index' is authoritative


@pytest.fixture(scope="module")
def stub():
    requests = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            raw = self.rfile.read(int(self.headers["Content-Length"]))
            body = json.loads(raw)
            requests.append((self.path, body, dict(self.headers)))
            if self.path.endswith("/chat/completions") or "/chat/completions?" in self.path:
                payload = _chat_payload(body)
            elif self.path.endswith("/embeddings"):
                payload = _embedding_payload(self.path, body)
            elif self.path == "/v1/messages":
                payload = {"type": "message", "content": [{"type": "text", "text": "hi"}],
                           "usage": {"input_tokens": 4, "output_tokens": 2},
                           "stop_reason": "end_turn"}
            elif self.path.endswith(":generateContent"):
                payload = {"candidates": [{"content": {"parts": [{"text": "gem"}]},
                                           "finishReason": "STOP"}],
                           "usageMetadata": {"promptTokenCount": 3, "candidatesTokenCount": 1,
                                             "totalTokenCount": 4}}
            elif self.path.endswith("/converse"):
                payload = {"output": {"message": {"content": [{"text": "br"}]}},
                           "usage": {"inputTokens": 5, "outputTokens": 1},
                           "stopReason": "end_turn"}
            else:
                self.send_response(404)
                self.end_headers()
                return
            data = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}", requests
    server.shutdown()


def _sent(requests, headers=("Content-Type", "Authorization", "api-key", "x-api-key",
                             "anthropic-version", "x-goog-api-key")):
    path, body, hdrs = requests[-1]
    hdrs = {k.lower(): v for k, v in hdrs.items()}  # urllib capitalizes names
    return path, body, {h: hdrs.get(h.lower()) for h in headers}


def _both(stub, make, call):
    """(result, request) of each package: equal between them."""
    url, requests = stub
    out = []
    for pkg in PKGS:
        client = make(pkg, url)
        out.append((call(client), _sent(requests)))
    assert out[1] == out[0]
    return out[1]


@pytest.mark.parametrize("kw,call_kw", [
    ({}, {}),
    ({"logprobs": True, "max_tokens": None}, {"max_tokens": 256}),
    ({"temperature": 0.5, "extra_body": {"top_p": 0.9}}, {"temperature": 0.1}),
])
def test_openai_compat_generate_equal(stub, kw, call_kw):
    (res, (path, body, hdrs)) = _both(
        stub,
        lambda pkg, url: _mod(pkg, "llm.openai_compat").OpenAICompatLLM(
            model="m", base_url=f"{url}/v1", api_key="k", **kw),
        lambda llm: _result(llm.generate("hello world", **call_kw)),
    )
    assert res[0] == "echo: hello world" and res[1]["total_tokens"] == 10
    assert path == "/v1/chat/completions" and hdrs["Authorization"] == "Bearer k"
    if kw.get("logprobs"):
        assert res[2] == [{"token": "echo", "logprob": -0.25}] and body["max_tokens"] == 256


@pytest.mark.parametrize("n_images", [1, 3])
def test_openai_compat_vision_payload_equal(stub, n_images):
    images = [bytes([i]) * (5 + i) for i in range(n_images)]
    (res, (_, body, _)) = _both(
        stub,
        lambda pkg, url: _mod(pkg, "llm.openai_compat").OpenAICompatLLM(base_url=f"{url}/v1",
                                                                         api_key="k"),
        lambda llm: _result(_run(llm.agenerate("describe", images=images))),
    )
    assert res[0] == f"echo: multimodal x{n_images}"
    content = body["messages"][0]["content"]
    assert content[0] == {"type": "text", "text": "describe"}
    assert [c["image_url"]["url"] for c in content[1:]] == [
        "data:image/png;base64," + base64.b64encode(b).decode() for b in images]


def test_azure_openai_dialect_equal(stub):
    (res, (path, _, hdrs)) = _both(
        stub,
        lambda pkg, url: _mod(pkg, "llm.openai_compat").AzureOpenAILLM(
            deployment="dep", base_url=url, api_version="2024-06-01", api_key="az"),
        lambda llm: (_result(llm.generate("hi")), llm._endpoint(), llm._headers()),
    )
    assert path == "/openai/deployments/dep/chat/completions?api-version=2024-06-01"
    assert hdrs["api-key"] == "az" and hdrs["Authorization"] is None


@pytest.mark.parametrize("payload,match", [
    ({"error": {"message": "overloaded"}}, "no choices"),
    ({"choices": []}, "no choices"),
])
def test_openai_compat_error_bodies_equal(payload, match):
    msgs = []
    for pkg in PKGS:
        llm = _mod(pkg, "llm.openai_compat").OpenAICompatLLM(model="m", api_key="k")
        with pytest.raises(_mod(pkg, "exceptions").LLMError, match=match) as exc:
            llm._parse(payload)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_connection_errors_raise_in_both():
    for pkg in PKGS:
        llm = _mod(pkg, "llm.openai_compat").OpenAICompatLLM(
            base_url="http://127.0.0.1:1/v1", api_key="k", timeout=0.5)
        with pytest.raises(_mod(pkg, "exceptions").LLMError):
            llm.generate("x")
        inf = _mod(pkg, "embeddings.infinity").InfinityEmbedding(
            base_url="http://127.0.0.1:1", timeout=0.3)
        with pytest.raises(_mod(pkg, "exceptions").ModelLoadError):
            inf.embed_texts(["x"])


@pytest.mark.parametrize("images", [None, [b"\x89PNGa", b"\x89PNGbb"]])
def test_providers_over_http_equal(stub, images):
    """Each provider's default urllib transport against the local stub."""
    cases = {
        "AnthropicLLM": ("", dict(model="claude", api_key="ak", system="be brief")),
        "GeminiLLM": ("/v1beta", dict(model="gemini-2.0-flash", api_key="gk", max_tokens=64)),
        "BedrockLLM": ("", dict(model_id="anthropic.claude-v1:0", region_name="eu-west-1",
                                access_key="AKID", secret_key="s", session_token="tok")),
    }
    for cls, (suffix, kw) in cases.items():
        (res, (path, body, hdrs)) = _both(
            stub,
            lambda pkg, url: getattr(_mod(pkg, "llm.providers"), cls)(base_url=url + suffix, **kw),
            lambda llm: _result(_run(llm.agenerate("caption", images=images))),
        )
        assert res[0] in ("hi", "gem", "br"), cls
        if cls == "BedrockLLM":
            assert path == "/model/anthropic.claude-v1%3A0/converse"
            assert body["messages"][0]["content"][-1] == {"text": "caption"}
        if images and cls == "AnthropicLLM":
            assert [c["source"]["data"] for c in body["messages"][0]["content"][:-1]] == [
                base64.b64encode(b).decode() for b in images]


@pytest.mark.parametrize("cls,kw,payload", [
    ("AnthropicLLM", {"api_key": "k"}, {"type": "error", "error": {"type": "invalid_request"}}),
    ("GeminiLLM", {"api_key": "k"}, {"candidates": []}),
    ("GeminiLLM", {"api_key": "k"}, {"error": {"code": 400}}),
    ("BedrockLLM", {"access_key": "a", "secret_key": "s"}, {"message": "invalid model"}),
])
def test_provider_error_shapes_equal(cls, kw, payload):
    msgs = []
    for pkg in PKGS:
        llm = getattr(_mod(pkg, "llm.providers"), cls)(transport=lambda u, b, h, t: payload, **kw)
        with pytest.raises(_mod(pkg, "exceptions").LLMError) as exc:
            llm.generate("x")
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_sigv4_published_vector_in_both():
    """AWS's documented IAM ListUsers example (sigv4-create-signed-request)."""
    for pkg in PKGS:
        h = _mod(pkg, "llm.providers").sign_v4(
            "GET", "iam.amazonaws.com", "/", {"Action": "ListUsers", "Version": "2010-05-08"},
            {"content-type": "application/x-www-form-urlencoded; charset=utf-8"}, b"",
            "us-east-1", "iam", "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
            amz_date="20150830T123600Z", sign_payload_header=False,
        )
        assert h["Authorization"] == (
            "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20150830/us-east-1/iam/"
            "aws4_request, SignedHeaders=content-type;host;x-amz-date, Signature="
            "5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b5924a6f2b5d7"
        )


@pytest.mark.parametrize("token", [None, "tok"])
def test_sigv4_signatures_equal(token):
    args = ("POST", "bedrock-runtime.us-east-1.amazonaws.com", "/model/a%3Ab/converse", {"x": "1 2"},
            {"Content-Type": "application/json"}, b'{"k": 1}', "us-east-1", "bedrock", "AK", "SK",
            token)
    got = [_mod(pkg, "llm.providers").sign_v4(*args, amz_date="20250101T000000Z") for pkg in PKGS]
    assert got[0] == got[1]
    assert ("x-amz-security-token" in got[1]) == (token is not None)


@pytest.mark.parametrize("batch_size,dims", [(2, None), (256, 3)])
def test_openai_compat_embedding_equal(stub, batch_size, dims):
    url, requests = stub
    out = []
    for pkg in PKGS:
        emb = _mod(pkg, "embeddings.openai_compat").OpenAICompatEmbedding(
            model="e", base_url=f"{url}/v1", api_key="k", batch_size=batch_size, dimensions=dims)
        n0 = len(requests)
        mat = emb.embed_texts(["a", "bb", "ccc"])
        out.append((mat, emb.dim, [r[1] for r in requests[n0:]]))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1:] == out[0][1:]
    assert out[1][0][:, 0].tolist() == [1.0, 2.0, 3.0]  # order restored by index


def test_openai_compat_embedding_error_equal():
    msgs = []
    for pkg in PKGS:
        emb = _mod(pkg, "embeddings.openai_compat").OpenAICompatEmbedding(
            api_key="k", transport=lambda u, b, h, t: {"error": {"code": 429}})
        with pytest.raises(_mod(pkg, "exceptions").LLMError, match="no embeddings") as exc:
            emb.embed_texts(["x"])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_infinity_text_and_images_equal(stub, multi):
    url, requests = stub
    out = []
    for pkg in PKGS:
        mod = _mod(pkg, "embeddings.infinity")
        if multi:
            emb = mod.InfinityMultiVectorEmbedding(base_url=f"{url}/infm", model="colpali")
            got = emb.embed_texts_multi(["ab", "c"]) + emb.embed_images_multi([b"\x89PNGx"])
        else:
            emb = mod.InfinityEmbedding(base_url=f"{url}/inf", model="bge")
            got = [emb.embed_texts(["ab", "c"]), emb.embed_images([b"\x89PNGx", b"y"])]
        out.append(([np.asarray(g) for g in got], emb.dim, requests[-1][1]))
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(b, a)
    assert out[1][1:] == out[0][1:]
    assert out[1][2]["modality"] == "image"
    assert out[1][2]["input"][0].startswith("data:image/png;base64,")


REMOTE = [
    ("llm", {"type": "openai", "api_key": "k"}),
    ("llm", {"type": "vllm", "base_url": "http://127.0.0.1:8000/v1", "model": "m"}),
    ("llm", {"type": "ollama"}),
    ("llm", {"type": "openai_compat", "logprobs": True}),
    ("llm", {"type": "together"}),
    ("llm", {"type": "xai", "model": "grok"}),
    ("llm", {"type": "huggingface"}),
    ("llm", {"type": "azure_openai", "deployment": "d", "base_url": "https://r.openai.azure.com"}),
    ("llm", {"type": "anthropic", "model": "claude-sonnet-4-5", "api_key": "k"}),
    ("llm", {"type": "gemini", "model": "gemini-2.0-flash"}),
    ("llm", {"type": "bedrock", "model_id": "meta.llama3-70b-instruct-v1:0",
             "region_name": "us-west-2", "access_key": "a", "secret_key": "s"}),
    ("embedding", {"type": "openai"}),
    ("embedding", {"type": "openai_compat", "dimensions": 256}),
    ("embedding", {"type": "together"}),
    ("embedding", {"type": "jina"}),
    ("embedding", {"type": "ollama"}),
    ("embedding", {"type": "vllm"}),
    ("embedding", {"type": "infinity", "base_url": "http://127.0.0.1:7997"}),
    ("embedding", {"type": "infinity_multi", "model": "colpali"}),
]


@pytest.mark.parametrize("kind,spec", REMOTE, ids=[s["type"] + f"-{k}" for k, s in REMOTE])
def test_registry_builds_remote_kinds_like_jax(tmp_path, monkeypatch, kind, spec):
    import yaml

    for env in ("OPENAI_API_KEY", "TOGETHER_API_KEY", "XAI_API_KEY", "HF_TOKEN", "JINA_API_KEY",
                "GOOGLE_API_KEY", "AZURE_OPENAI_API_KEY", "AWS_SESSION_TOKEN"):
        monkeypatch.setenv(env, f"env-{env}")
    (tmp_path / kind).mkdir()
    (tmp_path / kind / "m.yaml").write_text(yaml.dump(spec))
    built = []
    for pkg in PKGS:
        kw = {"device": "cpu"} if pkg == TORCH else {}
        reg = _mod(pkg, "injection").ModelRegistry(tmp_path, health_check=False, **kw)
        model = getattr(reg, f"load_{kind}")("m")
        assert type(model).__module__.startswith(f"{pkg}.")
        state = {k: v for k, v in vars(model).items() if k != "transport"}
        built.append((type(model).__name__, state))
    assert built[1] == built[0]
    assert spec["type"] not in _mod(TORCH, "injection").DEFERRED[kind]
