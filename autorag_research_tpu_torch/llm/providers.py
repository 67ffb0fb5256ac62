"""Native Anthropic / Google Gemini / AWS Bedrock LLM adapters.

Capability parity with the reference's provider presets
(``configs/llm/anthropic-*.yaml`` -> ``langchain_anthropic.ChatAnthropic``,
``configs/llm/google-gemini-*.yaml`` -> langchain Google GenAI,
``configs/llm/aws-bedrock.yaml`` -> ``langchain_aws.ChatBedrock``; injected
via reference ``injection.py:226-342``), implemented directly over each
provider's REST API with stdlib urllib — no SDKs baked into this image.
Bedrock requests are SigV4-signed in pure stdlib (hmac/hashlib), validated
against AWS's published signing test vector.

All adapters accept a ``transport`` callable
``(url, body, headers, timeout) -> dict`` so tests (and exotic deployments:
proxies, recorded fixtures) can replace the HTTP layer; the default
transport POSTs JSON with urllib. The environment is egress-blocked, so live
calls are exercised only through mock transports
(``tests/test_llm_adapters.py``, ``tests/test_torch_llm_adapters.py``).

The port's copy of the JAX package's ``llm/providers.py``.
"""

from __future__ import annotations

import asyncio
import base64
import datetime
import hashlib
import hmac
import json
import os
import urllib.parse
import urllib.request
from typing import Any, Callable

from autorag_research_tpu_torch.exceptions import LLMError
from autorag_research_tpu_torch.llm.base import BaseLLM, LLMResult

# (url, json body, headers, timeout seconds) -> parsed JSON response.
# Timeout is a real argument so injected transports (proxies, recorded
# fixtures) receive clean wire headers.
Transport = Callable[[str, dict, dict, float], dict]


def _urllib_transport(
    url: str, body: dict | bytes, headers: dict, timeout: float = 120.0
) -> dict:
    # bytes pass through untouched: SigV4-signed requests (Bedrock) hash the
    # exact payload bytes, so re-serializing would risk a signature mismatch
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class AnthropicLLM(BaseLLM):
    """Anthropic Messages API adapter (reference preset role:
    ``configs/llm/anthropic-claude-*.yaml``)."""

    def __init__(
        self,
        model: str = "claude-sonnet-4-5",
        base_url: str = "https://api.anthropic.com",
        api_key: str | None = None,
        api_key_env: str = "ANTHROPIC_API_KEY",
        temperature: float = 0.0,
        max_tokens: int = 1024,
        anthropic_version: str = "2023-06-01",
        timeout: float = 120.0,
        system: str | None = None,
        transport: Transport | None = None,
    ):
        self.model_name = model
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key or os.environ.get(api_key_env, "")
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.anthropic_version = anthropic_version
        self.timeout = timeout
        self.system = system
        self.transport = transport or _urllib_transport

    def _request(self, prompt: str, images: list[bytes] | None, **kwargs: Any) -> dict:
        if images:
            content: Any = [
                {
                    "type": "image",
                    "source": {
                        "type": "base64",
                        "media_type": "image/png",
                        "data": base64.b64encode(img).decode(),
                    },
                }
                for img in images
            ]
            content.append({"type": "text", "text": prompt})
        else:
            content = prompt
        body = {
            "model": self.model_name,
            "max_tokens": kwargs.get("max_tokens", self.max_tokens),
            "temperature": kwargs.get("temperature", self.temperature),
            "messages": [{"role": "user", "content": content}],
        }
        system = kwargs.get("system", self.system)
        if system:
            body["system"] = system
        headers = {
            "Content-Type": "application/json",
            "x-api-key": self.api_key,
            "anthropic-version": self.anthropic_version,
        }
        try:
            return self.transport(f"{self.base_url}/v1/messages", body, headers, self.timeout)
        except Exception as exc:  # noqa: BLE001
            raise LLMError(f"{self.model_name} call failed: {exc}") from exc

    def _parse(self, data: dict) -> LLMResult:
        if data.get("type") == "error":
            raise LLMError(f"{self.model_name}: {data.get('error')}")
        text = "".join(
            part.get("text", "")
            for part in data.get("content", [])
            if part.get("type") == "text"
        )
        usage = data.get("usage") or {}
        in_tok = usage.get("input_tokens", 0)
        out_tok = usage.get("output_tokens", 0)
        return LLMResult(
            text=text,
            token_usage={
                "prompt_tokens": in_tok,
                "completion_tokens": out_tok,
                "total_tokens": in_tok + out_tok,
            },
            metadata={"stop_reason": data.get("stop_reason")},
        )

    async def agenerate(
        self, prompt: str, images: list[bytes] | None = None, **kwargs: Any
    ) -> LLMResult:
        data = await asyncio.to_thread(self._request, prompt, images, **kwargs)
        return self._parse(data)


def _hmac_sha256(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sign_v4(
    method: str,
    host: str,
    path: str,
    query: dict[str, str],
    headers: dict[str, str],
    payload: bytes,
    region: str,
    service: str,
    access_key: str,
    secret_key: str,
    session_token: str | None = None,
    amz_date: str | None = None,
    sign_payload_header: bool = True,
) -> dict[str, str]:
    """AWS Signature Version 4 over stdlib. Returns the headers to send
    (input headers + host/x-amz-date/x-amz-content-sha256/Authorization
    [+ x-amz-security-token]).

    ``path`` is the as-sent (already percent-encoded once) absolute path;
    per the SigV4 spec the canonical URI encodes each segment AGAIN for all
    services except S3. ``amz_date`` is injectable for deterministic tests
    (validated against AWS's published IAM ListUsers signing vector).
    """
    if amz_date is None:
        amz_date = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ"
        )
    datestamp = amz_date[:8]

    canonical_uri = urllib.parse.quote(path if path.startswith("/") else "/" + path, safe="/")
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(str(v), safe='-_.~')}"
        for k, v in sorted(query.items())
    )
    payload_hash = hashlib.sha256(payload).hexdigest()
    all_headers = {k.lower(): " ".join(str(v).split()) for k, v in headers.items()}
    all_headers["host"] = host
    all_headers["x-amz-date"] = amz_date
    if sign_payload_header:
        all_headers["x-amz-content-sha256"] = payload_hash
    if session_token:
        all_headers["x-amz-security-token"] = session_token
    signed_names = sorted(all_headers)
    canonical_headers = "".join(f"{k}:{all_headers[k]}\n" for k in signed_names)
    signed_headers = ";".join(signed_names)
    canonical_request = "\n".join(
        [method, canonical_uri, canonical_query, canonical_headers, signed_headers, payload_hash]
    )

    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ]
    )
    key = _hmac_sha256(f"AWS4{secret_key}".encode(), datestamp)
    key = _hmac_sha256(key, region)
    key = _hmac_sha256(key, service)
    key = _hmac_sha256(key, "aws4_request")
    signature = hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()

    out = dict(headers)
    out["host"] = host
    out["x-amz-date"] = amz_date
    if sign_payload_header:
        out["x-amz-content-sha256"] = payload_hash
    if session_token:
        out["x-amz-security-token"] = session_token
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    return out


class BedrockLLM(BaseLLM):
    """AWS Bedrock Converse API adapter (reference preset role:
    ``configs/llm/aws-bedrock.yaml`` -> ``langchain_aws.ChatBedrock``).

    POSTs to ``/model/{modelId}/converse`` on the bedrock-runtime endpoint
    with stdlib SigV4 signing — works for every Converse-capable model
    family (Anthropic, Llama, Titan, Mistral, ...) without per-family
    request shapes. Credentials resolve from constructor args then the
    standard ``AWS_ACCESS_KEY_ID``/``AWS_SECRET_ACCESS_KEY``
    [/``AWS_SESSION_TOKEN``] environment variables.
    """

    def __init__(
        self,
        model_id: str = "anthropic.claude-sonnet-4-5-20250929-v1:0",
        region_name: str = "us-east-1",
        base_url: str | None = None,
        access_key: str | None = None,
        secret_key: str | None = None,
        session_token: str | None = None,
        temperature: float = 0.0,
        max_tokens: int = 1024,
        timeout: float = 120.0,
        system: str | None = None,
        transport: Transport | None = None,
    ):
        self.model_name = model_id
        self.region_name = region_name
        self.base_url = (
            base_url or f"https://bedrock-runtime.{region_name}.amazonaws.com"
        ).rstrip("/")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self.session_token = session_token or os.environ.get("AWS_SESSION_TOKEN")
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.timeout = timeout
        self.system = system
        self.transport = transport or _urllib_transport

    def _request(self, prompt: str, images: list[bytes] | None, **kwargs: Any) -> dict:
        content: list[dict[str, Any]] = []
        for img in images or []:
            content.append(
                {
                    "image": {
                        "format": "png",
                        # Converse over raw HTTP carries image bytes base64-encoded
                        "source": {"bytes": base64.b64encode(img).decode()},
                    }
                }
            )
        content.append({"text": prompt})
        body: dict[str, Any] = {
            "messages": [{"role": "user", "content": content}],
            "inferenceConfig": {
                "maxTokens": kwargs.get("max_tokens", self.max_tokens),
                "temperature": kwargs.get("temperature", self.temperature),
            },
        }
        system = kwargs.get("system", self.system)
        if system:
            body["system"] = [{"text": system}]
        # model id goes percent-encoded into the as-sent path (':' etc.)
        path = f"/model/{urllib.parse.quote(self.model_name, safe='')}/converse"
        payload = json.dumps(body).encode()
        host = urllib.parse.urlparse(self.base_url).netloc
        headers = sign_v4(
            "POST",
            host,
            path,
            {},
            {"Content-Type": "application/json"},
            payload,
            self.region_name,
            "bedrock",
            self.access_key,
            self.secret_key,
            self.session_token,
        )
        try:
            # send the exact signed bytes — re-serializing the dict in the
            # transport could produce different bytes than the payload hash
            return self.transport(
                f"{self.base_url}{path}", payload, headers, self.timeout
            )
        except Exception as exc:  # noqa: BLE001
            raise LLMError(f"{self.model_name} call failed: {exc}") from exc

    def _parse(self, data: dict) -> LLMResult:
        if "message" in data and "output" not in data:
            # bedrock error shape: {"message": "..."} with an HTTP error code
            raise LLMError(f"{self.model_name}: {data['message']}")
        msg = (data.get("output") or {}).get("message") or {}
        text = "".join(p.get("text", "") for p in msg.get("content", []) if "text" in p)
        usage = data.get("usage") or {}
        return LLMResult(
            text=text,
            token_usage={
                "prompt_tokens": usage.get("inputTokens", 0),
                "completion_tokens": usage.get("outputTokens", 0),
                "total_tokens": usage.get(
                    "totalTokens",
                    usage.get("inputTokens", 0) + usage.get("outputTokens", 0),
                ),
            },
            metadata={"stop_reason": data.get("stopReason")},
        )

    async def agenerate(
        self, prompt: str, images: list[bytes] | None = None, **kwargs: Any
    ) -> LLMResult:
        data = await asyncio.to_thread(self._request, prompt, images, **kwargs)
        return self._parse(data)


class GeminiLLM(BaseLLM):
    """Google Gemini ``generateContent`` adapter (reference preset role:
    ``configs/llm/google-gemini-*.yaml``)."""

    def __init__(
        self,
        model: str = "gemini-2.0-flash",
        base_url: str = "https://generativelanguage.googleapis.com/v1beta",
        api_key: str | None = None,
        api_key_env: str = "GOOGLE_API_KEY",
        temperature: float = 0.0,
        max_tokens: int | None = 1024,
        timeout: float = 120.0,
        system: str | None = None,
        transport: Transport | None = None,
    ):
        self.model_name = model
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key or os.environ.get(api_key_env, "")
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.timeout = timeout
        self.system = system
        self.transport = transport or _urllib_transport

    def _request(self, prompt: str, images: list[bytes] | None, **kwargs: Any) -> dict:
        parts: list[dict] = [{"text": prompt}]
        for img in images or []:
            parts.append(
                {
                    "inline_data": {
                        "mime_type": "image/png",
                        "data": base64.b64encode(img).decode(),
                    }
                }
            )
        gen_cfg: dict[str, Any] = {
            "temperature": kwargs.get("temperature", self.temperature)
        }
        max_tokens = kwargs.get("max_tokens", self.max_tokens)
        if max_tokens is not None:
            gen_cfg["maxOutputTokens"] = max_tokens
        body = {
            "contents": [{"role": "user", "parts": parts}],
            "generationConfig": gen_cfg,
        }
        system = kwargs.get("system", self.system)
        if system:
            body["systemInstruction"] = {"parts": [{"text": system}]}
        headers = {
            "Content-Type": "application/json",
            "x-goog-api-key": self.api_key,
        }
        url = f"{self.base_url}/models/{self.model_name}:generateContent"
        try:
            return self.transport(url, body, headers, self.timeout)
        except Exception as exc:  # noqa: BLE001
            raise LLMError(f"{self.model_name} call failed: {exc}") from exc

    def _parse(self, data: dict) -> LLMResult:
        if "error" in data:
            raise LLMError(f"{self.model_name}: {data['error']}")
        candidates = data.get("candidates") or []
        if not candidates:
            raise LLMError(f"{self.model_name}: empty candidates (blocked?)")
        cand = candidates[0]
        text = "".join(
            p.get("text", "") for p in (cand.get("content") or {}).get("parts", [])
        )
        usage = data.get("usageMetadata") or {}
        return LLMResult(
            text=text,
            token_usage={
                "prompt_tokens": usage.get("promptTokenCount", 0),
                "completion_tokens": usage.get("candidatesTokenCount", 0),
                "total_tokens": usage.get("totalTokenCount", 0),
            },
            metadata={"finish_reason": cand.get("finishReason")},
        )

    async def agenerate(
        self, prompt: str, images: list[bytes] | None = None, **kwargs: Any
    ) -> LLMResult:
        data = await asyncio.to_thread(self._request, prompt, images, **kwargs)
        return self._parse(data)
