"""OpenAI-compatible chat LLM adapter (openai / vllm / ollama / any endpoint).

Capability parity with the reference's LangChain LLM presets
(``configs/llm/*.yaml`` — openai, vllm, ollama, and other OpenAI-compatible
endpoints) implemented over the REST chat-completions API with stdlib urllib
(no SDKs baked into this image). Supports logprobs and vision content parts
(``images=`` kwarg), async via thread offload.

The port's copy of the JAX package's ``llm/openai_compat.py``.
"""

from __future__ import annotations

import asyncio
import base64
import json
import os
import urllib.request
from typing import Any

from autorag_research_tpu_torch.exceptions import LLMError
from autorag_research_tpu_torch.llm.base import BaseLLM, LLMResult


class OpenAICompatLLM(BaseLLM):
    def __init__(
        self,
        model: str = "gpt-4o-mini",
        base_url: str = "https://api.openai.com/v1",
        api_key: str | None = None,
        api_key_env: str = "OPENAI_API_KEY",
        temperature: float = 0.0,
        max_tokens: int | None = 1024,
        logprobs: bool = False,
        timeout: float = 120.0,
        extra_body: dict | None = None,
    ):
        self.model_name = model
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key or os.environ.get(api_key_env, "")
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.logprobs = logprobs
        self.timeout = timeout
        self.extra_body = extra_body or {}

    def _request(self, prompt: str, images: list[bytes] | None, **kwargs: Any) -> dict:
        if images:
            content: Any = [{"type": "text", "text": prompt}]
            for img in images:
                b64 = base64.b64encode(img).decode()
                content.append(
                    {"type": "image_url", "image_url": {"url": f"data:image/png;base64,{b64}"}}
                )
        else:
            content = prompt
        body = {
            "model": self.model_name,
            "messages": [{"role": "user", "content": content}],
            "temperature": kwargs.get("temperature", self.temperature),
            **self.extra_body,
        }
        max_tokens = kwargs.get("max_tokens", self.max_tokens)
        if max_tokens is not None:
            body["max_tokens"] = max_tokens
        if self.logprobs:
            body["logprobs"] = True
            body["top_logprobs"] = 5
        req = urllib.request.Request(
            self._endpoint(),
            data=json.dumps(body).encode(),
            headers=self._headers(),
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except Exception as exc:  # noqa: BLE001
            raise LLMError(f"{self.model_name} call failed: {exc}") from exc

    def _endpoint(self) -> str:
        return f"{self.base_url}/chat/completions"

    def _headers(self) -> dict:
        return {
            "Content-Type": "application/json",
            "Authorization": f"Bearer {self.api_key}",
        }

    def _parse(self, data: dict) -> LLMResult:
        if not data.get("choices"):
            # vllm/ollama-style servers can return HTTP 200 with an error
            # body; surface it as LLMError so retry/quarantine catch it
            # (the Anthropic/Gemini/Bedrock adapters check this shape too)
            err = data.get("error") or data
            raise LLMError(f"{self.model_name}: no choices in response: {err}")
        choice = data["choices"][0]
        text = choice["message"].get("content") or ""
        usage = data.get("usage") or {}
        logprobs = None
        lp = choice.get("logprobs")
        if lp and lp.get("content"):
            logprobs = [
                {"token": t.get("token"), "logprob": t.get("logprob")}
                for t in lp["content"]
            ]
        return LLMResult(
            text=text,
            token_usage={
                "prompt_tokens": usage.get("prompt_tokens", 0),
                "completion_tokens": usage.get("completion_tokens", 0),
                "total_tokens": usage.get("total_tokens", 0),
            },
            logprobs=logprobs,
            metadata={"finish_reason": choice.get("finish_reason")},
        )

    async def agenerate(self, prompt: str, images: list[bytes] | None = None, **kwargs: Any) -> LLMResult:
        data = await asyncio.to_thread(self._request, prompt, images, **kwargs)
        return self._parse(data)


class AzureOpenAILLM(OpenAICompatLLM):
    """Azure OpenAI chat deployment (reference preset role:
    ``configs/llm/azure-openai.yaml`` -> langchain AzureChatOpenAI).

    Azure differs from the plain OpenAI dialect in the URL scheme
    (``/openai/deployments/{deployment}/chat/completions?api-version=...``)
    and the auth header (``api-key`` instead of a Bearer token)."""

    def __init__(
        self,
        deployment: str,
        base_url: str,  # https://<resource>.openai.azure.com
        api_version: str = "2024-06-01",
        api_key: str | None = None,
        api_key_env: str = "AZURE_OPENAI_API_KEY",
        **kw,
    ):
        super().__init__(
            model=deployment, base_url=base_url, api_key=api_key,
            api_key_env=api_key_env, **kw,
        )
        self.deployment = deployment
        self.api_version = api_version

    def _endpoint(self) -> str:
        return (
            f"{self.base_url}/openai/deployments/{self.deployment}"
            f"/chat/completions?api-version={self.api_version}"
        )

    def _headers(self) -> dict:
        return {"Content-Type": "application/json", "api-key": self.api_key}
