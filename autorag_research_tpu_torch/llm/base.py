"""LLM adapters.

The reference routes all LLM access through LangChain ``BaseLanguageModel``
instances built from ``configs/llm/*.yaml`` (19 presets, ``injection.py:111-139``).
This framework defines its own minimal async protocol — ``agenerate(prompt) ->
LLMResult(text, token_usage, logprobs)`` — implemented by:

- ``MockLLM`` / ``ScriptedLLM``: deterministic fakes for tests and health
  checks (reference ``tests/.../pipeline_test_utils.py:351`` mock pattern and
  the ``mock`` LLM preset);
- ``TorchLM`` (``llm/torch_lm.py``): local decoding on the GPU over the
  causal decoder in ``models/decoder.py``.

The port's copy of the JAX package's ``llm/base.py``; the remote adapters
are ``llm/openai_compat.py`` and ``llm/providers.py``.
"""

from __future__ import annotations

import asyncio
import hashlib
import re
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class LLMResult:
    text: str
    token_usage: dict[str, int] | None = None
    logprobs: list[dict[str, Any]] | None = None
    metadata: dict = field(default_factory=dict)


def _approx_tokens(text: str) -> int:
    return max(1, len(text) // 4)


class BaseLLM(ABC):
    """Minimal async LLM protocol."""

    model_name: str = "unknown"

    @abstractmethod
    async def agenerate(self, prompt: str, **kwargs: Any) -> LLMResult:
        ...

    def generate(self, prompt: str, **kwargs: Any) -> LLMResult:
        from autorag_research_tpu_torch.utils.concurrency import run_async

        return run_async(self.agenerate(prompt, **kwargs))

    def health_check(self) -> None:
        result = self.generate("Reply with the word OK.")
        if not result.text:
            from autorag_research_tpu_torch.exceptions import HealthCheckError

            raise HealthCheckError(f"LLM {self.model_name} returned empty text")


class MockLLM(BaseLLM):
    """Deterministic mock: replies via a response function or canned rules.

    ``responder`` receives the prompt and returns a string; default echoes a
    short deterministic digest so generation pipelines always produce
    non-empty, reproducible output offline.
    """

    model_name = "mock"

    def __init__(
        self,
        responder: Callable[[str], str] | None = None,
        latency: float = 0.0,
        logprob_value: float = -0.05,
    ):
        self.responder = responder
        self.latency = latency
        self.logprob_value = logprob_value
        self.calls: list[str] = []

    async def agenerate(self, prompt: str, **kwargs: Any) -> LLMResult:
        self.calls.append(prompt)
        if self.latency:
            await asyncio.sleep(self.latency)
        if self.responder is not None:
            text = self.responder(prompt)
        else:
            digest = hashlib.sha1(prompt.encode()).hexdigest()[:8]
            text = f"mock answer {digest}"
        usage = {
            "prompt_tokens": _approx_tokens(prompt),
            "completion_tokens": _approx_tokens(text),
            "total_tokens": _approx_tokens(prompt) + _approx_tokens(text),
        }
        logprobs = [
            {"token": tok, "logprob": self.logprob_value} for tok in text.split()[:10]
        ]
        return LLMResult(text=text, token_usage=usage, logprobs=logprobs)


class ScriptedLLM(BaseLLM):
    """Returns queued responses in order (or by regex rules); raises when the
    script is exhausted. For agentic-pipeline tests with multi-turn protocols."""

    model_name = "scripted"

    def __init__(self, responses: list[str] | None = None, rules: list[tuple[str, str]] | None = None):
        self.responses = list(responses or [])
        self.rules = [(re.compile(p, re.S), r) for p, r in (rules or [])]
        self.calls: list[str] = []

    async def agenerate(self, prompt: str, **kwargs: Any) -> LLMResult:
        self.calls.append(prompt)
        for pattern, response in self.rules:
            if pattern.search(prompt):
                return LLMResult(text=response, token_usage={"prompt_tokens": 1, "completion_tokens": 1, "total_tokens": 2})
        if not self.responses:
            raise RuntimeError("ScriptedLLM has no responses left")
        text = self.responses.pop(0)
        return LLMResult(
            text=text,
            token_usage={
                "prompt_tokens": _approx_tokens(prompt),
                "completion_tokens": _approx_tokens(text),
                "total_tokens": _approx_tokens(prompt) + _approx_tokens(text),
            },
        )
