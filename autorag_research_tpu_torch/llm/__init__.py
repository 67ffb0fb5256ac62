from autorag_research_tpu_torch.llm.base import BaseLLM, LLMResult, MockLLM, ScriptedLLM


def __getattr__(name):
    # lazy: TorchLM pulls in torch and the decoder; keep `import ...llm` light
    if name == "TorchLM":
        from autorag_research_tpu_torch.llm.torch_lm import TorchLM

        return TorchLM
    if name in ("AnthropicLLM", "GeminiLLM", "BedrockLLM"):
        from autorag_research_tpu_torch.llm import providers

        return getattr(providers, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "BaseLLM",
    "LLMResult",
    "MockLLM",
    "ScriptedLLM",
    "TorchLM",
    "AnthropicLLM",
    "GeminiLLM",
    "BedrockLLM",
]
