"""Model registry / dependency injection: names -> cached model instances.

Role parity with the reference ``injection.py:86-370`` (``ModelManager`` per
model kind + ``load_llm``/``load_embedding_model``/``load_reranker`` and the
``@with_llm``/``@with_embedding`` decorators): a model name resolves to a YAML
file under ``configs/{llm,embedding,reranker}/<name>.yaml`` (``type:`` +
constructor kwargs) or to a builtin shortcut; instances are health-checked on
first load and cached for the process.

Builtin types registered here replace the reference's Hydra ``_target_``
strings; third-party types can be registered via
``register_model_type(kind, name, factory)`` or ``type: module.path:Class``.

The port's copy of the JAX package's ``injection.py``, with the kinds whose
classes the port has: the embeddings ``mock``, ``mock_multi``,
``torch_encoder`` (``multi_vector: true`` gives the token-level encoder), the
local page embedders ``colpali``, ``colqwen`` and ``bipali``, and the remote
ones (``openai``, ``openai_compat``, ``together``, ``jina``, ``ollama``,
``vllm``, ``infinity``, ``infinity_multi``); the LLMs ``mock``, ``scripted``,
``torch_lm`` (the causal decoder; its ``DecoderConfig`` fields come from the
YAML, ``dtype: bfloat16 | float32``) and the remote ones (``openai_compat``,
``openai``, ``vllm``, ``ollama``, the presets ``together``, ``xai``,
``huggingface``, ``azure_openai``, ``anthropic``, ``gemini``, ``bedrock``);
and every reranker kind of the JAX package: ``mock``, ``llm_listwise`` (its
nested ``llm:`` resolved by name), ``embedding_similarity``, ``colbert``,
the local HF checkpoints with their presets, the HTTP APIs, and
``torch_cross_encoder`` (the cross-encoder; its ``EncoderConfig`` widths come
from the YAML as the JAX package maps them for ``jax_cross_encoder``).
A registry builds its on-device models on its ``device`` (``"cuda"`` unless
the caller asks for another): ``torch_encoder``, ``torch_lm``,
``torch_cross_encoder``, ``colpali`` / ``colqwen`` / ``bipali``, the
torch-backed HF rerankers, and ``colbert``,
whose default token-level encoder (the JAX factory has none and fails
without an ``embedding_model``) is ``torch_encoder`` with ``multi_vector:
true`` at its default widths. The JAX package's on-device kinds are named in
``DEFERRED`` and refused with :class:`ModelLoadError`, whose message names
the port's own kind (``jax_encoder``, ``jax_lm``, ``jax_cross_encoder``).
"""

from __future__ import annotations

import importlib
import logging
from pathlib import Path
from typing import Any, Callable

import yaml

from autorag_research_tpu_torch.exceptions import ModelLoadError

logger = logging.getLogger("AutoRAG-Research-TPU")

_FACTORIES: dict[str, dict[str, Callable[..., Any]]] = {
    "llm": {},
    "embedding": {},
    "reranker": {},
}
# (kind, type) pairs whose factory takes the registry's device
_ON_DEVICE: set[tuple[str, str]] = set()

# the JAX package's builtin kinds that the port names otherwise -> its own kind
DEFERRED: dict[str, dict[str, str]] = {
    "llm": {
        "jax_lm": "the port's LLM kind is 'torch_lm'",
    },
    "embedding": {
        "jax_encoder": "the port's encoder kind is 'torch_encoder'",
    },
    "reranker": {
        "jax_cross_encoder": "the port's reranker kind is 'torch_cross_encoder'",
    },
}


def register_model_type(
    kind: str, name: str, factory: Callable[..., Any], on_device: bool = False
) -> None:
    """Register ``factory`` for ``type: name``; ``on_device`` factories are
    given the registry's ``device`` unless the spec names one."""
    _FACTORIES[kind][name] = factory
    if on_device:
        _ON_DEVICE.add((kind, name))


_DTYPES = ("float32", "bfloat16")


def _builtin_factories() -> None:
    from autorag_research_tpu_torch.embeddings import MockEmbedding, MockMultiVectorEmbedding
    from autorag_research_tpu_torch.llm import MockLLM, ScriptedLLM

    register_model_type("llm", "mock", MockLLM)
    register_model_type("llm", "scripted", ScriptedLLM)
    register_model_type("embedding", "mock", MockEmbedding)
    register_model_type("embedding", "mock_multi", MockMultiVectorEmbedding)

    def _torch_lm(**kw):
        import torch

        from autorag_research_tpu_torch.llm.torch_lm import TorchLM
        from autorag_research_tpu_torch.models.decoder import DecoderConfig

        config_keys = set(DecoderConfig.__dataclass_fields__)
        config_kw = {k: v for k, v in kw.items() if k in config_keys}
        rest = {k: v for k, v in kw.items() if k not in config_keys}
        if isinstance(config_kw.get("dtype"), str):
            if config_kw["dtype"] not in _DTYPES:
                raise ModelLoadError(
                    f"torch_lm dtype {config_kw['dtype']!r}: one of {', '.join(_DTYPES)}"
                )
            config_kw["dtype"] = getattr(torch, config_kw["dtype"])
        config = DecoderConfig(**config_kw) if config_kw else None
        return TorchLM(config=config, **rest)

    register_model_type("llm", "torch_lm", _torch_lm, on_device=True)

    # a class imported on first use, with preset keyword defaults
    def _lazy(path: str, **preset):
        def factory(**kw):
            module, cls = path.rsplit(".", 1)
            return getattr(importlib.import_module(module), cls)(**{**preset, **kw})

        return factory

    llm = "autorag_research_tpu_torch.llm"
    for name in ("openai_compat", "openai", "vllm", "ollama"):
        register_model_type("llm", name, _lazy(f"{llm}.openai_compat.OpenAICompatLLM"))

    # named OpenAI-compatible providers with pinned endpoint + key env
    # (reference preset roles: together.yaml, xai-grok-*.yaml, huggingface.yaml)
    def _openai_compat_preset(default_base_url: str, key_env: str):
        def factory(base_url: str | None = None, **kw):
            from autorag_research_tpu_torch.llm.openai_compat import OpenAICompatLLM

            kw.setdefault("api_key_env", key_env)
            return OpenAICompatLLM(base_url=base_url or default_base_url, **kw)

        return factory

    for name, url, env in [
        ("together", "https://api.together.xyz/v1", "TOGETHER_API_KEY"),
        ("xai", "https://api.x.ai/v1", "XAI_API_KEY"),
        ("huggingface", "http://localhost:8080/v1", "HF_TOKEN"),
    ]:
        register_model_type("llm", name, _openai_compat_preset(url, env))

    register_model_type("llm", "azure_openai", _lazy(f"{llm}.openai_compat.AzureOpenAILLM"))
    for name, cls in [("anthropic", "AnthropicLLM"), ("gemini", "GeminiLLM"),
                      ("bedrock", "BedrockLLM")]:
        register_model_type("llm", name, _lazy(f"{llm}.providers.{cls}"))

    def _torch_encoder(multi_vector: bool = False, **kw):
        from autorag_research_tpu_torch.embeddings.torch_encoder import (
            TorchEncoderEmbedding,
            TorchEncoderMultiVectorEmbedding,
        )
        from autorag_research_tpu_torch.models.encoder import EncoderConfig

        config_keys = {f for f in EncoderConfig.__dataclass_fields__}
        config_kw = {k: v for k, v in kw.items() if k in config_keys}
        rest = {k: v for k, v in kw.items() if k not in config_keys}
        if multi_vector:
            return TorchEncoderMultiVectorEmbedding(
                EncoderConfig(multi_vector=True, **config_kw), **rest
            )
        return TorchEncoderEmbedding(EncoderConfig(**config_kw), **rest)

    register_model_type("embedding", "torch_encoder", _torch_encoder, on_device=True)

    # remote OpenAI-compatible /embeddings endpoints (reference roles:
    # openai-{small,large}.yaml, openai-like.yaml, together/ollama/vllm/jina)
    def _openai_embedding_preset(default_base_url: str, key_env: str, model: str):
        def factory(base_url: str | None = None, **kw):
            from autorag_research_tpu_torch.embeddings.openai_compat import (
                OpenAICompatEmbedding,
            )

            kw.setdefault("api_key_env", key_env)
            kw.setdefault("model", model)
            return OpenAICompatEmbedding(base_url=base_url or default_base_url, **kw)

        return factory

    for name, url, env, model in [
        ("openai", "https://api.openai.com/v1", "OPENAI_API_KEY", "text-embedding-3-small"),
        ("openai_compat", "https://api.openai.com/v1", "OPENAI_API_KEY", "text-embedding-3-small"),
        ("together", "https://api.together.xyz/v1", "TOGETHER_API_KEY", "BAAI/bge-large-en-v1.5"),
        ("jina", "https://api.jina.ai/v1", "JINA_API_KEY", "jina-embeddings-v3"),
        ("ollama", "http://localhost:11434/v1", "OLLAMA_API_KEY", "nomic-embed-text"),
        ("vllm", "http://localhost:8000/v1", "VLLM_API_KEY", ""),
    ]:
        register_model_type("embedding", name, _openai_embedding_preset(url, env, model))

    # local torch page embedders (reference colpali/colqwen2/bipali presets),
    # built on the registry's device, and the Infinity server client
    colpali = "autorag_research_tpu_torch.embeddings.colpali"
    infinity = "autorag_research_tpu_torch.embeddings.infinity"
    register_model_type(
        "embedding", "colpali", _lazy(f"{colpali}.ColPaliEmbedding"), on_device=True
    )
    register_model_type(
        "embedding", "colqwen",
        _lazy(f"{colpali}.ColPaliEmbedding", checkpoint="vidore/colqwen2-v1.0"),
        on_device=True,
    )
    register_model_type("embedding", "bipali", _lazy(f"{colpali}.BiPaliEmbedding"), on_device=True)
    register_model_type("embedding", "infinity", _lazy(f"{infinity}.InfinityEmbedding"))
    register_model_type(
        "embedding", "infinity_multi", _lazy(f"{infinity}.InfinityMultiVectorEmbedding")
    )

    from autorag_research_tpu_torch.rerankers import (
        EmbeddingSimilarityReranker,
        LLMListwiseReranker,
        MockReranker,
    )

    register_model_type("reranker", "mock", MockReranker)
    register_model_type("reranker", "llm_listwise", LLMListwiseReranker)
    register_model_type("reranker", "embedding_similarity", EmbeddingSimilarityReranker)

    def _colbert(embedding_model=None, device: str = "cuda", **kw):
        from autorag_research_tpu_torch.rerankers.colbert import ColBERTReranker

        if embedding_model is None:
            from autorag_research_tpu_torch.embeddings.torch_encoder import (
                TorchEncoderMultiVectorEmbedding,
            )

            embedding_model = TorchEncoderMultiVectorEmbedding(device=device)
        return ColBERTReranker(embedding_model, **kw)

    register_model_type("reranker", "colbert", _colbert, on_device=True)

    def _torch_cross(**kw):
        from autorag_research_tpu_torch.models.encoder import EncoderConfig
        from autorag_research_tpu_torch.rerankers.torch_cross import TorchCrossEncoderReranker

        cfg_kw = {
            k: kw.pop(k)
            for k in ("vocab_size", "hidden", "layers", "heads", "max_len", "out_dim")
            if k in kw
        }
        config = EncoderConfig(**cfg_kw) if cfg_kw else None
        return TorchCrossEncoderReranker(config=config, **kw)

    register_model_type("reranker", "torch_cross_encoder", _torch_cross, on_device=True)

    hf = "autorag_research_tpu_torch.rerankers.hf"
    for name, cls in [
        ("cross_encoder", "CrossEncoderReranker"),
        ("monot5", "MonoT5Reranker"),
        ("upr", "UPRReranker"),
    ]:
        register_model_type("reranker", name, _lazy(f"{hf}.{cls}"), on_device=True)

    # Named presets for the reference's remaining local rerankers, each a
    # class above with a default checkpoint; the torch-backed ones take the
    # registry's device, the ONNX / OpenVINO ones run where their runtimes do
    def _hf_preset(cls_name: str, default_checkpoint: str):
        def factory(checkpoint: str | None = None, **kw):
            return getattr(importlib.import_module(hf), cls_name)(
                checkpoint or default_checkpoint, **kw
            )

        return factory

    for name, cls, ckpt, on_device in [
        ("flag_embedding", "CrossEncoderReranker", "BAAI/bge-reranker-v2-m3", True),
        ("koreranker", "CrossEncoderReranker", "Dongjin-kr/ko-reranker", True),
        ("sentence_transformer", "CrossEncoderReranker",
         "cross-encoder/ms-marco-MiniLM-L-6-v2", True),
        ("flag_embedding_llm", "FlagLLMReranker", "BAAI/bge-reranker-v2-gemma", True),
        ("tart", "TARTReranker", "facebook/tart-full-flan-t5-xl", True),
        ("flashrank", "FlashRankReranker", "cross-encoder/ms-marco-MiniLM-L-12-v2", False),
        ("openvino", "OpenVINOReranker", "cross-encoder/ms-marco-MiniLM-L-6-v2", False),
    ]:
        register_model_type("reranker", name, _hf_preset(cls, ckpt), on_device=on_device)
    for name, cls in [
        ("cohere", "CohereReranker"),
        ("jina", "JinaReranker"),
        ("voyageai", "VoyageReranker"),
        ("mixedbreadai", "MixedbreadReranker"),
    ]:
        register_model_type(
            "reranker", name, _lazy(f"autorag_research_tpu_torch.rerankers.api.{cls}")
        )


_builtin_factories()


class ModelRegistry:
    """Per-experiment model loader with health checks + instance cache."""

    def __init__(
        self,
        config_dir: str | Path | None = None,
        health_check: bool = True,
        device: str = "cuda",
    ):
        self.config_dir = Path(config_dir) if config_dir else None
        self.health_check = health_check
        self.device = device
        self._cache: dict[tuple[str, str], Any] = {}

    # ------------------------------------------------------------ resolution
    def _resolve_spec(self, kind: str, name: str) -> dict:
        if self.config_dir is not None:
            yaml_path = self.config_dir / kind / f"{name}.yaml"
            if yaml_path.exists():
                spec = yaml.safe_load(yaml_path.read_text()) or {}
                if "type" not in spec:
                    raise ModelLoadError(f"{yaml_path} missing 'type'")
                return spec
        if name in _FACTORIES[kind] or name in DEFERRED[kind]:
            return {"type": name}
        raise ModelLoadError(
            f"unknown {kind} '{name}': no configs/{kind}/{name}.yaml and no builtin; "
            f"builtins: {sorted(_FACTORIES[kind])}"
        )

    def _instantiate(self, kind: str, spec: dict) -> Any:
        spec = dict(spec)
        type_name = spec.pop("type")
        if ":" in type_name:  # module.path:Class escape hatch
            module, cls = type_name.split(":", 1)
            factory = getattr(importlib.import_module(module), cls)
        else:
            factory = _FACTORIES[kind].get(type_name)
            if factory is None:
                if type_name in DEFERRED[kind]:
                    raise ModelLoadError(
                        f"{kind} type '{type_name}' is not in the PyTorch port yet: "
                        f"{DEFERRED[kind][type_name]}"
                    )
                raise ModelLoadError(f"unknown {kind} type '{type_name}'")
            if (kind, type_name) in _ON_DEVICE:
                spec.setdefault("device", self.device)
        # nested model references resolve recursively
        for key in ("llm", "embedding_model"):
            if isinstance(spec.get(key), str):
                loader = self.load_llm if key == "llm" else self.load_embedding
                spec[key] = loader(spec[key])
        return factory(**spec)

    def _load(self, kind: str, name: str) -> Any:
        key = (kind, name)
        if key in self._cache:
            return self._cache[key]
        instance = self._instantiate(kind, self._resolve_spec(kind, name))
        if self.health_check and hasattr(instance, "health_check"):
            try:
                instance.health_check()
            except Exception as exc:  # noqa: BLE001
                raise ModelLoadError(f"{kind} '{name}' failed health check: {exc}") from exc
        self._cache[key] = instance
        return instance

    # --------------------------------------------------------------- loaders
    def load_llm(self, name: str) -> Any:
        return self._load("llm", name)

    def load_embedding(self, name: str) -> Any:
        return self._load("embedding", name)

    def load_reranker(self, name: str) -> Any:
        return self._load("reranker", name)


_default_registry: ModelRegistry | None = None


def get_default_registry() -> ModelRegistry:
    global _default_registry
    if _default_registry is None:
        _default_registry = ModelRegistry()
    return _default_registry


def load_llm(name: str):
    return get_default_registry().load_llm(name)


def load_embedding_model(name: str):
    return get_default_registry().load_embedding(name)


def load_reranker(name: str):
    return get_default_registry().load_reranker(name)
