"""TorchLM: local generation on the GPU through the framework LLM protocol.

The port's counterpart of the JAX package's ``llm/jax_lm.py`` (model name
``torch_lm``): byte-level tokenize -> prefill + KV-cache decode over the
causal decoder (``models/decoder.py``) -> detokenize. A call decodes its
whole batch in one ``generate`` and reads the tokens back once.

Random-init weights emit noise; a checkpoint gives trained behavior.
``save`` / ``load`` use the JAX package's flat ``.npz`` format (the keys
``JaxLM.save`` writes), so a ``JaxLM`` checkpoint loads here and back.

Runs on ``device`` (``"cuda"`` unless the caller asks for another); asked
for ``cuda`` on a machine without one, construction raises. Temperature
sampling draws one seed a call from a generator seeded with ``seed``, under
a lock (the server decodes batches from several threads), so samples advance
across calls and a seeded model repeats its sequence of calls; they cannot
repeat ``jax.random.categorical``'s draws.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from autorag_research_tpu_torch.llm.base import BaseLLM, LLMResult
from autorag_research_tpu_torch.models.decoder import (
    CausalDecoder,
    DecoderConfig,
    byte_detokenize,
    byte_tokenize,
    decoder_params_from_jax,
    decoder_params_to_jax,
)


class TorchLM(BaseLLM):
    model_name = "torch_lm"

    def __init__(
        self,
        config: DecoderConfig | None = None,
        params: dict[str, np.ndarray] | None = None,
        seed: int = 0,
        max_prompt_len: int = 384,
        max_new_tokens: int = 96,
        temperature: float = 0.0,
        checkpoint: str | None = None,
        device: str | torch.device = "cuda",
    ):
        """``params``: the flat numpy dict of the JAX package's parameter
        names (what :func:`decoder_params_to_jax` gives)."""
        self.config = config or DecoderConfig()
        if max_prompt_len + max_new_tokens > self.config.max_len:
            raise ValueError(
                f"max_prompt_len {max_prompt_len} + max_new_tokens {max_new_tokens} "
                f"exceeds model max_len {self.config.max_len}"
            )
        self.decoder = CausalDecoder(self.config, device=device, seed=seed)
        if params is not None:
            self.decoder.load_state_dict(decoder_params_from_jax(params))
        if checkpoint:
            self.load(checkpoint)
        self.max_prompt_len = max_prompt_len
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self._seeds = torch.Generator().manual_seed(seed)
        self._lock = threading.Lock()
        self.calls: list[str] = []

    @property
    def device(self) -> torch.device:
        return self.decoder.device

    def _call_generator(self) -> torch.Generator | None:
        """A generator on the device for one sampled call, seeded from the
        model's own stream (which every sampled call advances)."""
        if self.temperature <= 0.0:
            return None
        with self._lock:
            seed = int(torch.randint(0, 2**62, (1,), generator=self._seeds))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _decode(self, prompts: list[str]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(tokens [B, max_new_tokens], prompt lengths [B], generated
        counts [B]) of one batched decode."""
        ids, mask = byte_tokenize(prompts, self.max_prompt_len)
        dev = self.device
        tokens, n_new = self.decoder.generate(
            torch.from_numpy(ids).to(dev, torch.int64),
            torch.from_numpy(mask).to(dev),
            self.max_new_tokens,
            temperature=self.temperature,
            generator=self._call_generator(),
        )
        out = torch.cat([tokens, n_new[:, None]], dim=1).cpu().numpy()  # one readback
        return out[:, :-1], mask.sum(axis=1).astype(int), out[:, -1].astype(int)

    @staticmethod
    def _result(text: str, prompt_tokens: int, completion: int) -> LLMResult:
        return LLMResult(
            text=text,
            token_usage={
                "prompt_tokens": int(prompt_tokens),
                "completion_tokens": int(completion),
                "total_tokens": int(prompt_tokens) + int(completion),
            },
            metadata={"model": "torch_lm", "on_device": True},
        )

    # ------------------------------------------------------------- protocol
    async def agenerate(self, prompt: str, **kwargs: Any) -> LLMResult:
        self.calls.append(prompt)
        tokens, prompt_lens, new_lens = self._decode([prompt])
        return self._result(byte_detokenize(tokens)[0], prompt_lens[0], new_lens[0])

    def generate_batch(self, prompts: list[str]) -> list[str]:
        """Batched decode in one call (serving path)."""
        return [r.text for r in self.generate_batch_results(prompts)]

    def generate_batch_results(self, prompts: list[str]) -> list[LLMResult]:
        """Batched decode returning full :class:`LLMResult` rows, so the
        batched serving path reports the same per-query ``token_usage`` as
        the single-query :meth:`agenerate` path."""
        tokens, prompt_lens, new_lens = self._decode(prompts)
        return [
            self._result(t, p, n)
            for t, p, n in zip(byte_detokenize(tokens), prompt_lens, new_lens)
        ]

    # ----------------------------------------------------------- checkpoint
    def save(self, path: str) -> None:
        np.savez(path, **decoder_params_to_jax(self.decoder))

    def load(self, path: str) -> None:
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        self.decoder.load_state_dict(decoder_params_from_jax(flat))
