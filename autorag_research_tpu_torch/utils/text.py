"""Text helpers: token truncation, list coercion, logprob extraction.

Role parity with reference ``util.py`` helpers: tiktoken truncation
(``:117-137`` — tiktoken is absent here, so truncation uses an HF tokenizer
when one is supplied and a calibrated chars-per-token estimate otherwise),
``to_list``/``convert_inputs_to_list`` (``:75-114``), and token-logprob
extraction (``:628+``) against this framework's ``LLMResult.logprobs``.

The port's copy of the JAX package's ``utils/text.py`` (host Python only).
"""

from __future__ import annotations

import math
from typing import Any, Iterable

CHARS_PER_TOKEN = 4.0  # rough GPT-style average for English text


def truncate_text(text: str, max_tokens: int, tokenizer=None) -> str:
    """Truncate to ~max_tokens. With an HF tokenizer: exact; otherwise a
    character-budget estimate."""
    if tokenizer is not None:
        ids = tokenizer.encode(text)
        if len(ids) <= max_tokens:
            return text
        return tokenizer.decode(ids[:max_tokens])
    budget = int(max_tokens * CHARS_PER_TOKEN)
    return text if len(text) <= budget else text[:budget]


def truncate_texts(texts: Iterable[str], max_tokens: int, tokenizer=None) -> list[str]:
    return [truncate_text(t, max_tokens, tokenizer) for t in texts]


def approx_token_count(text: str) -> int:
    return max(1, math.ceil(len(text) / CHARS_PER_TOKEN))


def to_list(value: Any) -> list:
    """Coerce scalars/ndarrays/tuples into a plain list (reference
    ``to_list``)."""
    import numpy as np

    if value is None:
        return []
    if isinstance(value, list):
        return value
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (tuple, set)):
        return list(value)
    return [value]


def extract_token_logprobs(
    result, target_tokens: list[str] | None = None
) -> dict[str, float] | None:
    """Token -> logprob map from an LLMResult; optional case-insensitive
    filtering to target tokens (reference ``extract_token_logprobs``)."""
    logprobs = getattr(result, "logprobs", None)
    if not logprobs:
        return None
    wanted = {t.lower() for t in target_tokens} if target_tokens else None
    out: dict[str, float] = {}
    for entry in logprobs:
        token = str(entry.get("token", "")).strip()
        if not token:
            continue
        if wanted is not None and token.lower() not in wanted:
            continue
        out[token] = float(entry.get("logprob", 0.0))
    return out or None
