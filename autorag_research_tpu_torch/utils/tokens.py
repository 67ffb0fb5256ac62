"""Token-usage accounting for LLM calls.

Role parity with the reference ``util.py:534-626`` (``TokenUsageTracker`` /
``aggregate_token_usage``), re-targeted at this framework's own ``LLMResult``
instead of LangChain response objects: our LLM adapters always report usage as
``{"prompt_tokens", "completion_tokens", "total_tokens"}``.

The port's copy of the JAX package's ``utils/tokens.py``.
"""

from __future__ import annotations

from typing import Any

USAGE_KEYS = ("prompt_tokens", "completion_tokens", "total_tokens")


class TokenUsageTracker:
    """Accumulates per-call token usage dicts and exposes totals + history."""

    def __init__(self) -> None:
        self._history: list[dict[str, int]] = []

    def record(self, usage_or_result: Any) -> dict[str, int] | None:
        """Record usage from a dict or any object with a ``token_usage`` attr."""
        usage = self._extract(usage_or_result)
        if usage is not None:
            self._history.append(dict(usage))
        return usage

    @property
    def total(self) -> dict[str, int]:
        if not self._history:
            return dict.fromkeys(USAGE_KEYS, 0)
        result: dict[str, int] = {}
        for usage in self._history:
            for key, value in usage.items():
                result[key] = result.get(key, 0) + int(value)
        return result

    @property
    def history(self) -> list[dict[str, int]]:
        return [dict(u) for u in self._history]

    @staticmethod
    def _extract(obj: Any) -> dict[str, int] | None:
        if obj is None:
            return None
        if isinstance(obj, dict):
            usage = obj
        elif hasattr(obj, "token_usage") and obj.token_usage is not None:
            usage = obj.token_usage
        else:
            return None
        if not usage:
            return None
        return {
            "prompt_tokens": int(usage.get("prompt_tokens", usage.get("input_tokens", 0))),
            "completion_tokens": int(usage.get("completion_tokens", usage.get("output_tokens", 0))),
            "total_tokens": int(
                usage.get(
                    "total_tokens",
                    usage.get("prompt_tokens", usage.get("input_tokens", 0))
                    + usage.get("completion_tokens", usage.get("output_tokens", 0)),
                )
            ),
        }


def aggregate_token_usage(
    current: dict[str, int] | None,
    new: dict[str, int] | None,
) -> dict[str, int] | None:
    """Accumulator over two usage dicts; None-tolerant (reference ``util.py:606-626``)."""
    if current is None and new is None:
        return None
    if current is None:
        return new
    if new is None:
        return current
    return {key: current.get(key, 0) + new.get(key, 0) for key in {*current, *new}}
