"""Metric decorator framework.

Behavioral parity with the reference ``evaluation/metrics/util.py:53-138``:
``@metric(fields)`` lifts a per-input scorer to a batch function over
``list[MetricInput]`` emitting ``None`` for rows whose required fields are
missing/empty; ``@metric_loop(fields)`` does the same for whole-batch scorers
(valid rows are extracted, scored together, and scattered back in order).
"""

from __future__ import annotations

import functools
from collections.abc import Callable

import numpy as np

from autorag_research_tpu_torch.schema import MetricInput


def to_input_list(inputs) -> list[MetricInput]:
    if isinstance(inputs, MetricInput):
        return [inputs]
    return list(inputs)


def metric(fields_to_check: list[str]) -> Callable:
    """Per-input metric decorator: fn(MetricInput, **kw) -> float."""

    def decorator(func: Callable) -> Callable:
        @functools.wraps(func)
        def wrapper(metric_inputs, **kwargs) -> list[float | None]:
            results: list[float | None] = []
            for mi in to_input_list(metric_inputs):
                if mi.is_fields_notnone(fields_to_check=fields_to_check):
                    results.append(func(mi, **kwargs))
                else:
                    results.append(None)
            return results

        wrapper.__wrapped__ = func
        return wrapper

    return decorator


def metric_loop(fields_to_check: list[str]) -> Callable:
    """Whole-batch metric decorator: fn(list[MetricInput], **kw) -> list[float]."""

    def decorator(func: Callable) -> Callable:
        @functools.wraps(func)
        def wrapper(metric_inputs, **kwargs) -> list[float | None]:
            inputs = to_input_list(metric_inputs)
            valid_mask = [mi.is_fields_notnone(fields_to_check=fields_to_check) for mi in inputs]
            valid_inputs = [mi for mi, ok in zip(inputs, valid_mask) if ok]
            results: list[float | None] = [None] * len(inputs)
            if valid_inputs:
                scored = func(valid_inputs, **kwargs)
                it = iter(scored)
                for i, ok in enumerate(valid_mask):
                    if ok:
                        results[i] = next(it)
            return results

        wrapper.__wrapped__ = func
        return wrapper

    return decorator


def calculate_cosine_similarity(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    if denom == 0:
        return 0.0
    return float(np.dot(a, b) / denom)
