"""Async concurrency control and retry for batch engines.

Role parity with the reference's ``run_with_concurrency_limit``/``LoopBoundSemaphore``
(``util.py:30-50, 184-246``) and its tenacity retry wrapper
(``orm/service/retrieval_pipeline.py:222-236``): fan out per-query coroutines
under a semaphore, retry transient failures with exponential backoff, and
collect per-item exceptions without failing the whole batch.
"""

from __future__ import annotations

import asyncio
import logging
import random
import threading
from collections.abc import Awaitable, Callable, Sequence
from dataclasses import dataclass
from typing import Any, TypeVar

logger = logging.getLogger("AutoRAG-Research-TPU")

T = TypeVar("T")

_COUNT_LOCK = threading.Lock()


def count_call(counts: dict[str, int], name: str) -> None:
    """Add one to ``counts[name]``. The kernels' launch and plain-call
    counters are shared by every thread of the process (a server's batch
    threads among them), and ``+=`` on a dict entry is a read-modify-write
    that the interpreter lock does not make atomic."""
    with _COUNT_LOCK:
        counts[name] += 1


@dataclass
class RetryPolicy:
    max_attempts: int = 3
    base_delay: float = 0.5
    max_delay: float = 10.0
    jitter: float = 0.1

    def delay(self, attempt: int) -> float:
        d = min(self.base_delay * (2**attempt), self.max_delay)
        return d + random.random() * self.jitter


async def _with_retry(
    func: Callable[[], Awaitable[T]],
    policy: RetryPolicy,
) -> T:
    last_exc: BaseException | None = None
    for attempt in range(policy.max_attempts):
        try:
            return await func()
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 - deliberate catch-all with retry
            last_exc = exc
            if attempt + 1 < policy.max_attempts:
                await asyncio.sleep(policy.delay(attempt))
    assert last_exc is not None
    raise last_exc


async def run_with_concurrency_limit(
    items: Sequence[Any],
    worker: Callable[[Any], Awaitable[T]],
    max_concurrency: int = 16,
    retry: RetryPolicy | None = None,
    return_exceptions: bool = True,
) -> list[T | BaseException]:
    """Run ``worker(item)`` for every item, at most ``max_concurrency`` at a time.

    Returns results in input order. When ``return_exceptions``, failed items
    yield their exception object instead of raising (the caller partitions
    success/failure, as the reference batch engines do at
    ``orm/service/retrieval_pipeline.py:299-307``).
    """
    semaphore = asyncio.Semaphore(max_concurrency)
    policy = retry or RetryPolicy(max_attempts=1)

    async def bounded(item: Any) -> T:
        async with semaphore:
            return await _with_retry(lambda: worker(item), policy)

    tasks = [asyncio.create_task(bounded(item)) for item in items]
    return await asyncio.gather(*tasks, return_exceptions=return_exceptions)


def run_async(coro: Awaitable[T]) -> T:
    """Run a coroutine from sync code, tolerating an already-running loop."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)  # type: ignore[arg-type]
    # Inside a running loop (e.g. Jupyter): execute in a private thread.
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        return pool.submit(asyncio.run, coro).result()  # type: ignore[arg-type]
