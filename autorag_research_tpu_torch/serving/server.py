"""HTTP serving layer: warm indexes + pipelines behind a JSON API.

The reference is a research harness with no serving story (experiments write
results to Postgres); this framework targets production serving, so a
workspace can be served directly: indexes load once into device HBM, the
embedding model stays warm, and queries batch through the device kernels.

Stdlib-only (ThreadingHTTPServer): no web framework in the image. Endpoints:

- ``GET  /health``            -> {"status": "ok", stats...}
- ``GET  /metrics``           -> Prometheus text exposition (request counts,
                              latency/batch-size histograms, queue depth)
- ``POST /search``            {"query" | "queries", "pipeline"?, "top_k"?}
                              -> {"results": [[{doc_id, score, content?}]]}
- ``POST /generate``          {"query" | "queries", "pipeline"?, "top_k"?}
                              -> {"text", ...} | {"results": [...]}

Micro-batching: concurrent /search requests within ``batch_window_ms``
coalesce into one device batch (the kernels are batch-first, so a batch
costs little more than one query). /generate batches the same way for
pipelines with a ``generate_batch_by_texts`` path (basic_rag): one batched
retrieval + one batched decode.

The port's copy of the JAX package's ``serving/server.py``. Pipelines build
on the ``device`` of :func:`serve_workspace` (``"cuda"`` unless the caller
asks for another), their indexes sharded over a mesh with ``mesh=True``.
Batches run in up to ``max_inflight`` threads on the default CUDA
stream, so their device work runs one batch at a time while the host work of
the others (tokenization, readback, result lists) overlaps it. ``/generate``
serves ``basic_rag`` (one batched retrieval and one batched ``TorchLM``
decode a micro-batch) and every other generation pipeline, one query at a
time.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from autorag_research_tpu_torch.utils.concurrency import run_async

logger = logging.getLogger("AutoRAG-Research-TPU")


class _HTTPServer(ThreadingHTTPServer):
    """socketserver's default listen backlog is 5 — concurrent client bursts
    overflow the accept queue and get connection resets. Raise it and don't
    block shutdown on in-flight handler threads."""

    daemon_threads = True
    request_queue_size = 128


@dataclass
class _SearchJob:
    query: str
    top_k: int
    done: threading.Event = field(default_factory=threading.Event)
    result: list[dict] | None = None
    error: str | None = None


class _Batcher:
    """Coalesces concurrent single-query searches into device batches.

    Up to ``max_inflight`` batches execute concurrently (default 3), so one
    batch's host work (tokenization, readback, building the hit lists)
    overlaps another's device work. Collection stays single-threaded; jobs
    carry their own completion events so batch completion order is
    irrelevant."""

    def __init__(
        self,
        search_batch_fn,
        batch_window_ms: float = 5.0,
        max_batch: int = 256,
        max_inflight: int = 3,
        truncatable: bool = True,
        metrics=None,
        metrics_labels: dict | None = None,
    ):
        self.search_batch_fn = search_batch_fn
        self.metrics = metrics
        self.metrics_labels = metrics_labels or {}
        # truncatable: running the whole batch at max(top_k) and slicing each
        # job's result to its own k is EXACT for ranked hit lists (/search).
        # Generation results are not sliceable — the answer is conditioned on
        # however many chunks were retrieved — so gen batchers set False and
        # jobs are grouped by top_k instead of coalesced across k.
        self.truncatable = truncatable
        self.window = batch_window_ms / 1000.0
        self.max_batch = max_batch
        self.jobs: queue.Queue[_SearchJob] = queue.Queue()
        self._inflight = threading.Semaphore(max(1, max_inflight))
        # the FIRST batch runs alone: it triggers registry.get_or_build, the
        # lazy to_device and the kernels' first-use build, so that later
        # batches find them built (each is also safe to race: the registry
        # and the indexes lock their lazy state)
        self._warmed = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._stop = False
        self._thread.start()

    def submit(self, job: _SearchJob) -> None:
        self.jobs.put(job)

    def stop(self) -> None:
        self._stop = True

    def _loop(self) -> None:
        while not self._stop:
            try:
                first = self.jobs.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.window
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.jobs.get(timeout=remaining))
                except queue.Empty:
                    break
            # zero-wait drain: requests that queued while the PREVIOUS batch
            # was on the device would otherwise be left for the next window,
            # convoying closed-loop clients into small batches. Scooping the
            # backlog costs no latency.
            while len(batch) < self.max_batch:
                try:
                    batch.append(self.jobs.get_nowait())
                except queue.Empty:
                    break
            self._inflight.acquire()
            if not self._warmed.is_set():
                self._run_batch(batch)  # synchronous: build/compile once
                continue
            threading.Thread(
                target=self._run_batch, args=(batch,), daemon=True
            ).start()

    def _run_batch(self, batch: list[_SearchJob]) -> None:
        if self.metrics is not None:
            from autorag_research_tpu_torch.serving.metrics import BATCH_BUCKETS

            self.metrics.observe(
                "autorag_batch_size",
                len(batch),
                self.metrics_labels,
                buckets=BATCH_BUCKETS,
                help_text="micro-batch sizes as collected (pre bucket padding)",
            )
            self.metrics.add_gauge(
                "autorag_batches_inflight",
                1,
                self.metrics_labels,
                help_text="device batches currently executing",
            )
        t0 = time.monotonic()
        try:
            if self.truncatable:
                groups = [(max(j.top_k for j in batch), batch)]
            else:
                by_k: dict[int, list[_SearchJob]] = {}
                for j in batch:
                    by_k.setdefault(j.top_k, []).append(j)
                groups = sorted(by_k.items())
            any_ok = False
            for top_k, jobs in groups:
                # pad to a power-of-two bucket, as the JAX package does to
                # bound its compiled shapes: buckets cap the shape count at
                # log2(max_batch) (whether the port needs it is open)
                queries = [j.query for j in jobs]
                bucket = 1 << (len(queries) - 1).bit_length()
                queries += [queries[-1]] * (bucket - len(queries))
                try:
                    results = self.search_batch_fn(queries, top_k)
                except Exception as exc:  # noqa: BLE001 - report to this group
                    # fail only THIS group's waiters: other per-k groups in the
                    # same batch may already hold (or still produce) results
                    for job in jobs:
                        job.error = f"{type(exc).__name__}: {exc}"
                    continue
                for job, res in zip(jobs, results):
                    # search results are hit lists (truncate to the job's own
                    # k); generation results are per-query dicts
                    job.result = res[: job.top_k] if isinstance(res, list) else res
                any_ok = True
            # warm only after a SUCCESSFUL device call: a failed first batch
            # (e.g. a client-shaped error before the index built) must not
            # unleash concurrent batches onto an unbuilt index / uncompiled
            # kernel; one successful group proves index+kernel are up
            if any_ok:
                self._warmed.set()
        except Exception as exc:  # noqa: BLE001 - batching logic itself failed
            for job in batch:
                if job.result is None and job.error is None:
                    job.error = f"{type(exc).__name__}: {exc}"
        finally:
            if self.metrics is not None:
                self.metrics.observe(
                    "autorag_batch_device_seconds",
                    time.monotonic() - t0,
                    self.metrics_labels,
                    help_text="wall time of one device batch (embed+kernel+readback)",
                )
                self.metrics.add_gauge(
                    "autorag_batches_inflight", -1, self.metrics_labels
                )
            self._inflight.release()
            for job in batch:
                job.done.set()


class ServingHandle:
    """A served workspace: pipelines + batcher + HTTP server lifecycle."""

    def __init__(
        self,
        catalog,
        retrieval_pipelines: dict[str, Any],
        generation_pipelines: dict[str, Any] | None = None,
        default_pipeline: str | None = None,
        batch_window_ms: float = 5.0,
        include_contents: bool = True,
        max_inflight: int = 3,
    ):
        if not retrieval_pipelines:
            raise ValueError("need at least one retrieval pipeline to serve")
        self.catalog = catalog
        self.retrieval_pipelines = retrieval_pipelines
        self.generation_pipelines = generation_pipelines or {}
        self.default_pipeline = default_pipeline or next(iter(retrieval_pipelines))
        self.include_contents = include_contents
        from autorag_research_tpu_torch.serving.metrics import ServingMetrics

        self.metrics = ServingMetrics()
        self._batchers = {
            name: _Batcher(
                self._make_batch_fn(pipe),
                batch_window_ms,
                max_inflight=max_inflight,
                metrics=self.metrics,
                metrics_labels={"pipeline": name, "kind": "search"},
            )
            for name, pipe in retrieval_pipelines.items()
        }
        # generation micro-batching: pipelines exposing a batched text path
        # (basic_rag-shaped: one retrieval + one LLM call) coalesce like
        # /search; agentic pipelines keep the single-query path
        self._gen_batchers = {
            name: _Batcher(
                self._make_gen_batch_fn(pipe), batch_window_ms, max_batch=32,
                truncatable=False,
                metrics=self.metrics,
                metrics_labels={"pipeline": name, "kind": "generate"},
            )
            for name, pipe in self.generation_pipelines.items()
            if hasattr(pipe, "generate_batch_by_texts")
        }
        self._server: ThreadingHTTPServer | None = None
        self.started = time.time()
        self.requests_served = 0
        self._served_lock = threading.Lock()  # handler threads add to the count

    def _make_batch_fn(self, pipeline):
        def run_batch(queries: list[str], top_k: int) -> list[list[dict]]:
            # device pipelines run the whole micro-batch as ONE embed + ONE
            # kernel launch; the base-class fallback fans out per query
            return pipeline._retrieve_batch_by_texts(queries, top_k)

        return run_batch

    def _make_gen_batch_fn(self, pipeline):
        def run_batch(queries: list[str], top_k: int) -> list[dict]:
            results = pipeline.generate_batch_by_texts(queries, top_k)
            return [
                {
                    "text": r.text,
                    "token_usage": r.token_usage,
                    "metadata": r.metadata,
                }
                for r in results
            ]

        return run_batch

    def _count_served(self, n: int) -> None:
        with self._served_lock:
            self.requests_served += n

    # ------------------------------------------------------------- operations
    def search(self, queries: list[str], top_k: int = 10, pipeline: str | None = None):
        name = pipeline or self.default_pipeline
        if name not in self._batchers:
            raise KeyError(f"unknown pipeline '{name}'; serving {sorted(self._batchers)}")
        jobs = [_SearchJob(q, top_k) for q in queries]
        for job in jobs:
            self._batchers[name].submit(job)
        out = []
        for job in jobs:
            finished = job.done.wait(timeout=600)
            if not finished:
                raise RuntimeError(
                    "search timed out (kernel build in progress or batcher "
                    "stalled); retry shortly"
                )
            if job.error:
                raise RuntimeError(job.error)
            hits = job.result or []
            if self.include_contents:
                lookup = self.catalog.get_chunk_contents([h["doc_id"] for h in hits])
                hits = [
                    {**h, "content": lookup.get(h["doc_id"])} for h in hits
                ]
            out.append(hits)
        self._count_served(len(queries))
        return out

    def generate_batch(
        self, queries: list[str], top_k: int = 5, pipeline: str | None = None
    ) -> list[dict]:
        """Micro-batched generation: concurrent requests coalesce into one
        batched retrieval + one batched decode. Falls back to sequential
        single-query generation for pipelines without a batch path."""
        if not self.generation_pipelines:
            raise KeyError("no generation pipelines are being served")
        name = pipeline or next(iter(self.generation_pipelines))
        if name not in self.generation_pipelines:
            raise KeyError(f"unknown generation pipeline '{name}'")
        batcher = self._gen_batchers.get(name)
        if batcher is None:
            return [self.generate(q, top_k, name) for q in queries]
        jobs = [_SearchJob(q, top_k) for q in queries]
        for job in jobs:
            batcher.submit(job)
        out = []
        for job in jobs:
            if not job.done.wait(timeout=600):
                raise RuntimeError("generate timed out (kernel build in progress?); retry")
            if job.error:
                raise RuntimeError(job.error)
            out.append(job.result)
        self._count_served(len(queries))
        return out

    def generate(self, query: str, top_k: int = 5, pipeline: str | None = None) -> dict:
        if not self.generation_pipelines:
            raise KeyError("no generation pipelines are being served")
        name = pipeline or next(iter(self.generation_pipelines))
        pipe = self.generation_pipelines.get(name)
        if pipe is None:
            raise KeyError(f"unknown generation pipeline '{name}'")
        # serve ad-hoc queries: temporary retrieval by text through the
        # pipeline's composed retriever
        rows = self.catalog.find_queries_by_contents(query)
        if rows:
            result = run_async(pipe._generate(rows[0]["id"], top_k))
        else:
            # ad-hoc: stage under a per-request unique id (a content hash
            # would race concurrent requests and collide across texts),
            # generate, then clean it up
            import uuid

            qid = f"__serve_{uuid.uuid4().hex}"
            self.catalog.add_queries([{"id": qid, "contents": query}])
            try:
                result = run_async(pipe._generate(qid, top_k))
            finally:
                with self.catalog.connect() as conn:
                    conn.execute("DELETE FROM query WHERE id=?", (qid,))
        self._count_served(1)
        return {
            "text": result.text,
            "token_usage": result.token_usage,
            "metadata": result.metadata,
        }

    def warmup(
        self,
        max_bucket: int = 256,
        top_k: int = 10,
        gen_max_bucket: int = 32,
        gen_top_k: int = 5,
    ) -> None:
        """Run every micro-batch bucket size (1, 2, 4, ... max_bucket) once
        so that no live request pays a first call: the index build and
        upload, the kernels' first-use build and each shape's first launch.
        Batched generation pipelines warm their decode buckets too.
        ``gen_top_k`` defaults to the /generate endpoint default, the k live
        requests use."""
        for name in self.retrieval_pipelines:
            fn = self._batchers[name].search_batch_fn
            b = 1
            while b <= max_bucket:
                fn([f"warmup query {i}" for i in range(b)], top_k)
                b <<= 1
            logger.info("warmed pipeline '%s' through bucket %d", name, max_bucket)
        for name, batcher in self._gen_batchers.items():
            fn = batcher.search_batch_fn
            b = 1
            while b <= gen_max_bucket:
                fn([f"warmup query {i}" for i in range(b)], gen_top_k)
                b <<= 1
            logger.info("warmed generation '%s' through bucket %d", name, gen_max_bucket)

    def _refresh_gauges(self) -> None:
        """Point-in-time gauges sampled at scrape time (not on the hot path)."""
        self.metrics.set_gauge(
            "autorag_uptime_seconds",
            round(time.time() - self.started, 3),
            help_text="seconds since the handle was constructed",
        )
        self.metrics.set_gauge(
            "autorag_corpus_docs",
            self.catalog.count("chunk"),
            help_text="documents in the served corpus",
        )
        for kind, group in (("search", self._batchers), ("generate", self._gen_batchers)):
            for name, batcher in group.items():
                self.metrics.set_gauge(
                    "autorag_queue_depth",
                    batcher.jobs.qsize(),
                    {"pipeline": name, "kind": kind},
                    help_text="jobs waiting for a micro-batch slot",
                )

    def health(self) -> dict:
        return {
            "status": "ok",
            "uptime_sec": round(time.time() - self.started, 1),
            "requests_served": self.requests_served,
            "retrieval_pipelines": sorted(self.retrieval_pipelines),
            "generation_pipelines": sorted(self.generation_pipelines),
            "corpus": self.catalog.count("chunk"),
        }

    # ------------------------------------------------------------------- HTTP
    def start(self, host: str = "127.0.0.1", port: int = 8080) -> "ServingHandle":
        handle = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to our logger
                logger.debug("http: " + fmt, *args)

            def _send(self, code: int, payload: dict) -> None:
                self._sent_code = code
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            _KNOWN_ENDPOINTS = frozenset(
                {"/health", "/metrics", "/search", "/generate"}
            )

            def _record(self, t0: float) -> None:
                # clamp the label to the known endpoint set: the raw path is
                # client-controlled, and every distinct 404 path would mint a
                # new label series (unbounded scrape cardinality)
                endpoint = self.path.split("?")[0]
                if endpoint not in self._KNOWN_ENDPOINTS:
                    endpoint = "other"
                code = str(getattr(self, "_sent_code", 500))
                handle.metrics.inc(
                    "autorag_requests_total",
                    {"endpoint": endpoint, "code": code},
                    help_text="HTTP requests by endpoint and status code",
                )
                handle.metrics.observe(
                    "autorag_request_latency_seconds",
                    time.monotonic() - t0,
                    {"endpoint": endpoint},
                    help_text="request wall time incl. batching wait",
                )

            def do_GET(self):
                t0 = time.monotonic()
                if self.path == "/health":
                    self._send(200, handle.health())
                elif self.path == "/metrics":
                    handle._refresh_gauges()
                    body = handle.metrics.render().encode()
                    self._sent_code = 200
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
                self._record(t0)

            def do_POST(self):
                t0 = time.monotonic()
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError) as exc:
                    self._send(400, {"error": f"bad request body: {exc}"})
                    self._record(t0)
                    return
                try:
                    if self.path == "/search":
                        queries = payload.get("queries")
                        if queries is None:
                            queries = [payload["query"]]
                        elif not isinstance(queries, list):
                            # a plain string would iterate per CHARACTER and
                            # fan one device search out per letter
                            raise ValueError(
                                f"'queries' must be a list, got {type(queries).__name__}"
                            )
                        top_k = int(payload.get("top_k", 10))
                        if top_k < 1:
                            self._send(400, {"error": f"top_k must be >= 1, got {top_k}"})
                            return
                        results = handle.search(
                            queries,
                            top_k=top_k,
                            pipeline=payload.get("pipeline"),
                        )
                        self._send(200, {"results": results})
                    elif self.path == "/generate":
                        queries = payload.get("queries")
                        if queries is not None and not isinstance(queries, list):
                            raise ValueError(
                                f"'queries' must be a list, got {type(queries).__name__}"
                            )
                        if queries is not None:
                            outs = handle.generate_batch(
                                queries,
                                top_k=int(payload.get("top_k", 5)),
                                pipeline=payload.get("pipeline"),
                            )
                            self._send(200, {"results": outs})
                        else:
                            # single queries still ride the micro-batcher so
                            # CONCURRENT /generate requests share one decode
                            out = handle.generate_batch(
                                [payload["query"]],
                                top_k=int(payload.get("top_k", 5)),
                                pipeline=payload.get("pipeline"),
                            )[0]
                            self._send(200, out)
                    else:
                        self._send(404, {"error": f"unknown path {self.path}"})
                except KeyError as exc:
                    self._send(400, {"error": f"missing field {exc}"})
                except (ValueError, TypeError) as exc:
                    # client-shaped errors (e.g. non-integer top_k) are 400s,
                    # not server faults
                    self._send(400, {"error": f"bad request: {exc}"})
                except Exception as exc:  # noqa: BLE001
                    logger.exception("serving error")
                    self._send(500, {"error": f"{type(exc).__name__}: {exc}"})
                finally:
                    self._record(t0)

        self._server = _HTTPServer((host, port), Handler)
        thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        thread.start()
        logger.info("serving on http://%s:%d", host, port)
        return self

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.server_address[1]

    def stop(self) -> None:
        # shut the HTTP listener down FIRST so no new jobs arrive, then stop
        # the batchers and fail anything still queued — a job stranded in a
        # stopped batcher's queue would leave its handler thread blocked in
        # job.done.wait for the full timeout
        if self._server is not None:
            self._server.shutdown()
            self._server = None
        for b in list(self._batchers.values()) + list(self._gen_batchers.values()):
            b.stop()
            while True:
                try:
                    job = b.jobs.get_nowait()
                except queue.Empty:
                    break
                job.error = "server shutting down"
                job.done.set()


def serve_workspace(
    db: str,
    config_path: str = "./configs",
    retrieval: list[str] | None = None,
    generation: list[str] | None = None,
    host: str = "127.0.0.1",
    port: int = 8080,
    mesh: bool = False,
    device: str = "cuda",
) -> ServingHandle:
    """Build pipelines from the config tree on ``device`` and serve a
    workspace; ``mesh=True`` shards the indexes over
    ``parallel/mesh.py::device_corpus_mesh(device)`` (every visible card for
    ``cuda``; one device runs unsharded)."""
    from pathlib import Path

    from autorag_research_tpu_torch.cli.config_resolver import ConfigResolver
    from autorag_research_tpu_torch.config import BuildContext
    from autorag_research_tpu_torch.injection import ModelRegistry
    from autorag_research_tpu_torch.pipelines.loader import PipelineLoader
    from autorag_research_tpu_torch.store.catalog import Catalog

    path = Path(db)
    catalog = Catalog(path / "catalog.db" if path.is_dir() or not path.suffix else path)
    resolver = ConfigResolver(config_path)
    retrieval = retrieval or resolver.all_pipeline_names("retrieval")[:1]
    generation = generation or []

    mesh_obj = None
    if mesh:
        from autorag_research_tpu_torch.parallel.mesh import device_corpus_mesh

        mesh_obj = device_corpus_mesh(device)
    configs = {}
    for kind, names in (("retrieval", retrieval), ("generation", generation)):
        for name in names:
            configs[name] = resolver.resolve_pipeline(kind, name)
    context = BuildContext(
        device=device, models=ModelRegistry(config_path, device=device), pipeline_configs=configs,
        mesh=mesh_obj,
    )
    loader = PipelineLoader(catalog, context)
    # one dependency-resolution implementation (ConfigResolver) for both
    # experiments and serving
    context.pipeline_configs.update(
        resolver.resolve_transitive_dependencies(configs)
    )

    r_pipes = {name: loader.load(name) for name in retrieval}
    g_pipes = {name: loader.load(name) for name in generation}
    handle = ServingHandle(catalog, r_pipes, g_pipes)
    return handle.start(host, port)
