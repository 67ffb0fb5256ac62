"""Live leaderboard web UI.

Role parity with the reference's Gradio leaderboard (``reporting/ui.py:117-308``,
single-dataset / cross-dataset / Borda tabs): gradio is not a dependency, so a
stdlib HTTP server renders the same three views. The report re-reads the
workspace catalogs on EVERY request, so refreshing the page after (or during)
an experiment run shows current numbers — the interactive property the Gradio
UI provides. The port's copy of the JAX package's ``reporting/ui.py``.
"""

from __future__ import annotations

import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Sequence

logger = logging.getLogger("AutoRAG-Research-TPU")


class ReportUIHandle:
    """A running leaderboard server; ``url`` and ``shutdown()``."""

    def __init__(self, workspaces: Sequence[str | Path], host: str = "127.0.0.1", port: int = 0):
        workspaces = [str(w) for w in workspaces]

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                from autorag_research_tpu_torch.reporting.html import render_html
                from autorag_research_tpu_torch.reporting.service import ReportingService

                if self.path not in ("/", "/index.html"):
                    self.send_error(404)
                    return
                try:
                    # fresh service per request -> live view of the catalogs
                    body = render_html(ReportingService(workspaces)).encode("utf-8")
                except Exception as exc:  # noqa: BLE001 - surface as 500
                    # the message goes into the HTTP STATUS LINE: newlines
                    # split the response and non-latin-1 raises inside the
                    # error handler — clamp to one short latin-1-safe line
                    msg = str(exc).splitlines()[0][:200] if str(exc) else ""
                    msg = msg.encode("latin-1", "replace").decode("latin-1")
                    self.send_error(500, msg or type(exc).__name__)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                logger.debug("report-ui: " + fmt, *args)

        class Server(ThreadingHTTPServer):
            daemon_threads = True
            request_queue_size = 64  # default backlog of 5 drops bursts

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self.url = f"http://{self.host}:{self.port}/"
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


def serve_report(
    workspaces: Sequence[str | Path], host: str = "127.0.0.1", port: int = 8090
) -> ReportUIHandle:
    return ReportUIHandle(workspaces, host=host, port=port)
