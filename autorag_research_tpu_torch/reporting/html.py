"""Static HTML leaderboard report.

The reference ships a Gradio UI (``reporting/ui.py:117-308``) with
single-dataset / cross-dataset / Borda tabs; gradio is not a dependency,
so the same three views render to a self-contained HTML file (plus the
console output of ``cli report``). The port's copy of the JAX package's
``reporting/html.py``.
"""

from __future__ import annotations

from pathlib import Path

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>AutoRAG-Research-TPU leaderboard</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem; color: #1a1a2e; }}
 h1 {{ font-size: 1.4rem; }} h2 {{ font-size: 1.1rem; margin-top: 2rem; }}
 table {{ border-collapse: collapse; margin-top: .5rem; }}
 th, td {{ border: 1px solid #d0d0e0; padding: .35rem .7rem; font-size: .9rem; }}
 th {{ background: #f0f0f8; text-align: left; }}
 tr:nth-child(even) td {{ background: #fafaff; }}
</style></head>
<body>
<h1>AutoRAG-Research-TPU leaderboard</h1>
<h2>Per-dataset leaderboard</h2>{leaderboard}
<h2>Borda multi-metric ranking</h2>{borda}
{cross_sections}
</body></html>
"""


def render_html(service) -> str:
    """Render the three reference-UI views (leaderboard / Borda /
    cross-dataset) to one self-contained page."""
    lb = service.leaderboard()
    borda = service.borda_ranking()
    cross_sections = []
    if not lb.empty:
        metric_cols = [c for c in lb.columns if c not in ("dataset", "pipeline")]
        for metric in metric_cols:
            cross = service.cross_dataset(metric)
            if not cross.empty and cross.shape[1] > 2:
                cross_sections.append(
                    f"<h2>Cross-dataset: {metric}</h2>" + cross.to_html(index=False)
                )
    return _PAGE.format(
        leaderboard=lb.to_html(index=False) if not lb.empty else "<p>(empty)</p>",
        borda=borda.to_html(index=False) if not borda.empty else "<p>(empty)</p>",
        cross_sections="\n".join(cross_sections),
    )


def write_html_report(service, out_path: Path) -> Path:
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(render_html(service))
    return out_path
