"""Leaderboard analytics over one or more workspace catalogs.

Role parity with the reference reporting service
(``reporting/service.py:13-540``, DuckDB-over-Postgres): pandas over the
SQLite catalogs instead. Capabilities: per-dataset leaderboard
(pipeline x metric averages), cross-dataset comparison, Borda-count
multi-metric ranking (``service.py:450-526``), and raw SQL passthrough.
The port's copy of the JAX package's ``reporting/service.py``.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path
from typing import Sequence

import pandas as pd


def _catalog_file(path: Path) -> Path:
    return path / "catalog.db" if path.is_dir() else path


class ReportingService:
    def __init__(self, workspaces: Sequence[str | Path]):
        # label each workspace by its basename, disambiguating collisions
        # with parent path segments — two workspaces that both end in
        # ".../ws" must not silently overwrite each other in the dict
        self.workspaces: dict[str, Path] = {}
        for w in workspaces:
            p = Path(w)
            base = p.stem if p.is_file() else p.name
            name, parts = base, p.resolve().parts
            depth = 2
            while name in self.workspaces and depth <= len(parts):
                name = "/".join(parts[-depth:])
                depth += 1
            while name in self.workspaces:  # identical resolved paths
                name += "+"
            self.workspaces[name] = _catalog_file(p)

    def query(self, workspace: str, sql: str) -> pd.DataFrame:
        """Raw SQL passthrough against one workspace catalog."""
        with sqlite3.connect(self.workspaces[workspace]) as conn:
            return pd.read_sql_query(sql, conn)

    def _results_frame(self, name: str, path: Path) -> pd.DataFrame:
        sql = """
            SELECT p.name AS pipeline, m.name AS metric, m.type AS metric_type,
                   AVG(e.value) AS average, COUNT(e.value) AS query_cnt
            FROM evaluation_result e
            JOIN pipeline p ON p.id = e.pipeline_id
            JOIN metric m ON m.id = e.metric_id
            WHERE e.value IS NOT NULL
            GROUP BY p.name, m.name, m.type
        """
        with sqlite3.connect(path) as conn:
            df = pd.read_sql_query(sql, conn)
        df.insert(0, "dataset", name)
        return df

    def results(self) -> pd.DataFrame:
        frames = [self._results_frame(n, p) for n, p in self.workspaces.items() if p.exists()]
        if not frames:
            return pd.DataFrame(
                columns=["dataset", "pipeline", "metric", "metric_type", "average", "query_cnt"]
            )
        return pd.concat(frames, ignore_index=True)

    def leaderboard(self, dataset: str | None = None, metric: str | None = None) -> pd.DataFrame:
        """Wide leaderboard: one row per (dataset, pipeline), metric columns."""
        df = self.results()
        if df.empty:
            return df
        if dataset:
            df = df[df.dataset == dataset]
        if metric:
            df = df[df.metric == metric]
        wide = df.pivot_table(
            index=["dataset", "pipeline"], columns="metric", values="average"
        ).reset_index()
        wide.columns.name = None
        return wide.round(4)

    def cross_dataset(self, metric: str) -> pd.DataFrame:
        """One metric compared across datasets: pipeline rows, dataset cols."""
        df = self.results()
        df = df[df.metric == metric]
        if df.empty:
            return df
        wide = df.pivot_table(index="pipeline", columns="dataset", values="average").reset_index()
        wide.columns.name = None
        return wide.round(4)

    def borda_ranking(self, dataset: str | None = None, metrics: Sequence[str] | None = None) -> pd.DataFrame:
        """Borda-count multi-metric ranking (reference ``service.py:450-526``):
        per metric, pipelines earn (n_pipelines - rank) points; totals order
        the final leaderboard."""
        df = self.results()
        if dataset:
            df = df[df.dataset == dataset]
        if metrics:
            df = df[df.metric.isin(list(metrics))]
        if df.empty:
            return pd.DataFrame(columns=["pipeline", "borda_points", "metrics_counted"])
        points: dict[str, float] = {}
        counted: dict[str, int] = {}
        for (_, _), group in df.groupby(["dataset", "metric"]):
            ranked = group.sort_values("average", ascending=False).reset_index()
            n = len(ranked)
            for rank, row in ranked.iterrows():
                points[row.pipeline] = points.get(row.pipeline, 0.0) + (n - rank - 1)
                counted[row.pipeline] = counted.get(row.pipeline, 0) + 1
        out = pd.DataFrame(
            {
                "pipeline": list(points),
                "borda_points": [points[p] for p in points],
                "metrics_counted": [counted[p] for p in points],
            }
        )
        return out.sort_values("borda_points", ascending=False).reset_index(drop=True)

    def summary(self) -> pd.DataFrame:
        """Fallback to the persisted Summary table (reference legacy CTE
        ``service.py:66-95``)."""
        frames = []
        for name, path in self.workspaces.items():
            if not path.exists():
                continue
            with sqlite3.connect(path) as conn:
                df = pd.read_sql_query(
                    """
                    SELECT p.name AS pipeline, m.name AS metric, s.value, s.query_cnt
                    FROM summary s
                    JOIN pipeline p ON p.id = s.pipeline_id
                    JOIN metric m ON m.id = s.metric_id
                    """,
                    conn,
                )
            df.insert(0, "dataset", name)
            frames.append(df)
        return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()
