"""Embedded relational catalog: the framework's replacement for Postgres.

The reference keeps *everything* — corpus, queries, ground truth, pipelines,
per-query results, evaluation scores — in PostgreSQL behind a 4-layer
ORM/repository/UoW/service stack (``orm/schema_factory.py:31-399``,
``orm/repository/*``, ``orm/uow/*``). In this design the *math* lives in
device-resident indexes, so the catalog only needs to be a durable, resumable
metadata + result store. One SQLite file (WAL mode) with a direct API replaces
those four layers; embeddings are stored as raw float32 BLOBs and bulk-exported
to numpy for index builds.

Identical semantics preserved:
- logical tables (File/Document/Page/Chunk/ImageChunk/Query/RetrievalRelation/
  Pipeline/Metric/ExecutorResult/EvaluationResult/ChunkRetrievedResult/
  ImageChunkRetrievedResult/Summary);
- resume-by-result-presence (``orm/service/retrieval_pipeline.py:269-273``);
- duplicate-skip bulk inserts (``orm/repository/base.py:158-190``);
- AND/OR + graded-score GT rows (``orm/schema_factory.py:234-256``);
- NUL-byte sanitization on text (``orm/repository/base.py:25-51``).

SQLite is dynamically typed, so integer and string primary keys both work with
one schema (the reference generates two ORM variants for this,
``schema_factory.py:31``).
"""

from __future__ import annotations

import json
import sqlite3
import threading
from pathlib import Path
from typing import Any, Iterable, Sequence

import numpy as np

from autorag_research_tpu_torch.exceptions import DuplicateRetrievalGTError, StoreError
from autorag_research_tpu_torch.store.gt import RetrievalGT, gt_to_relation_rows

_SCHEMA = """
CREATE TABLE IF NOT EXISTS meta (key TEXT PRIMARY KEY, value TEXT);
CREATE TABLE IF NOT EXISTS file (
    id NOT NULL PRIMARY KEY, path TEXT, metadata TEXT);
CREATE TABLE IF NOT EXISTS document (
    id NOT NULL PRIMARY KEY, file_id, title TEXT, metadata TEXT);
CREATE TABLE IF NOT EXISTS page (
    id NOT NULL PRIMARY KEY, document_id, page_number INTEGER,
    metadata TEXT);
CREATE TABLE IF NOT EXISTS chunk (
    id NOT NULL PRIMARY KEY, document_id, contents TEXT, metadata TEXT,
    embedding BLOB, multi_embedding BLOB, multi_embedding_count INTEGER);
CREATE TABLE IF NOT EXISTS image_chunk (
    id NOT NULL PRIMARY KEY, page_id, image BLOB, mimetype TEXT, metadata TEXT,
    embedding BLOB, multi_embedding BLOB, multi_embedding_count INTEGER);
CREATE TABLE IF NOT EXISTS page_chunk_relation (
    page_id, chunk_id, PRIMARY KEY (page_id, chunk_id));
CREATE TABLE IF NOT EXISTS query (
    id NOT NULL PRIMARY KEY, contents TEXT, query_to_llm TEXT,
    generation_gt TEXT, metadata TEXT,
    embedding BLOB, multi_embedding BLOB, multi_embedding_count INTEGER);
CREATE TABLE IF NOT EXISTS retrieval_relation (
    query_id NOT NULL, group_index INTEGER NOT NULL, group_order INTEGER NOT NULL,
    chunk_id, image_chunk_id, score INTEGER,
    PRIMARY KEY (query_id, group_index, group_order),
    CHECK ((chunk_id IS NULL) != (image_chunk_id IS NULL)));
CREATE TABLE IF NOT EXISTS pipeline (
    id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT UNIQUE NOT NULL, config TEXT);
CREATE TABLE IF NOT EXISTS metric (
    id INTEGER PRIMARY KEY AUTOINCREMENT, name TEXT NOT NULL, type TEXT NOT NULL,
    UNIQUE (name, type));
CREATE TABLE IF NOT EXISTS chunk_retrieved_result (
    query_id NOT NULL, pipeline_id INTEGER NOT NULL, chunk_id NOT NULL,
    rel_score REAL, PRIMARY KEY (query_id, pipeline_id, chunk_id));
CREATE TABLE IF NOT EXISTS image_chunk_retrieved_result (
    query_id NOT NULL, pipeline_id INTEGER NOT NULL, image_chunk_id NOT NULL,
    rel_score REAL, PRIMARY KEY (query_id, pipeline_id, image_chunk_id));
CREATE TABLE IF NOT EXISTS executor_result (
    query_id NOT NULL, pipeline_id INTEGER NOT NULL,
    generation_result TEXT, token_usage TEXT, execution_time REAL,
    result_metadata TEXT, PRIMARY KEY (query_id, pipeline_id));
CREATE TABLE IF NOT EXISTS evaluation_result (
    query_id NOT NULL, pipeline_id INTEGER NOT NULL, metric_id INTEGER NOT NULL,
    value REAL, PRIMARY KEY (query_id, pipeline_id, metric_id));
CREATE TABLE IF NOT EXISTS summary (
    pipeline_id INTEGER NOT NULL, metric_id INTEGER NOT NULL,
    value REAL, query_cnt INTEGER, PRIMARY KEY (pipeline_id, metric_id));
CREATE INDEX IF NOT EXISTS idx_crr_pipeline ON chunk_retrieved_result (pipeline_id);
CREATE INDEX IF NOT EXISTS idx_icrr_pipeline ON image_chunk_retrieved_result (pipeline_id);
CREATE INDEX IF NOT EXISTS idx_rel_query ON retrieval_relation (query_id);
CREATE INDEX IF NOT EXISTS idx_eval_pm ON evaluation_result (pipeline_id, metric_id);
"""


def _clean_text(value: Any) -> Any:
    """Strip NUL bytes from strings (reference sanitizer ``base.py:25-51``)."""
    if isinstance(value, str) and "\x00" in value:
        return value.replace("\x00", "")
    return value


def _to_blob(vec: Sequence[float] | np.ndarray | None) -> bytes | None:
    if vec is None:
        return None
    return np.asarray(vec, dtype=np.float32).tobytes()



class Catalog:
    """Direct-API relational catalog over one SQLite database."""

    EMBEDDABLE_TABLES = ("chunk", "image_chunk", "query")

    def __init__(self, path: str | Path = ":memory:", embedding_dim: int | None = None):
        self._tmpdir = None
        if str(path) == ":memory:":
            # ephemeral catalogs back onto a temp FILE, not sqlite's
            # per-connection :memory: — a single shared in-memory connection
            # would interleave transactions across threads (one thread's
            # `with conn` commit/rollback landing mid-way through another's)
            import tempfile

            self._tmpdir = tempfile.TemporaryDirectory(prefix="autorag_catalog_")
            path = Path(self._tmpdir.name) / "catalog.db"
        self.path = str(path)
        self._local = threading.local()
        self._all_conns: list = []  # every thread's connection, for close()
        self._conns_lock = threading.Lock()
        with self.connect() as conn:
            conn.executescript(_SCHEMA)
        if embedding_dim is not None:
            self.set_meta("embedding_dim", str(embedding_dim))

    # ------------------------------------------------------------------ conn
    def _new_conn(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.path, check_same_thread=False)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        conn.execute("PRAGMA foreign_keys=ON")
        return conn

    def connect(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._new_conn()
            self._local.conn = conn
            with self._conns_lock:
                self._all_conns.append(conn)
        return conn

    def close(self) -> None:
        # close EVERY thread's connection (threading.local only exposes the
        # caller's): serving/executor worker threads would otherwise leak fds
        # and the tmpdir cleanup below would unlink files still held open
        with self._conns_lock:
            conns, self._all_conns = self._all_conns, []
        for conn in conns:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 - already closed / in use
                pass
        self._local.conn = None
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None

    # ------------------------------------------------------------------ meta
    def set_meta(self, key: str, value: str) -> None:
        with self.connect() as conn:
            conn.execute(
                "INSERT INTO meta (key, value) VALUES (?, ?) "
                "ON CONFLICT(key) DO UPDATE SET value=excluded.value",
                (key, value),
            )

    def get_meta(self, key: str, default: str | None = None) -> str | None:
        row = self.connect().execute("SELECT value FROM meta WHERE key=?", (key,)).fetchone()
        return row["value"] if row else default

    @property
    def embedding_dim(self) -> int | None:
        """Auto-detected like the reference's pg_attribute probe (``connection.py:94-152``)."""
        v = self.get_meta("embedding_dim")
        return int(v) if v else None

    @embedding_dim.setter
    def embedding_dim(self, dim: int) -> None:
        self.set_meta("embedding_dim", str(dim))

    # ----------------------------------------------------------------- files
    def add_files(self, rows: Iterable[dict]) -> None:
        self._bulk_insert("file", ["id", "path", "metadata"], rows)

    def add_documents(self, rows: Iterable[dict]) -> None:
        self._bulk_insert("document", ["id", "file_id", "title", "metadata"], rows)

    def add_pages(self, rows: Iterable[dict]) -> None:
        self._bulk_insert("page", ["id", "document_id", "page_number", "metadata"], rows)

    # ---------------------------------------------------------------- chunks
    def add_chunks(self, rows: Iterable[dict]) -> int:
        """Bulk insert chunks, skipping duplicates. Row keys: id, contents,
        optional document_id/metadata/embedding (list|ndarray)."""
        return self._bulk_insert(
            "chunk",
            ["id", "document_id", "contents", "metadata", "embedding"],
            rows,
            blob_cols={"embedding"},
        )

    def add_image_chunks(self, rows: Iterable[dict]) -> int:
        return self._bulk_insert(
            "image_chunk",
            ["id", "page_id", "image", "mimetype", "metadata", "embedding"],
            rows,
            blob_cols={"embedding"},
        )

    def add_queries(self, rows: Iterable[dict]) -> int:
        """Row keys: id, contents, optional query_to_llm/generation_gt(list)/metadata."""
        prepared = []
        for r in rows:
            r = dict(r)
            gt = r.get("generation_gt")
            if gt is not None and not isinstance(gt, str):
                r["generation_gt"] = json.dumps(gt, ensure_ascii=False)
            prepared.append(r)
        return self._bulk_insert(
            "query",
            ["id", "contents", "query_to_llm", "generation_gt", "metadata", "embedding"],
            prepared,
            blob_cols={"embedding"},
        )

    def _bulk_insert(
        self,
        table: str,
        cols: list[str],
        rows: Iterable[dict],
        blob_cols: set[str] | None = None,
        chunk_size: int = 2000,
    ) -> int:
        rows = list(rows)
        if not rows:
            return 0
        blob_cols = blob_cols or set()
        placeholders = ",".join("?" for _ in cols)
        sql = f"INSERT OR IGNORE INTO {table} ({','.join(cols)}) VALUES ({placeholders})"
        inserted = 0
        with self.connect() as conn:
            for start in range(0, len(rows), chunk_size):
                batch = []
                for row in rows[start : start + chunk_size]:
                    values = []
                    for col in cols:
                        v = row.get(col)
                        if col in blob_cols:
                            v = _to_blob(v)
                        elif col == "metadata" and isinstance(v, dict):
                            v = json.dumps(v, ensure_ascii=False)
                        else:
                            v = _clean_text(v)
                        values.append(v)
                    batch.append(tuple(values))
                cur = conn.executemany(sql, batch)
                inserted += cur.rowcount if cur.rowcount > 0 else 0
        return inserted

    # ------------------------------------------------------------ embeddings
    def set_embeddings(self, table: str, items: Iterable[tuple[Any, Any]]) -> None:
        """items: (row_id, vector). Single-vector write path."""
        self._check_table(table)
        with self.connect() as conn:
            conn.executemany(
                f"UPDATE {table} SET embedding=? WHERE id=?",
                [(_to_blob(vec), rid) for rid, vec in items],
            )

    def set_multi_embeddings(self, table: str, items: Iterable[tuple[Any, Any]]) -> None:
        """items: (row_id, [n_vec, dim] array). Multi-vector (late interaction) path.

        Reference analogue: PG ``VECTOR(dim)[]`` array-literal writes
        (``orm/repository/base.py:428-485``).
        """
        self._check_table(table)
        prepared = []
        for rid, vecs in items:
            arr = np.asarray(vecs, dtype=np.float32)
            if arr.ndim != 2:
                raise StoreError(f"multi-vector for {rid} must be 2-D, got {arr.shape}")
            prepared.append((arr.tobytes(), int(arr.shape[0]), rid))
        with self.connect() as conn:
            conn.executemany(
                f"UPDATE {table} SET multi_embedding=?, multi_embedding_count=? WHERE id=?",
                prepared,
            )

    def count_unembedded(self, table: str, multi: bool = False) -> int:
        self._check_table(table)
        col = "multi_embedding" if multi else "embedding"
        extra = " AND contents IS NOT NULL AND TRIM(contents) != ''" if table in ("chunk", "query") else ""
        row = self.connect().execute(
            f"SELECT COUNT(*) AS n FROM {table} WHERE {col} IS NULL{extra}"
        ).fetchone()
        return int(row["n"])

    def fetch_unembedded(
        self, table: str, limit: int, exclude_ids: Sequence[Any] = (), multi: bool = False
    ) -> list[sqlite3.Row]:
        """Resume-friendly batch fetch of rows lacking embeddings
        (reference ``base_ingestion.py:439-459`` + failed-ID quarantine ``:386-401``)."""
        self._check_table(table)
        col = "multi_embedding" if multi else "embedding"
        conn = self.connect()
        sql = f"SELECT * FROM {table} WHERE {col} IS NULL"
        if table in ("chunk", "query"):
            sql += " AND contents IS NOT NULL AND TRIM(contents) != ''"
        params: list[Any] = []
        if exclude_ids:
            # quarantine lists can exceed SQLite's bind-variable limit; stage
            # them in a temp table instead of inlining placeholders
            conn.execute("CREATE TEMP TABLE IF NOT EXISTS _quarantine (id PRIMARY KEY)")
            conn.execute("DELETE FROM _quarantine")
            conn.executemany(
                "INSERT OR IGNORE INTO _quarantine (id) VALUES (?)",
                [(i,) for i in exclude_ids],
            )
            # the temp-table writes opened an implicit transaction — commit
            # it or this connection pins a stale read snapshot (and blocks
            # WAL checkpointing) until some later write happens to commit
            conn.commit()
            sql += " AND id NOT IN (SELECT id FROM _quarantine)"
        sql += " ORDER BY id LIMIT ?"
        params.append(limit)
        return conn.execute(sql, params).fetchall()

    def get_embeddings_matrix(
        self, table: str = "chunk", multi: bool = False
    ) -> tuple[list[Any], np.ndarray | list[np.ndarray]]:
        """Export all embedded rows as (ids, matrix) for index builds.

        Single: returns ``[N, dim] float32``. Multi: returns a list of
        ``[n_i, dim]`` arrays (ragged), same order as ids. Ordered by id for
        deterministic index row numbering.
        """
        self._check_table(table)
        dim = self.embedding_dim
        if multi:
            rows = self.connect().execute(
                f"SELECT id, multi_embedding, multi_embedding_count FROM {table} "
                "WHERE multi_embedding IS NOT NULL ORDER BY id"
            ).fetchall()
            ids = [r["id"] for r in rows]
            mats = []
            for r in rows:
                arr = np.frombuffer(r["multi_embedding"], dtype=np.float32)
                n = r["multi_embedding_count"]
                mats.append(arr.reshape(n, -1))
            return ids, mats
        rows = self.connect().execute(
            f"SELECT id, embedding FROM {table} WHERE embedding IS NOT NULL ORDER BY id"
        ).fetchall()
        ids = [r["id"] for r in rows]
        if not ids:
            return ids, np.zeros((0, dim or 0), dtype=np.float32)
        mat = np.stack([np.frombuffer(r["embedding"], dtype=np.float32) for r in rows])
        return ids, mat

    def get_embedding(self, table: str, row_id: Any, multi: bool = False) -> np.ndarray | None:
        self._check_table(table)
        if multi:
            row = self.connect().execute(
                f"SELECT multi_embedding, multi_embedding_count FROM {table} WHERE id=?",
                (row_id,),
            ).fetchone()
            if row is None or row["multi_embedding"] is None:
                return None
            return np.frombuffer(row["multi_embedding"], dtype=np.float32).reshape(
                row["multi_embedding_count"], -1
            )
        row = self.connect().execute(
            f"SELECT embedding FROM {table} WHERE id=?", (row_id,)
        ).fetchone()
        if row is None or row["embedding"] is None:
            return None
        return np.frombuffer(row["embedding"], dtype=np.float32)

    def _check_table(self, table: str) -> None:
        if table not in self.EMBEDDABLE_TABLES:
            raise StoreError(f"unknown embeddable table: {table}")

    # ---------------------------------------------------------------- queries
    def get_all_query_ids(self) -> list[Any]:
        return [r["id"] for r in self.connect().execute("SELECT id FROM query ORDER BY id")]

    def get_queries(self, limit: int | None = None, offset: int = 0) -> list[sqlite3.Row]:
        sql = "SELECT * FROM query ORDER BY id"
        if limit is not None:
            sql += f" LIMIT {int(limit)} OFFSET {int(offset)}"
        return self.connect().execute(sql).fetchall()

    def get_query(self, query_id: Any) -> sqlite3.Row | None:
        return self.connect().execute("SELECT * FROM query WHERE id=?", (query_id,)).fetchone()

    def get_query_text(self, query_id: Any) -> str | None:
        """Prefer ``query_to_llm`` over ``contents`` (reference
        ``generation_pipeline.py:274-320``)."""
        row = self.get_query(query_id)
        if row is None:
            return None
        return row["query_to_llm"] or row["contents"]

    def find_queries_by_contents(self, contents: str) -> list[sqlite3.Row]:
        return self.connect().execute(
            "SELECT * FROM query WHERE contents=?", (contents,)
        ).fetchall()

    # ----------------------------------------------------------------- chunks
    def find_chunks_by_contents(self, term: str, limit: int = 20) -> list[Any]:
        """Substring match over chunk contents with LIKE wildcards escaped
        (the term may be LLM-controlled — a bare '%' must not match every
        chunk). Returns chunk ids ordered by id."""
        escaped = (
            term.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")
        )
        rows = self.connect().execute(
            "SELECT id FROM chunk WHERE contents LIKE ? ESCAPE '\\' "
            "ORDER BY id LIMIT ?",
            (f"%{escaped}%", limit),
        ).fetchall()
        return [r["id"] for r in rows]

    def get_chunk_contents(self, chunk_ids: Sequence[Any]) -> dict[Any, str]:
        if not chunk_ids:
            return {}
        qs = ",".join("?" for _ in chunk_ids)
        rows = self.connect().execute(
            f"SELECT id, contents FROM chunk WHERE id IN ({qs})", list(chunk_ids)
        ).fetchall()
        return {r["id"]: r["contents"] for r in rows}

    def get_image_chunks(self, ids: Sequence[Any]) -> dict[Any, sqlite3.Row]:
        if not ids:
            return {}
        qs = ",".join("?" for _ in ids)
        rows = self.connect().execute(
            f"SELECT * FROM image_chunk WHERE id IN ({qs})", list(ids)
        ).fetchall()
        return {r["id"]: r for r in rows}

    def count(self, table: str) -> int:
        row = self.connect().execute(f"SELECT COUNT(*) AS n FROM {table}").fetchone()
        return int(row["n"])

    # --------------------------------------------------------------------- GT
    def add_retrieval_gt(
        self, query_id: Any, gt: RetrievalGT, chunk_type: str = "chunk", upsert: bool = False
    ) -> int:
        rows = gt_to_relation_rows(query_id, gt, chunk_type)
        sql = (
            "INSERT INTO retrieval_relation "
            "(query_id, group_index, group_order, chunk_id, image_chunk_id, score) "
            "VALUES (:query_id, :group_index, :group_order, :chunk_id, :image_chunk_id, :score)"
        )
        try:
            with self.connect() as conn:
                if upsert:
                    # replace-set semantics: re-ingesting a query's GT must not
                    # leave stale rows from a previously larger GT mixed in
                    conn.execute(
                        "DELETE FROM retrieval_relation WHERE query_id=?", (query_id,)
                    )
                conn.executemany(sql, rows)
        except sqlite3.IntegrityError as exc:
            raise DuplicateRetrievalGTError(str(exc)) from exc
        return len(rows)

    def add_retrieval_gt_batch(
        self, items: Iterable[tuple[Any, RetrievalGT]], chunk_type: str = "chunk", upsert: bool = True
    ) -> int:
        n = 0
        for query_id, gt in items:
            n += self.add_retrieval_gt(query_id, gt, chunk_type, upsert=upsert)
        return n

    def get_relations_by_query(self, query_id: Any) -> list[sqlite3.Row]:
        return self.connect().execute(
            "SELECT * FROM retrieval_relation WHERE query_id=? "
            "ORDER BY group_index, group_order",
            (query_id,),
        ).fetchall()

    def count_relations_by_query(self, query_id: Any) -> int:
        row = self.connect().execute(
            "SELECT COUNT(*) AS n FROM retrieval_relation WHERE query_id=?", (query_id,)
        ).fetchone()
        return int(row["n"])

    # -------------------------------------------------------------- pipelines
    def get_or_create_pipeline(self, name: str, config: dict | None = None) -> int:
        """Resume identity: same name -> same pipeline id (reference
        ``orm/service/base_pipeline.py:16-77``). Insert-or-ignore + select so
        concurrent creators race safely instead of raising IntegrityError."""
        with self.connect() as conn:
            conn.execute(
                "INSERT OR IGNORE INTO pipeline (name, config) VALUES (?, ?)",
                (name, json.dumps(config or {}, ensure_ascii=False, default=str)),
            )
            row = conn.execute("SELECT id FROM pipeline WHERE name=?", (name,)).fetchone()
            return int(row["id"])

    def get_pipeline(self, name: str) -> sqlite3.Row | None:
        return self.connect().execute("SELECT * FROM pipeline WHERE name=?", (name,)).fetchone()

    def delete_pipeline_artifacts(self, pipeline_id: int) -> None:
        """Remove every result/eval row for a pipeline (health-check cleanup,
        reference ``executor.py:356-381``). Also sweeps DERIVED pipelines the
        target created under ``<name>__*`` (e.g. hyde's inner
        ``<name>__dense`` dense pipeline) — health checks must not leave
        orphan pipeline rows behind."""
        with self.connect() as conn:
            targets = [pipeline_id]
            row = conn.execute(
                "SELECT name FROM pipeline WHERE id=?", (pipeline_id,)
            ).fetchone()
            if row is not None:
                derived = conn.execute(
                    "SELECT id FROM pipeline WHERE name LIKE ? ESCAPE '\\'",
                    (row["name"].replace("\\", "\\\\").replace("%", "\\%")
                     .replace("_", "\\_") + "\\_\\_%",),
                ).fetchall()
                targets += [int(r["id"]) for r in derived]
            for pid in targets:
                for table in (
                    "chunk_retrieved_result",
                    "image_chunk_retrieved_result",
                    "executor_result",
                    "evaluation_result",
                    "summary",
                ):
                    conn.execute(f"DELETE FROM {table} WHERE pipeline_id=?", (pid,))
                conn.execute("DELETE FROM pipeline WHERE id=?", (pid,))

    # ---------------------------------------------------------------- metrics
    def get_or_create_metric(self, name: str, metric_type: str) -> int:
        with self.connect() as conn:
            conn.execute(
                "INSERT OR IGNORE INTO metric (name, type) VALUES (?, ?)",
                (name, metric_type),
            )
            row = conn.execute(
                "SELECT id FROM metric WHERE name=? AND type=?", (name, metric_type)
            ).fetchone()
            return int(row["id"])

    # ------------------------------------------------------ retrieved results
    def add_retrieved_results(
        self, pipeline_id: int, rows: Iterable[tuple[Any, Any, float]], unit: str = "chunk"
    ) -> None:
        """rows: (query_id, doc_id, rel_score); unit routes to the chunk or
        image_chunk result table (reference ``pipelines/retrieval/base.py:182-199``)."""
        table, col = self._result_table(unit)
        with self.connect() as conn:
            conn.executemany(
                f"INSERT OR REPLACE INTO {table} (query_id, pipeline_id, {col}, rel_score) "
                "VALUES (?, ?, ?, ?)",
                [(qid, pipeline_id, did, score) for qid, did, score in rows],
            )

    def get_retrieved(
        self, query_id: Any, pipeline_id: int, unit: str = "chunk"
    ) -> list[sqlite3.Row]:
        table, col = self._result_table(unit)
        return self.connect().execute(
            f"SELECT query_id, {col} AS doc_id, rel_score FROM {table} "
            "WHERE query_id=? AND pipeline_id=? ORDER BY rel_score DESC, doc_id",
            (query_id, pipeline_id),
        ).fetchall()

    def get_queries_with_results(self, pipeline_id: int, unit: str = "chunk") -> set[Any]:
        table, _ = self._result_table(unit)
        return {
            r["query_id"]
            for r in self.connect().execute(
                f"SELECT DISTINCT query_id FROM {table} WHERE pipeline_id=?", (pipeline_id,)
            )
        }

    def delete_retrieved_by_pipeline(self, pipeline_id: int, unit: str = "chunk") -> None:
        table, _ = self._result_table(unit)
        with self.connect() as conn:
            conn.execute(f"DELETE FROM {table} WHERE pipeline_id=?", (pipeline_id,))

    def delete_retrieved_for_query(
        self, query_id: Any, pipeline_id: int, unit: str = "chunk"
    ) -> None:
        """Clear ONE query's retrieved rows before a re-run writes fresh ones
        (a crash between result insert and executor-result insert would
        otherwise union the stale attempt's docs with the resumed attempt's)."""
        table, _ = self._result_table(unit)
        with self.connect() as conn:
            conn.execute(
                f"DELETE FROM {table} WHERE query_id=? AND pipeline_id=?",
                (query_id, pipeline_id),
            )

    @staticmethod
    def _result_table(unit: str) -> tuple[str, str]:
        if unit == "chunk":
            return "chunk_retrieved_result", "chunk_id"
        if unit == "image_chunk":
            return "image_chunk_retrieved_result", "image_chunk_id"
        raise StoreError(f"unknown retrieval unit: {unit}")

    # ------------------------------------------------------- executor results
    def add_executor_result(
        self,
        query_id: Any,
        pipeline_id: int,
        generation_result: str,
        token_usage: dict | None = None,
        execution_time: float | None = None,
        result_metadata: dict | None = None,
    ) -> None:
        with self.connect() as conn:
            conn.execute(
                "INSERT OR REPLACE INTO executor_result "
                "(query_id, pipeline_id, generation_result, token_usage, execution_time, "
                "result_metadata) VALUES (?, ?, ?, ?, ?, ?)",
                (
                    query_id,
                    pipeline_id,
                    _clean_text(generation_result),
                    json.dumps(token_usage) if token_usage is not None else None,
                    execution_time,
                    json.dumps(result_metadata, ensure_ascii=False, default=str)
                    if result_metadata is not None
                    else None,
                ),
            )

    def get_executor_result(self, query_id: Any, pipeline_id: int) -> sqlite3.Row | None:
        return self.connect().execute(
            "SELECT * FROM executor_result WHERE query_id=? AND pipeline_id=?",
            (query_id, pipeline_id),
        ).fetchone()

    def get_queries_with_executor_results(self, pipeline_id: int) -> set[Any]:
        return {
            r["query_id"]
            for r in self.connect().execute(
                "SELECT DISTINCT query_id FROM executor_result WHERE pipeline_id=?",
                (pipeline_id,),
            )
        }

    # ------------------------------------------------------------- evaluation
    def add_evaluation_results(
        self, pipeline_id: int, metric_id: int, rows: Iterable[tuple[Any, float | None]]
    ) -> None:
        with self.connect() as conn:
            conn.executemany(
                "INSERT OR REPLACE INTO evaluation_result "
                "(query_id, pipeline_id, metric_id, value) VALUES (?, ?, ?, ?)",
                [(qid, pipeline_id, metric_id, v) for qid, v in rows],
            )

    def get_evaluated_query_ids(self, pipeline_id: int, metric_id: int) -> set[Any]:
        return {
            r["query_id"]
            for r in self.connect().execute(
                "SELECT query_id FROM evaluation_result WHERE pipeline_id=? AND metric_id=?",
                (pipeline_id, metric_id),
            )
        }

    def get_evaluation_values(
        self, pipeline_id: int, metric_id: int, query_ids: Sequence[Any] | None = None
    ) -> list[float]:
        sql = (
            "SELECT value FROM evaluation_result "
            "WHERE pipeline_id=? AND metric_id=? AND value IS NOT NULL"
        )
        params: list[Any] = [pipeline_id, metric_id]
        if query_ids is not None:
            ids = list(query_ids)
            if not ids:
                return []
            out: list[float] = []
            for lo in range(0, len(ids), 500):
                chunk = ids[lo : lo + 500]
                qs = ",".join("?" for _ in chunk)
                out.extend(
                    r["value"]
                    for r in self.connect().execute(
                        sql + f" AND query_id IN ({qs})", params + chunk
                    )
                )
            return out
        return [r["value"] for r in self.connect().execute(sql, params)]

    def delete_evaluation_results(
        self, pipeline_id: int, metric_id: int | None = None
    ) -> None:
        with self.connect() as conn:
            if metric_id is None:
                conn.execute(
                    "DELETE FROM evaluation_result WHERE pipeline_id=?", (pipeline_id,)
                )
            else:
                conn.execute(
                    "DELETE FROM evaluation_result WHERE pipeline_id=? AND metric_id=?",
                    (pipeline_id, metric_id),
                )

    def upsert_summary(
        self, pipeline_id: int, metric_id: int, value: float, query_cnt: int
    ) -> None:
        with self.connect() as conn:
            conn.execute(
                "INSERT OR REPLACE INTO summary (pipeline_id, metric_id, value, query_cnt) "
                "VALUES (?, ?, ?, ?)",
                (pipeline_id, metric_id, value, query_cnt),
            )

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict[str, int]:
        tables = [
            "file", "document", "page", "chunk", "image_chunk", "query",
            "retrieval_relation", "pipeline", "metric", "chunk_retrieved_result",
            "image_chunk_retrieved_result", "executor_result", "evaluation_result",
        ]
        return {t: self.count(t) for t in tables}

    def clean(self) -> dict[str, int]:
        """Delete empty-content queries/chunks (reference
        ``text_ingestion.py:93-190``)."""
        removed = {}
        with self.connect() as conn:
            cur = conn.execute(
                "DELETE FROM query WHERE contents IS NULL OR TRIM(contents)=''"
            )
            removed["query"] = cur.rowcount
            cur = conn.execute(
                "DELETE FROM chunk WHERE contents IS NULL OR TRIM(contents)=''"
            )
            removed["chunk"] = cur.rowcount
        return removed
