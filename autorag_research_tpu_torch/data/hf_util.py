"""Shared HF-datasets loading helpers for ingestors.

Every HF-backed ingestor accepts ``data=`` (a pre-loaded dataset mapping) so
offline deployments and tests can inject local data; otherwise
``datasets.load_dataset`` runs (requires network egress on first use).

The port's copy of the JAX package's ``data/hf_util.py``: ``datasets`` is
imported inside each loader, which raises ``IngestionError`` without it.
"""

from __future__ import annotations

from typing import Any

from autorag_research_tpu_torch.exceptions import IngestionError


def load_hf_dataset(
    path: str,
    name: str | None = None,
    split: str | None = None,
    data_dir: str | None = None,
    **kw,
) -> Any:
    """Load an HF dataset, or — when ``data_dir`` is given — a LOCAL snapshot
    (zero-egress turnkey path): a ``datasets.save_to_disk`` directory, with
    per-config subdirectories (``{data_dir}/{name}``) when the dataset has
    configs like corpus/queries/qrels."""
    if data_dir is not None:
        return load_local_snapshot(data_dir, name, split)
    try:
        import datasets

        return datasets.load_dataset(path, name, split=split, **kw)
    except Exception as exc:  # noqa: BLE001
        raise IngestionError(
            f"cannot load HF dataset '{path}'"
            f"{f'/{name}' if name else ''} (offline? pass data_dir=<local "
            f"save_to_disk snapshot> or data=...): {exc}"
        ) from exc


def load_local_snapshot(data_dir: str, name: str | None = None, split: str | None = None) -> Any:
    """Read a ``datasets.save_to_disk`` snapshot directory.

    Layout: ``{data_dir}/{name}`` when configs exist (e.g. mteb corpus /
    queries / qrels; ViDoRe v2 splits), else ``{data_dir}`` itself. Each
    leaf may be a Dataset or a DatasetDict keyed by split."""
    import os

    try:
        import datasets

        leaf = data_dir
        # HF config names map to subdirectories; "default" (mteb's qrels
        # config name) also answers to a "qrels" subdirectory
        for cand in (name, "qrels" if name == "default" else None):
            if cand and os.path.isdir(os.path.join(data_dir, cand)):
                leaf = os.path.join(data_dir, cand)
                break
        obj = datasets.load_from_disk(leaf)
        if isinstance(obj, datasets.DatasetDict):
            if split and split in obj:
                return obj[split]
            return obj[next(iter(obj))]
        return obj
    except IngestionError:
        raise
    except Exception as exc:  # noqa: BLE001
        raise IngestionError(
            f"cannot read local snapshot '{data_dir}'"
            f"{f'/{name}' if name else ''} (expected a datasets.save_to_disk dir): {exc}"
        ) from exc


def sample_ids(ids: list, limit: int | None, rng) -> list:
    if limit is None or limit >= len(ids):
        return list(ids)
    return rng.sample(list(ids), limit)


def gold_preserving_subsample(
    corpus_ids: list, gold_ids: set, min_corpus_cnt: int | None, rng
) -> list:
    """Gold-ID-preserving corpus subsample (the reference's seed-42 pattern,
    ``data/beir.py:133-157``): keep every gold doc, fill with random others up
    to ``min_corpus_cnt``. Shared by every ingestor that subsamples."""
    if min_corpus_cnt is None:
        return list(corpus_ids)
    selected = sorted(gold_ids & set(corpus_ids), key=str)
    rest = [c for c in corpus_ids if c not in gold_ids]
    need = min_corpus_cnt - len(selected)
    if need > 0 and rest:
        selected.extend(rng.sample(rest, min(need, len(rest))))
    return selected
