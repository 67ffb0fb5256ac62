"""HF Hub dump distribution: share prebuilt workspaces (embeddings included).

Capability parity with the reference ``data/hf_storage.py:17-152``: dump
artifacts live in dataset repos named ``{org}/{ingestor}-dumps``; users
download a dump instead of re-embedding. Here a dump is the CLI's workspace
tarball (``cli data dump``). Requires network egress + HF credentials.

The port's copy of the JAX package's ``data/hf_storage.py``:
``huggingface_hub`` is imported inside each call, and any failure (the
package missing included) is raised as ``StoreError``.
"""

from __future__ import annotations

from pathlib import Path

from autorag_research_tpu_torch.exceptions import StoreError

DEFAULT_ORG = "autorag-research-tpu"


def _repo_id(ingestor_name: str, org: str = DEFAULT_ORG) -> str:
    return f"{org}/{ingestor_name}-dumps"


def upload_dump(dump_path: str | Path, ingestor_name: str, org: str = DEFAULT_ORG, token: str | None = None) -> str:
    try:
        from huggingface_hub import HfApi

        api = HfApi(token=token)
        repo_id = _repo_id(ingestor_name, org)
        api.create_repo(repo_id, repo_type="dataset", exist_ok=True)
        dump_path = Path(dump_path)
        api.upload_file(
            path_or_fileobj=str(dump_path),
            path_in_repo=dump_path.name,
            repo_id=repo_id,
            repo_type="dataset",
        )
        return f"{repo_id}/{dump_path.name}"
    except Exception as exc:  # noqa: BLE001
        raise StoreError(f"dump upload failed (needs egress + HF token): {exc}") from exc


def download_dump(ingestor_name: str, dump_name: str, dest_dir: str | Path, org: str = DEFAULT_ORG, token: str | None = None) -> Path:
    try:
        from huggingface_hub import hf_hub_download

        path = hf_hub_download(
            repo_id=_repo_id(ingestor_name, org),
            filename=dump_name,
            repo_type="dataset",
            local_dir=str(dest_dir),
            token=token,
        )
        return Path(path)
    except Exception as exc:  # noqa: BLE001
        raise StoreError(f"dump download failed (needs egress): {exc}") from exc


def list_dumps(ingestor_name: str, org: str = DEFAULT_ORG, token: str | None = None) -> list[str]:
    try:
        from huggingface_hub import HfApi

        files = HfApi(token=token).list_repo_files(
            _repo_id(ingestor_name, org), repo_type="dataset"
        )
        return [f for f in files if f.endswith(".tar.gz") or f.endswith(".dump")]
    except Exception as exc:  # noqa: BLE001
        raise StoreError(f"dump listing failed (needs egress): {exc}") from exc
