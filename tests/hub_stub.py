"""A stand-in ``huggingface_hub`` for the hub dump tests: dataset repos are
directories under ``root``, and every call is recorded. Install it with
``monkeypatch.setitem(sys.modules, "huggingface_hub", StubHub(root).module())``
so that both packages' ``data/hf_storage.py`` import it; nothing leaves the
machine."""

import shutil
import types
from pathlib import Path


class StubHub:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.calls: list[tuple] = []

    def put(self, repo_id: str, path: Path, name: str | None = None) -> None:
        """Place a file in a repo, as an earlier upload would have."""
        (self.root / repo_id).mkdir(parents=True, exist_ok=True)
        shutil.copy(path, self.root / repo_id / (name or Path(path).name))

    def module(self) -> types.ModuleType:
        hub = self

        class HfApi:
            def __init__(self, token=None):
                hub.calls.append(("HfApi", token))

            def create_repo(self, repo_id, repo_type=None, exist_ok=False):
                hub.calls.append(("create_repo", repo_id, repo_type, exist_ok))
                (hub.root / repo_id).mkdir(parents=True, exist_ok=exist_ok)

            def upload_file(self, path_or_fileobj, path_in_repo, repo_id, repo_type=None):
                hub.calls.append(("upload_file", Path(path_or_fileobj).name, path_in_repo,
                                  repo_id, repo_type))
                shutil.copy(path_or_fileobj, hub.root / repo_id / path_in_repo)

            def list_repo_files(self, repo_id, repo_type=None):
                hub.calls.append(("list_repo_files", repo_id, repo_type))
                repo = hub.root / repo_id
                if not repo.is_dir():
                    raise FileNotFoundError(f"repository {repo_id} not found")
                return sorted(p.name for p in repo.iterdir())

        def hf_hub_download(repo_id, filename, repo_type=None, local_dir=None, token=None):
            hub.calls.append(("hf_hub_download", repo_id, filename, repo_type, token))
            src = hub.root / repo_id / filename
            if not src.exists():
                raise FileNotFoundError(f"{repo_id}/{filename} not found")
            dest = Path(local_dir) / filename
            shutil.copy(src, dest)
            return str(dest)

        mod = types.ModuleType("huggingface_hub")
        mod.HfApi = HfApi
        mod.hf_hub_download = hf_hub_download
        return mod
