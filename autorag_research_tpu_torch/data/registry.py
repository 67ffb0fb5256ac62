"""Ingestor registry with CLI parameter introspection.

Role parity with the reference ``data/registry.py:72-307``:
``@register_ingestor(name, ...)`` registers a class; CLI parameters are
auto-extracted from ``__init__`` type hints (Literal -> choices); plugin
ingestors are discovered from the ``autorag_research_tpu_torch.ingestors``
entry-points group.

The port's copy of the JAX package's ``data/registry.py``: it autoloads the
same ingestor modules, the port's copies of them. Offline, the hub-backed
ones read a local ``datasets.save_to_disk`` snapshot or injected ``data=``,
and BEIR a local directory (``data_dir``).
"""

from __future__ import annotations

import importlib
import inspect
import typing
from dataclasses import dataclass, field
from typing import Any, Literal, get_args, get_origin

_REGISTRY: dict[str, "IngestorInfo"] = {}

_DATA_MODULES = (
    "autorag_research_tpu_torch.data.local",
    "autorag_research_tpu_torch.data.synthetic",
    "autorag_research_tpu_torch.data.beir",
    "autorag_research_tpu_torch.data.text_mteb",
    "autorag_research_tpu_torch.data.ragbench",
    "autorag_research_tpu_torch.data.mrtydi",
    "autorag_research_tpu_torch.data.bright",
    "autorag_research_tpu_torch.data.crag",
    "autorag_research_tpu_torch.data.vidore",
    "autorag_research_tpu_torch.data.visrag",
    "autorag_research_tpu_torch.data.open_ragbench",
)


@dataclass
class IngestorParam:
    name: str
    annotation: Any
    default: Any
    required: bool
    choices: tuple | None = None

    @property
    def type_name(self) -> str:
        if self.choices:
            return f"choice{self.choices}"
        return getattr(self.annotation, "__name__", str(self.annotation))


@dataclass
class IngestorInfo:
    name: str
    cls: type
    description: str = ""
    hf_repo: str | None = None
    aliases: tuple[str, ...] = ()
    params: list[IngestorParam] = field(default_factory=list)


def _extract_params(cls: type) -> list[IngestorParam]:
    sig = inspect.signature(cls.__init__)
    hints = typing.get_type_hints(cls.__init__)
    params = []
    for pname, p in sig.parameters.items():
        if pname in ("self", "embedding_model"):
            continue
        ann = hints.get(pname, p.annotation)
        choices = None
        if get_origin(ann) is Literal:
            choices = get_args(ann)
        params.append(
            IngestorParam(
                name=pname,
                annotation=ann,
                default=None if p.default is inspect.Parameter.empty else p.default,
                required=p.default is inspect.Parameter.empty,
                choices=choices,
            )
        )
    return params


def register_ingestor(
    name: str,
    description: str = "",
    hf_repo: str | None = None,
    aliases: tuple[str, ...] = (),
):
    def decorator(cls: type) -> type:
        info = IngestorInfo(
            name=name,
            cls=cls,
            description=description,
            hf_repo=hf_repo,
            aliases=aliases,
            params=_extract_params(cls),
        )
        _REGISTRY[name] = info
        for alias in aliases:
            _REGISTRY[alias] = info
        return cls

    return decorator


def _autoload() -> None:
    for mod in _DATA_MODULES:
        try:
            importlib.import_module(mod)
        except ImportError:
            pass
    # third-party plugin ingestors via entry points
    try:
        from importlib.metadata import entry_points

        for ep in entry_points(group="autorag_research_tpu_torch.ingestors"):
            try:
                ep.load()
            except Exception:  # noqa: BLE001 - plugin isolation
                pass
    except Exception:  # noqa: BLE001
        pass


def get_ingestor(name: str) -> IngestorInfo:
    _autoload()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown ingestor '{name}'; available: {sorted(set(i.name for i in _REGISTRY.values()))}"
        )
    return _REGISTRY[name]


def list_ingestors() -> list[IngestorInfo]:
    _autoload()
    seen = {}
    for info in _REGISTRY.values():
        seen.setdefault(info.name, info)
    return sorted(seen.values(), key=lambda i: i.name)
