"""Retrieval ground-truth DSL: `|` = OR group, `&` = AND chain.

Same semantics as the reference GT API (``orm/models/retrieval_gt.py``):

- Outer structure = AND groups (all must be satisfied; ``group_index``).
- Inner structure = OR alternatives (any satisfies the group; ``group_order``).
- Items carry an optional graded relevance ``score`` (default 1 at evaluation).

The implementation is a deliberately smaller algebra than the reference's
TextId/ImageId/OrGroup/AndChain/_IntWrapper class set: one item type
(``GTItem``) plus two composite nodes, all normalizing to
``list[list[GTItem]]`` via :func:`normalize_gt`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from operator import and_, or_
from typing import Any, Iterable, Union

from autorag_research_tpu_torch.exceptions import EmptyIterableError

CHUNK = "chunk"
IMAGE_CHUNK = "image_chunk"


@dataclass(frozen=True)
class GTItem:
    """One ground-truth chunk reference (text or image) with optional grade."""

    id: Any
    chunk_type: str = CHUNK  # "chunk" | "image_chunk"
    score: int | None = None

    def __or__(self, other: GTAtom) -> _OrGroup:
        return _OrGroup((self,)) | other

    def __and__(self, other: GTAtom) -> _AndChain:
        return _AndChain((_OrGroup((self,)),)) & other


@dataclass(frozen=True)
class _OrGroup:
    items: tuple[GTItem, ...]

    def __or__(self, other: GTAtom) -> _OrGroup:
        if isinstance(other, _OrGroup):
            return _OrGroup(self.items + other.items)
        if isinstance(other, GTItem):
            return _OrGroup((*self.items, other))
        raise TypeError(f"cannot OR with {type(other).__name__}")

    def __and__(self, other: GTAtom) -> _AndChain:
        return _AndChain((self,)) & other


@dataclass(frozen=True)
class _AndChain:
    groups: tuple[_OrGroup, ...]

    def __and__(self, other: GTAtom) -> _AndChain:
        if isinstance(other, _AndChain):
            return _AndChain(self.groups + other.groups)
        if isinstance(other, _OrGroup):
            return _AndChain((*self.groups, other))
        if isinstance(other, GTItem):
            return _AndChain((*self.groups, _OrGroup((other,))))
        raise TypeError(f"cannot AND with {type(other).__name__}")


GTAtom = Union[GTItem, _OrGroup, _AndChain]
RetrievalGT = Union[int, str, GTItem, _OrGroup, _AndChain]


def text(_id: int | str, score: int | None = None) -> GTItem:
    """Text-chunk GT item: ``text(1) | text(2)`` etc."""
    return GTItem(_id, CHUNK, score)


def image(_id: int | str, score: int | None = None) -> GTItem:
    """Image-chunk GT item: ``image(1) & image(2)`` etc."""
    return GTItem(_id, IMAGE_CHUNK, score)


# Mixed-modality aliases mirroring the reference's TextId/ImageId wrappers.
TextId = text
ImageId = image


def or_all(ids: Iterable[int | str], wrapper_fn=text) -> GTAtom:
    """[1, 2, 3] -> wrapper(1) | wrapper(2) | wrapper(3)."""
    items = [wrapper_fn(i) for i in ids]
    if not items:
        raise EmptyIterableError("or_all received an empty iterable")
    return items[0] if len(items) == 1 else reduce(or_, items)


def and_all(ids: Iterable[int | str], wrapper_fn=text) -> GTAtom:
    """[1, 2, 3] -> wrapper(1) & wrapper(2) & wrapper(3) (multi-hop chain)."""
    items = [wrapper_fn(i) for i in ids]
    if not items:
        raise EmptyIterableError("and_all received an empty iterable")
    return items[0] if len(items) == 1 else reduce(and_, items)


def or_all_mixed(items: list[GTItem]) -> GTAtom:
    if not items:
        raise EmptyIterableError("or_all_mixed received an empty list")
    return items[0] if len(items) == 1 else reduce(or_, items)


def and_all_mixed(items: "list[GTItem | _OrGroup]") -> GTAtom:
    """AND chain over items or OR groups — the reference's multi-hop shape
    ``and_all_mixed([or_all_mixed([...]), ...])`` (``vidorev3.py:462-468``)."""
    if not items:
        raise EmptyIterableError("and_all_mixed received an empty list")
    return items[0] if len(items) == 1 else reduce(and_, items)


def normalize_gt(gt: RetrievalGT, chunk_type: str = CHUNK) -> list[list[GTItem]]:
    """Normalize any GT expression to AND-of-OR groups ``[[item, ...], ...]``.

    Bare ints/strings are promoted with ``chunk_type`` (the reference's
    ``chunk_type="text"|"image"`` shortcut in ``add_retrieval_gt``).
    """
    if isinstance(gt, (int, str)):
        gt = GTItem(gt, chunk_type)
    if isinstance(gt, GTItem):
        return [[gt]]
    if isinstance(gt, _OrGroup):
        return [list(gt.items)]
    if isinstance(gt, _AndChain):
        return [list(group.items) for group in gt.groups]
    raise TypeError(f"not a retrieval GT expression: {type(gt).__name__}")


def gt_to_relation_rows(query_id: Any, gt: RetrievalGT, chunk_type: str = CHUNK) -> list[dict]:
    """Flatten a GT expression into relation rows for the catalog.

    Row layout matches the reference RetrievalRelation table
    (``orm/schema_factory.py:234-256``): composite key
    (query_id, group_index, group_order) + one of chunk_id/image_chunk_id + score.
    """
    rows = []
    for group_index, group in enumerate(normalize_gt(gt, chunk_type)):
        for group_order, item in enumerate(group):
            rows.append(
                {
                    "query_id": query_id,
                    "group_index": group_index,
                    "group_order": group_order,
                    "chunk_id": item.id if item.chunk_type == CHUNK else None,
                    "image_chunk_id": item.id if item.chunk_type == IMAGE_CHUNK else None,
                    "score": item.score,
                }
            )
    return rows


def build_retrieval_gt_from_relations(relations: list[Any]) -> tuple[list[list[str]], dict[str, int]]:
    """Relation rows -> (2-D prefixed-id GT, graded relevance map).

    Exact behavioral parity with the reference builder
    (``orm/service/retrieval_evaluation.py:23-78``): group by ``group_index``
    (sorted), order within group by ``group_order``, prefix ids with
    ``chunk_``/``image_chunk_``, default score 1 when absent.

    ``relations`` may be dicts or objects with the relation attributes.
    """

    def get(rel: Any, name: str) -> Any:
        return rel.get(name) if isinstance(rel, dict) else getattr(rel, name, None)

    grouped: dict[int, list[tuple[int, str]]] = {}
    relevance_scores: dict[str, int] = {}
    for rel in relations:
        chunk_id = get(rel, "chunk_id")
        image_chunk_id = get(rel, "image_chunk_id")
        if chunk_id is not None:
            prefixed = f"chunk_{chunk_id}"
        elif image_chunk_id is not None:
            prefixed = f"image_chunk_{image_chunk_id}"
        else:
            continue
        score = get(rel, "score")
        relevance_scores[prefixed] = int(score) if score is not None else 1
        grouped.setdefault(int(get(rel, "group_index")), []).append(
            (int(get(rel, "group_order")), prefixed)
        )

    result = [
        [pid for _, pid in sorted(items)] for _, items in sorted(grouped.items())
    ]
    return result, relevance_scores
