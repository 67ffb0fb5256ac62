"""Deterministic top-k selection and merge primitives (PyTorch).

Every selection in this framework orders by the composite key
``(-score, doc_id)``: higher score first, ties broken by smaller id, so that
per-tile and per-block candidate lists merge to one partition-invariant
ranking. ``torch.topk`` and an unstable ``torch.sort`` give no tie guarantee,
so neither decides an order that reaches an output here:

- :func:`sort_topk` is two stable sorts (by id, then by ``-score``), the
  lexicographic two-key sort. Like ``jax.lax.sort`` it treats ``+0.0`` and
  ``-0.0`` as equal scores.
- :func:`topk_ordered` has ``jax.lax.top_k``'s contract: the lower index wins
  a tie and ``+0.0`` ranks above ``-0.0``. It orders candidates on one unique
  int64 key per element, so ``torch.topk`` never decides a tie.
"""

from __future__ import annotations

import torch

# pad sentinels shared by every top-k wrapper: large-FINITE score so pads
# never produce inf arithmetic, INT_MAX id so pads always lose the tie-break
NEG_INF = -3.4e38
INT_MAX = 2**31 - 1


def pad_to_k(
    scores: torch.Tensor, ids: torch.Tensor, k: int, k_eff: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad [..., k_eff] results out to the caller's k with the sentinels."""
    if k_eff >= k:
        return scores, ids
    shape = (*scores.shape[:-1], k - k_eff)
    return (
        torch.cat([scores, scores.new_full(shape, NEG_INF)], dim=-1),
        torch.cat([ids, ids.new_full(shape, INT_MAX)], dim=-1),
    )


def sort_topk(
    scores: torch.Tensor, ids: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis by ``(-score, id)`` lexicographic order.

    scores: [..., M] float; ids: [..., M] int. Returns ([..., k] f32,
    [..., k] ids), padded with the sentinels when M < k.
    """
    ids_sorted, perm = torch.sort(ids, dim=-1, stable=True)
    neg = torch.gather(-scores.float(), -1, perm)
    neg_sorted, perm2 = torch.sort(neg, dim=-1, stable=True)
    ids_out = torch.gather(ids_sorted, -1, perm2)
    out_s, out_i = -neg_sorted[..., :k], ids_out[..., :k]
    return pad_to_k(out_s, out_i, k, out_s.shape[-1])


def merge_topk(
    parts_scores: torch.Tensor, parts_ids: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge [..., P, K'] per-part candidate lists into one deterministic
    top-k; the result does not depend on how candidates were partitioned."""
    flat_scores = parts_scores.reshape(*parts_scores.shape[:-2], -1)
    flat_ids = parts_ids.reshape(*parts_ids.shape[:-2], -1)
    return sort_topk(flat_scores, flat_ids, k)


# Above this many elements topk_ordered selects candidates by value first
# instead of building the int64 key over the whole input.
# It also bounds the elements keyed at once (about 36 transient bytes each).
KEY_DIRECT_MAX_ELEMENTS = 1 << 24


def _order_key(scores: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """int64 key, unique per position along the last axis, whose descending
    order is ``lax.top_k``'s: the f32 bit pattern made monotone (so -0.0 <
    +0.0) in the high word, the inverted position in the low word."""
    bits = scores.float().contiguous().view(torch.int32)
    mono = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return (mono.to(torch.int64) << 32) + (0xFFFFFFFF - pos.to(torch.int64))


def _topk_by_key(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """topk_ordered on the key of every element, a block of rows at a time."""
    flat = scores.reshape(-1, scores.shape[-1])
    pos = torch.arange(flat.shape[1], device=flat.device)
    step = max(1, KEY_DIRECT_MAX_ELEMENTS // max(1, flat.shape[1]))
    out = [
        torch.topk(_order_key(flat[r : r + step], pos), k, dim=-1, sorted=True)[1]
        for r in range(0, flat.shape[0], step)
    ]
    top = torch.cat(out) if out else flat.new_empty((0, k), dtype=torch.int64)
    top = top.reshape(*scores.shape[:-1], k)
    return torch.gather(scores, -1, top), top.to(torch.int32)


def topk_ordered(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` counterpart: the k largest along the last axis,
    lower index first among ties. Returns (values f32, int32 indices).

    A large input is first cut to k + 1 candidates per row by f32
    ``torch.topk``. Where the k-th and (k+1)-th values differ the k largest
    are then a unique set, ordered here by the int64 key; rows with a tie at
    that boundary (one host sync finds them) take the key over all their
    elements."""
    scores = scores.float()
    n = scores.shape[-1]
    if scores.numel() <= KEY_DIRECT_MAX_ELEMENTS or k >= n:
        return _topk_by_key(scores, k)
    vals, pos = torch.topk(scores, k + 1, dim=-1, sorted=True)
    tie = vals[..., k - 1] == vals[..., k]
    vals, pos = vals[..., :k].contiguous(), pos[..., :k]
    order = torch.sort(_order_key(vals, pos), dim=-1, descending=True)[1]
    out_s, out_i = torch.gather(vals, -1, order), torch.gather(pos, -1, order).to(torch.int32)
    if bool(tie.any()):
        out_s[tie], out_i[tie] = _topk_by_key(scores[tie], k)
    return out_s, out_i
