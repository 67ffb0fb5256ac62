"""Pieces the plain references share: precision, a running top-k, blocks."""

from __future__ import annotations

import torch

# bytes of one f32 score block the references materialize at a time
BLOCK_BYTES = 1 << 30


def exact_f32() -> None:
    """True f32 products: no TF32 anywhere in the reference's matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 explicit mantissa bits, nearest even), kept
    in f32: the operands a TF32 matmul multiplies. The control computes its
    products from these, in f32, so it is the same on every device."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class RunningTopk:
    """The k largest keys seen so far a row, with their ids and one value
    carried beside each (the f32 score of a control's pick). Slots not yet
    filled hold key -inf and id -1."""

    def __init__(self, rows: int, k: int, device: torch.device):
        self.key = torch.full((rows, k), float("-inf"), device=device)
        self.ids = torch.full((rows, k), -1, dtype=torch.int64, device=device)
        self.val = torch.full((rows, k), float("-inf"), device=device)

    def add(self, rows: slice, key: torch.Tensor, first_id: int, val: torch.Tensor | None = None) -> None:
        """Merge the block ``key`` [b, m] (columns are ids ``first_id`` on)
        into rows ``rows``; ``val`` [b, m] rides along (default: the key)."""
        k = self.key.shape[1]
        top_key, top_pos = torch.topk(key, min(k, key.shape[1]), dim=1)
        top_val = top_key if val is None else torch.gather(val, 1, top_pos)
        key_all = torch.cat([self.key[rows], top_key], dim=1)
        ids_all = torch.cat([self.ids[rows], top_pos + first_id], dim=1)
        val_all = torch.cat([self.val[rows], top_val], dim=1)
        keep_key, keep = torch.topk(key_all, k, dim=1)
        self.key[rows] = keep_key
        self.ids[rows] = torch.gather(ids_all, 1, keep)
        self.val[rows] = torch.gather(val_all, 1, keep)


def gather_at(block: torch.Tensor, ids: torch.Tensor, first_id: int, out: torch.Tensor) -> None:
    """Write ``block``'s entries at the ids of ``ids`` [b, k] that fall in
    its columns (ids ``first_id`` on) into ``out`` [b, k]."""
    local = ids - first_id
    inside = (local >= 0) & (local < block.shape[1])
    got = torch.gather(block, 1, local.clamp(0, block.shape[1] - 1))
    out.copy_(torch.where(inside, got, out))
