"""Plain PyTorch reference of the multi-vector kind: exact MaxSim top-k in f32.

It draws the pages again from the seed (``inputs.page_slabs``), normalizes
every page and query token itself, and scores a page as the sum over the
query's tokens of the largest f32 product with one of the page's valid tokens,
divided by the query's token count (the program's reported score). TF32 is
off. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.inputs import page_lens, page_slabs, unit_rows
from portbench.reference.common import BLOCK_BYTES, RunningTopk, exact_f32, gather_at, round_tf32


def _maxsim(q, q_mask, q_len, toks, tok_mask):
    """[b, P] MaxSim / Tq of queries [b, T, d] over pages [P, Tmax, d]."""
    b, t, d = q.shape
    p, tmax, _ = toks.shape
    s = (q.reshape(b * t, d) @ toks.reshape(p * tmax, d).T).view(b, t, p, tmax)
    s.masked_fill_(~tok_mask[None, None], float("-inf"))
    best = s.amax(dim=3)
    del s
    best = torch.where(q_mask[:, :, None], best, 0.0)
    return best.sum(dim=1) / q_len[:, None]


def evaluate(cfg: dict, seed: int, device: torch.device, queries: list, k: int,
             answers: dict[str, np.ndarray], control: bool = False) -> dict:
    """As ``reference.dense.evaluate``, for queries given as raw token
    matrices [T_i, d]."""
    exact_f32()
    law, n, d = cfg["corpus"], int(cfg["n_docs"]), int(cfg["dim"])
    lens = torch.from_numpy(page_lens(law, seed, n)).to(device)
    t_max = max(m.shape[0] for m in queries)
    m_rows = len(queries)
    q = torch.zeros((m_rows, t_max, d), device=device)
    for i, m in enumerate(queries):
        q[i, : m.shape[0]] = unit_rows(torch.from_numpy(np.asarray(m, np.float32)).to(device))
    q_len_i = torch.tensor([m.shape[0] for m in queries], device=device)
    q_mask = torch.arange(t_max, device=device)[None, :] < q_len_i[:, None]
    q_len = q_len_i.clamp(min=1).float()
    q_lo = round_tf32(q) if control else None
    best = RunningTopk(m_rows, k, device)
    ctrl = RunningTopk(m_rows, k, device) if control else None
    ans = {name: torch.from_numpy(ids).to(device) for name, ids in answers.items()}
    at = {name: torch.full(ids.shape, float("nan"), device=device) for name, ids in ans.items()}
    tok = torch.arange(int(law["max_tokens"]), device=device)
    for lo, raw in page_slabs(law, seed, n, d, device):
        toks = unit_rows(raw)
        del raw
        toks_lo = round_tf32(toks) if control else None
        tok_mask = tok[None, :] < lens[lo : lo + toks.shape[0], None]
        # blocks of queries and pages whose [b, T, P, Tmax] products fit BLOCK_BYTES
        per_page = toks.shape[1] * t_max * 4
        p_step = max(1, min(toks.shape[0], BLOCK_BYTES // (per_page * 32)))
        b_step = max(1, BLOCK_BYTES // (per_page * p_step))
        for p0 in range(0, toks.shape[0], p_step):
            pages = slice(p0, min(p0 + p_step, toks.shape[0]))
            for b0 in range(0, m_rows, b_step):
                rows = slice(b0, min(b0 + b_step, m_rows))
                s = _maxsim(q[rows], q_mask[rows], q_len[rows], toks[pages], tok_mask[pages])
                best.add(rows, s, lo + p0)
                for name, ids in ans.items():
                    gather_at(s, ids[rows], lo + p0, at[name][rows])
                if ctrl is not None:
                    s_lo = _maxsim(q_lo[rows], q_mask[rows], q_len[rows], toks_lo[pages], tok_mask[pages])
                    ctrl.add(rows, s_lo, lo + p0, val=s)
    out = {"top_s": best.key.cpu().numpy(), "top_i": best.ids.cpu().numpy(),
           "at": {name: t.cpu().numpy() for name, t in at.items()}}
    if ctrl is not None:
        out["control_i"], out["control_s"] = ctrl.ids.cpu().numpy(), ctrl.key.cpu().numpy()
        out["control_at"] = ctrl.val.cpu().numpy()
    return out
