"""Plain PyTorch reference of the dense kind: exact cosine top-k in f32.

It draws the corpus again from the seed (``inputs.dense_slabs``), normalizes
rows and queries itself, and scores every row of every slab by one f32
matmul with TF32 off. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.inputs import dense_slabs, unit_rows
from portbench.reference.common import BLOCK_BYTES, RunningTopk, exact_f32, gather_at, round_tf32


def evaluate(cfg: dict, seed: int, device: torch.device, queries: list, k: int,
             answers: dict[str, np.ndarray], control: bool = False) -> dict:
    """Exact top-k of ``queries`` (1-D raw vectors) over the configuration's
    corpus. Returns ``{"top_s", "top_i"}`` [M, k], ``"at"``: for each answer
    set [M, k] of ids, the reference's f32 score of each id (nan where the id
    is no row), and with ``control`` the control's answers: ``"control_i"``
    and ``"control_s"``, the top-k of products of operands rounded to TF32
    (the precision below the configuration's), and ``"control_at"``, the
    f32 scores of its picks."""
    exact_f32()
    n, d = int(cfg["n_docs"]), int(cfg["dim"])
    q = unit_rows(torch.from_numpy(np.stack(queries).astype(np.float32)).to(device))
    m_rows = q.shape[0]
    best = RunningTopk(m_rows, k, device)
    ctrl = RunningTopk(m_rows, k, device) if control else None
    q_lo = round_tf32(q) if control else None
    ans = {name: torch.from_numpy(ids).to(device) for name, ids in answers.items()}
    at = {name: torch.full(ids.shape, float("nan"), device=device) for name, ids in ans.items()}
    for lo, raw in dense_slabs(cfg["corpus"], seed, n, d, device):
        c = unit_rows(raw)
        del raw
        c_lo = round_tf32(c) if control else None
        step = max(1, BLOCK_BYTES // (4 * c.shape[0]))
        for b0 in range(0, m_rows, step):
            rows = slice(b0, min(b0 + step, m_rows))
            s = q[rows] @ c.T
            best.add(rows, s, lo)
            for name, ids in ans.items():
                gather_at(s, ids[rows], lo, at[name][rows])
            if ctrl is not None:
                ctrl.add(rows, q_lo[rows] @ c_lo.T, lo, val=s)
            del s
    out = {"top_s": best.key.cpu().numpy(), "top_i": best.ids.cpu().numpy(),
           "at": {name: t.cpu().numpy() for name, t in at.items()}}
    if ctrl is not None:
        out["control_i"], out["control_s"] = ctrl.ids.cpu().numpy(), ctrl.key.cpu().numpy()
        out["control_at"] = ctrl.val.cpu().numpy()
    return out
