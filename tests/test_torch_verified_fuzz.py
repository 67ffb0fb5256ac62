"""Adversarial eps-boundary fuzz of the port's verified-exact MaxSim.

The port counterpart of the MaxSim trials of ``test_verified_boundary_fuzz.py``
(same construction, same deltas, seeds and 8-ulp ``BAND``), through the
port's ``maxsim_topk_verified``. The proof's exactness rests on one strict
comparison per query, ``boundary < theta = e_k - eps``: each trial plants a
non-candidate document whose prescreen score lands a given number of f32
ulps from theta, on both sides, and asserts

1. exactness always: the ids equal a full exact scan, whichever side the
   boundary lands on;
2. direction: outside the band the proof fails whenever boundary >= theta
   (a pass there would be unsound) and passes when the boundary sits clearly
   below theta.

Classification is post hoc from a white-box replication with the same port
functions the verified path calls. The CPU variant runs the plain versions
(k = k' = 4, as the JAX test); the ``cuda`` variant takes k = k' = 16, so the
prescreen's k'+1 = 17 goes through the bf16 scores kernel (#10), whose
``wgmma`` accumulation the proof's rounding term must cover. Imports neither
JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from autorag_research_tpu_torch.ops import maxsim as tm

DELTAS = (-4096, -1024, -256, -64, -16, -4, -1, 0, 1, 4, 16, 64, 256, 1024, 4096)
BAND = 8.0  # ulps: replication / reduction-order noise allowance
N_SEEDS = 34  # x len(DELTAS) = 510 trials
NM, TD, TQ, DM = 256, 4, 2, 32


def _trial(seed: int, delta: int, km: int, dev) -> tuple[float, int]:
    """One trial: km strong documents collinear with the query (the km-th
    one's scale solved so e_k - eps sits ``delta`` ulps from the planted
    document's prescreen score, the (km+1)-th), k = k' = km. Returns
    ((boundary - theta) in ulps, n_fail)."""
    rng = np.random.default_rng(seed)
    qv = rng.normal(size=DM).astype(np.float32)
    qv /= np.linalg.norm(qv)
    q_np = np.broadcast_to(qv, (1, TQ, DM)).astype(np.float32).copy()
    docs = rng.normal(size=(NM, TD, DM)).astype(np.float32) * 0.02
    for row, sc in enumerate(np.linspace(0.45, 0.25, km - 1).astype(np.float32)):
        docs[row] = sc * qv
    planted = max(10, km + 6)
    docs[planted] = np.float32(0.16) * qv
    qq64 = float(qv.astype(np.float64) @ qv.astype(np.float64))
    q = torch.from_numpy(q_np).to(dev)
    ql = torch.tensor([TQ], dtype=torch.int32)
    dl = torch.full((NM,), TD, dtype=torch.int32, device=dev)
    q_lo = q.to(torch.bfloat16)
    q_mask = torch.ones((1, TQ), dtype=torch.bool, device=dev)

    def replicate(s_val):
        docs[km - 1] = np.float32(s_val) * qv  # the e_k owner
        side = tm.build_maxsim_sidecar(torch.from_numpy(docs).to(dev))
        eps = float(tm._maxsim_prescreen_eps(q, q_lo.float(), q_mask, side["nd_max"],
                                             side["r_max"])[0])
        ps, _ = tm.maxsim_topk(q_lo, ql, side["docs_lo"], dl, km + 1)
        return side, eps, float(ps[0, km])

    s_val = 0.18
    for _ in range(3):
        _, eps, boundary = replicate(s_val)
        ulp = float(np.spacing(np.float32(abs(boundary))))
        s_val = (boundary - delta * ulp + eps) / (TQ * qq64)
    side, eps, boundary = replicate(s_val)
    rs, ri = tm.maxsim_topk_scan(torch.from_numpy(q_np), ql, torch.from_numpy(docs), dl.cpu(), km)
    theta = float(rs[0, km - 1]) - eps
    s, i, n_fail, _ = tm.maxsim_topk_verified(
        q, ql, torch.from_numpy(docs).to(dev), dl, side, km, kprime=km, second_chance=0,
        return_stats=True,
    )
    np.testing.assert_array_equal(i.cpu().numpy(), ri.numpy())
    np.testing.assert_allclose(s.cpu().numpy(), rs.numpy(), rtol=1e-6, atol=1e-7)
    ulp = float(np.spacing(np.float32(max(abs(theta), abs(boundary)))))
    return (boundary - theta) / ulp, int(n_fail)


def _check(trials):
    pos = [t for t in trials if t[0] >= BAND]
    neg = [t for t in trials if t[0] <= -BAND]
    knife = [t for t in trials if abs(t[0]) <= 4.0]
    bad_pass = [t for t in pos if t[1] == 0]
    assert not bad_pass, f"proof passed on the unsafe side: {bad_pass[:5]}"
    bad_fail = [t for t in neg if t[1] != 0]
    assert not bad_fail, f"proof failed despite clear coverage: {bad_fail[:5]}"
    assert len(trials) == len(DELTAS) * N_SEEDS
    assert len(pos) >= 100 and len(neg) >= 100, (len(pos), len(neg))
    assert len(knife) >= 25, len(knife)


def test_maxsim_eps_boundary_fuzz_cpu():
    _check([_trial(5000 + 100 * di + sd, delta, 4, torch.device("cpu"))
            for di, delta in enumerate(DELTAS) for sd in range(N_SEEDS)])


@pytest.mark.cuda
def test_maxsim_eps_boundary_fuzz_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    tm.reset_launch_counts()
    trials = [_trial(5000 + 100 * di + sd, delta, 16, dev)
              for di, delta in enumerate(DELTAS) for sd in range(N_SEEDS)]
    assert tm.LAUNCHES["maxsim_scores_v2"] >= len(trials) * 5  # the prescreen's kernel
    assert tm.PLAIN_CALLS["maxsim_scores_v2_plain"] == 0
    _check(trials)
