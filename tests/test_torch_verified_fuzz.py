"""Adversarial eps-boundary fuzz of the port's verified-exact dense and MaxSim paths.

The port counterpart of ``test_verified_boundary_fuzz.py`` (same
constructions, same deltas, seeds and 8-ulp ``BAND``), through the port's
``dense_topk_verified`` and ``maxsim_topk_verified``. The proof's exactness
rests on one strict comparison per query, ``boundary < theta = e_k - eps``:
each trial plants a non-candidate document whose prescreen score lands a
given number of f32 ulps from theta, on both sides, and asserts

1. exactness always: the ids equal a full exact scan, whichever side the
   boundary lands on;
2. direction: outside the band the proof fails whenever boundary >= theta
   (a pass there would be unsound) and passes when the boundary sits clearly
   below theta.

Classification is post hoc from a white-box replication with the same port
functions the verified path calls. Dense: the CPU variant runs the 1,020
trials of the JAX test (bf16 and int8 prescreens, segments of 8, the plain
versions); the ``cuda`` variant runs the bf16 half with segments of 128, so
the prescreen goes through the seg-stats kernel (#1, ``wgmma`` sums). MaxSim:
the CPU variant runs the plain versions (k = k' = 4, as the JAX test); the
``cuda`` variant takes k = k' = 16, so the prescreen's k'+1 = 17 goes through
the bf16 scores kernel (#10), whose ``wgmma`` accumulation the proof's
rounding term must cover. Imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from autorag_research_tpu_torch.ops import dense as td
from autorag_research_tpu_torch.ops import maxsim as tm

DELTAS = (-4096, -1024, -256, -64, -16, -4, -1, 0, 1, 4, 16, 64, 256, 1024, 4096)
BAND = 8.0  # ulps: replication / reduction-order noise allowance
N_SEEDS = 34  # x len(DELTAS) = 510 trials
NM, TD, TQ, DM = 256, 4, 2, 32
# dense: S segments of seg docs, d = 32, k = 4, m = 4 segments' argmaxes and the
# j = 1 runner-up segment rescored
S, D, K, M, J = 48, 32, 4, 4, 1


def _dense_base(rng, qv, seg: int):
    """The JAX test's corpus: noise, a unit anchor orthogonal to the query
    (fixes nd_max and r_max), a decoy runner-up pair that wins the j = 1
    full-rescore slot, and three strong documents far above the boundary."""
    c = rng.normal(size=(seg * S, D)).astype(np.float32) * 0.02
    anchor = rng.normal(size=D).astype(np.float32)
    anchor -= (anchor @ qv) * qv
    anchor /= np.linalg.norm(anchor)
    c[1 * seg] = anchor
    c[2 * seg] = np.float32(0.30) * qv
    c[2 * seg + 1] = np.float32(0.29) * qv
    for srow, sc in zip((20, 25, 30), (0.95, 0.85, 0.75)):
        c[srow * seg + 3] = np.float32(sc) * qv
    return c


def _dense_replicate(q, side, n: int, seg: int):
    """The proof's inputs from the functions the verified path calls: (eps,
    boundary = the (m+1)-th segment max, m2bound = the (j+1)-th runner-up)."""
    qf = q.float()
    q_rep, q_hat = td._prescreen_query_side(qf, side["corpus_lo"], side["corpus_scale"])
    eps = float(td._prescreen_eps(qf, q_hat, side["nd_max"], side["r_max"])[0])
    if side["corpus_lo"].dtype == torch.int8:
        max1, _, max2 = td._seg_stats_plain(q_rep, side["corpus_lo"], side["corpus_scale"], n, seg)
    else:
        max1, _, max2 = td.seg_stats_bf16(q_rep[0], side["corpus_lo"], n, seg)
    m1 = np.sort(max1[0].cpu().numpy())[::-1]
    m2 = np.sort(max2[0].cpu().numpy())[::-1]
    return eps, float(m1[M]), float(m2[J])


def _dense_trial(rep: str, seed: int, delta: int, seg: int, dev) -> tuple[float, int, bool]:
    """One trial of the JAX test's construction at segments of ``seg``:
    (boundary - theta in ulps, n_fail, whether the runner-up channel stayed
    clear of theta)."""
    rng = np.random.default_rng(seed)
    qv = rng.normal(size=D).astype(np.float32)
    qv /= np.linalg.norm(qv)
    q = torch.from_numpy(qv[None, :].copy()).to(dev)
    c = _dense_base(rng, qv, seg)
    n = c.shape[0]
    c[10 * seg + 5] = np.float32(0.5) * qv  # the planted boundary document
    qq64 = float(qv.astype(np.float64) @ qv.astype(np.float64))

    def sidecar():
        side = td.build_verified_sidecar(c, rep=rep)
        side["corpus_lo"] = side["corpus_lo"].to(dev)
        if side["corpus_scale"] is not None:
            side["corpus_scale"] = side["corpus_scale"].to(dev)
        return side

    s_val = 0.52
    # fixed point: strong document 4's scale sets e_k, which sets theta, which
    # names the target the planted prescreen score must sit delta ulps from
    for _ in range(3):
        c[35 * seg + 3] = np.float32(s_val) * qv
        eps, boundary, _ = _dense_replicate(q, sidecar(), n, seg)
        ulp = float(np.spacing(np.float32(abs(boundary))))
        s_val = (boundary - delta * ulp + eps) / qq64
    c[35 * seg + 3] = np.float32(s_val) * qv
    side = sidecar()
    eps, boundary, m2b = _dense_replicate(q, side, n, seg)
    rs, ri = td.dense_topk_full(q.cpu(), torch.from_numpy(c), K)
    theta = float(rs[0, K - 1]) - eps
    s, i, n_fail, _ = td.dense_topk_verified(
        q, torch.from_numpy(c).to(dev), side, K, m=M, j=J, seg=seg, second_chance=0,
        return_stats=True,
    )
    np.testing.assert_array_equal(i.cpu().numpy(), ri.numpy())
    np.testing.assert_allclose(s.cpu().numpy(), rs.numpy(), rtol=1e-6, atol=1e-7)
    ulp = float(np.spacing(np.float32(max(abs(theta), abs(boundary)))))
    # the runner-up channel far from theta, or it decides the verdict: such
    # trials leave the direction counts
    return (boundary - theta) / ulp, int(n_fail), m2b < theta - 32 * ulp


def _dense_check(trials, knife_min: int):
    pos = [t for t in trials if t[0] >= BAND and t[2]]
    neg = [t for t in trials if t[0] <= -BAND and t[2]]
    knife = [t for t in trials if abs(t[0]) <= 4.0]
    bad_pass = [t for t in pos if t[1] == 0]
    assert not bad_pass, f"proof passed on the unsafe side: {bad_pass[:5]}"
    bad_fail = [t for t in neg if t[1] != 0]
    assert not bad_fail, f"proof failed despite clear coverage: {bad_fail[:5]}"
    assert len(trials) == len(DELTAS) * N_SEEDS
    assert len(pos) >= 100 and len(neg) >= 100, (len(pos), len(neg))
    assert len(knife) >= knife_min, len(knife)


@pytest.mark.parametrize("rep", ["bf16", "int8"])
def test_dense_eps_boundary_fuzz_cpu(rep):
    # the knife edge probed: bf16 and int8 land with different precision
    _dense_check([_dense_trial(rep, 1000 * (di + 1) + sd, delta, 8, torch.device("cpu"))
                  for di, delta in enumerate(DELTAS) for sd in range(N_SEEDS)],
                 25 if rep == "bf16" else 5)


@pytest.mark.cuda
def test_dense_eps_boundary_fuzz_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    td.reset_launch_counts()
    trials = [_dense_trial("bf16", 1000 * (di + 1) + sd, delta, 128, dev)
              for di, delta in enumerate(DELTAS) for sd in range(N_SEEDS)]
    assert td.LAUNCHES["seg_stats_bf16"] == len(trials) * 5  # 4 replications + the search
    _dense_check(trials, 25)


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
