"""Port ``ops/dense.py`` vs the JAX package's ``ops/dense.py``.

The same seeded numpy inputs go through both packages. The JAX side runs its
Pallas kernels as its own tests do on the CPU (``interpret=True``) or
through its XLA paths; the port runs on CPU tensors, where each kernel
wrapper takes its plain version. Tolerances: ids equal; scores within
``rtol=1e-6, atol=1e-7`` (f32 dot products summed in another order);
bitwise where every sum is exact (inputs that are small multiples of 1/8).
The CUDA kernels themselves are held against these plain versions in
``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorag_research_tpu.ops import dense as jd
from autorag_research_tpu_torch.ops import dense as td

RTOL, ATOL = 1e-6, 1e-7


def _corpus_with_dups(rng, n, d, n_dups=6):
    c = rng.normal(size=(n, d)).astype(np.float32)
    for _ in range(n_dups):
        src, dst = rng.integers(0, n, size=2)
        c[dst] = c[src]  # exact ties across the corpus
    return c


def _eighths(rng, shape):
    return (rng.integers(-8, 9, size=shape) / 8.0).astype(np.float32)


# ------------------------------------------------------------- exact paths
@pytest.mark.parametrize("method", ["full", "scan", "kernel"])
def test_exact_methods_match_jax(method):
    rng = np.random.default_rng(11)
    c = _corpus_with_dups(rng, 700, 48)
    q = rng.normal(size=(9, 48)).astype(np.float32)
    q[1] = c[5]  # the query that scores its own duplicate rows highest
    k = 12
    if method == "full":
        js, ji = jd.dense_topk_xla_full(jnp.asarray(q), jnp.asarray(c), k)
        ts, ti = td.dense_topk_full(torch.from_numpy(q), torch.from_numpy(c), k)
    elif method == "scan":
        js, ji = jd.dense_topk_xla(jnp.asarray(q), jnp.asarray(c), k, tile_n=128)
        ts, ti = td.dense_topk_scan(torch.from_numpy(q), torch.from_numpy(c), k, tile_n=128)
    else:
        js, ji = jd.dense_topk_pallas(
            jnp.asarray(q), jnp.asarray(c), k, block_q=8, block_n=128, interpret=True
        )
        ts, ti = td.dense_topk_stream(torch.from_numpy(q), torch.from_numpy(c), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


def test_stream_long_list_matches_jax():
    # k beyond one warp's lanes (recall@100): the plain version vs Pallas
    rng = np.random.default_rng(14)
    c = _corpus_with_dups(rng, 600, 32, n_dups=20)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    q[2] = c[9]
    js, ji = jd.dense_topk_pallas(
        jnp.asarray(q), jnp.asarray(c), 100, block_q=8, block_n=128, interpret=True
    )
    ts, ti = td.dense_topk_stream(torch.from_numpy(q), torch.from_numpy(c), 100)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


def test_stream_q_and_n_tails_match_jax():
    # Q past one 128-query tile and N past three 128-row tiles (the kernel's
    # block tile), exact ties across tile edges: the plain version vs Pallas
    rng = np.random.default_rng(15)
    c = _corpus_with_dups(rng, 389, 24, n_dups=4)
    c[125:131] = c[3]  # equal rows across the first tile edge
    c[380:] = c[3]  # and in the ragged last tile
    q = rng.normal(size=(130, 24)).astype(np.float32)
    q[127:130] = c[3]  # queries across the query-tile edge that score those rows first
    js, ji = jd.dense_topk_pallas(
        jnp.asarray(q), jnp.asarray(c), 17, block_q=8, block_n=128, interpret=True
    )
    ts, ti = td.dense_topk_stream(torch.from_numpy(q), torch.from_numpy(c), 17)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
    # the 16 rows equal to row 3 tie for query 128's top; the lowest ids come first
    np.testing.assert_array_equal(ti.numpy()[128, :13], [3, *range(125, 131), *range(380, 386)])


def test_exact_duplicate_rows_order_by_id_and_pad():
    c = np.tile(np.ones((1, 16), np.float32), (50, 1))
    q = np.ones((2, 16), np.float32)
    for fn in (td.dense_topk_full, td.dense_topk_scan, td.dense_topk_stream):
        _, ti = fn(torch.from_numpy(q), torch.from_numpy(c), 5)
        np.testing.assert_array_equal(ti.numpy(), np.tile(np.arange(5), (2, 1)))
    # k > N pads with the sentinels, like the JAX paths
    js, ji = jd.dense_topk_xla_full(jnp.asarray(q), jnp.asarray(c[:3]), 5)
    ts, ti = td.dense_topk_full(torch.from_numpy(q), torch.from_numpy(c[:3]), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_bf16_inputs_accumulate_in_f32():
    rng = np.random.default_rng(12)
    c = rng.normal(size=(300, 32)).astype(np.float32)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    cb, qb = jnp.asarray(c, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16)
    js, ji = jd.dense_topk_xla_full(qb, cb, 7)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tc = torch.from_numpy(c).to(torch.bfloat16)
    for fn in (td.dense_topk_full, td.dense_topk_stream):
        ts, ti = fn(tq, tc, 7)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


def test_dispatch_on_cpu(monkeypatch):
    rng = np.random.default_rng(13)
    c = torch.from_numpy(rng.normal(size=(400, 16)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    ref_s, ref_i = td.dense_topk_full(q, c, 6)
    td.reset_launch_counts()
    # over the budget a CPU tensor takes the kernel's plain version: no launch
    monkeypatch.setattr(td, "FULL_MATERIALIZE_BUDGET", 64)
    s, i = td.dense_topk(q, c, 6)
    assert td.LAUNCHES == {"seg_stats_bf16": 0, "dense_topk_stream": 0}
    np.testing.assert_array_equal(i.numpy(), ref_i.numpy())
    s2, i2 = td.dense_topk(q, c, 40)  # a longer list: still the kernel route
    np.testing.assert_array_equal(i2.numpy()[:, :6], ref_i.numpy())
    assert td.LAUNCHES == {"seg_stats_bf16": 0, "dense_topk_stream": 0}
    # any k: lists beyond the kernel's 256 shared-memory entries through the
    # kernel route and the dispatch, equal to the JAX package's (which sends
    # above-budget calls off the TPU to dense_topk_xla)
    big = 257
    js, ji = jd.dense_topk_xla(jnp.asarray(q.numpy()), jnp.asarray(c.numpy()), big)
    for s3, i3 in (td.dense_topk_stream(q, c, big), td.dense_topk(q, c, big),
                   td.dense_topk(q, c, big, method="scan")):
        np.testing.assert_array_equal(i3.numpy(), np.asarray(ji))
        # unnormalized rows: sums of magnitude up to ~15 in another order
        # differ by an ulp of 16 (1.9e-6), also where the score is near 0
        np.testing.assert_allclose(s3.numpy(), np.asarray(js), rtol=RTOL, atol=2e-6)
    np.testing.assert_array_equal(i3.numpy()[:, :6], ref_i.numpy())
    assert td.LAUNCHES == {"seg_stats_bf16": 0, "dense_topk_stream": 0}
    with pytest.raises(ValueError):
        td.dense_topk(q, c, 6, method="pallas")


def test_exact_scan_masked_matches_jax():
    rng = np.random.default_rng(3)
    n, d, k, n_valid = 1000, 32, 12, 900
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus[950:] = corpus[10]  # padded rows that must stay masked out
    corpus[100] = corpus[200]  # an exact tie inside the valid range
    queries = rng.standard_normal((7, d)).astype(np.float32)
    js, ji = jd._exact_scan_masked(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.int32(n_valid), k
    )
    ts, ti = td._exact_scan_masked(torch.from_numpy(queries), torch.from_numpy(corpus), n_valid, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------- prescreen pieces
@pytest.mark.parametrize("rep", ["bf16", "int8"])
def test_sidecar_matches_jax(rep):
    rng = np.random.default_rng(21)
    c = rng.normal(size=(333, 24)).astype(np.float32)
    js = jd.build_verified_sidecar(c, rep=rep, pad_rows_to=128)
    ts = td.build_verified_sidecar(c, rep=rep, pad_rows_to=128)
    np.testing.assert_array_equal(
        ts["corpus_lo"].float().numpy(), np.asarray(js["corpus_lo"]).astype(np.float32)
    )
    if rep == "int8":
        np.testing.assert_array_equal(ts["corpus_scale"].numpy(), js["corpus_scale"])
    else:
        assert ts["corpus_scale"] is None
    assert ts["nd_max"] == js["nd_max"] and ts["r_max"] == js["r_max"]


def test_quantize_int8_tensor_matches_jax():
    rng = np.random.default_rng(22)
    x = rng.normal(size=(9, 40)).astype(np.float32)
    x[3] = 0.0
    jq, js = jd.quantize_int8(jnp.asarray(x))
    tq, ts = td.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _seg_inputs(rng, exact: bool, q=8, rows=2048, d=64):
    gen = _eighths if exact else (lambda r, s: r.normal(size=s).astype(np.float32))
    q_lo = gen(rng, (q, d))
    c = gen(rng, (rows, d))
    c[40:44] = c[7]  # duplicate rows: exact ties inside and across segments
    c[130] = c[129]
    return q_lo, c


@pytest.mark.parametrize("exact", [True, False], ids=["eighths-bitwise", "random"])
def test_seg_stats_plain_matches_pallas_and_xla(exact):
    rng = np.random.default_rng(31 + exact)
    q_np, c_np = _seg_inputs(rng, exact)
    n = 1900  # rows >= n are padding: masked to NEG_INF
    qj = jnp.asarray(q_np, jnp.bfloat16)
    cj = jnp.asarray(c_np, jnp.bfloat16)
    ref_p = jd._seg_stats_pallas(qj, cj, jnp.int32(n), 128, interpret=True)
    ref_x = jd._seg_stats_xla((qj, None), cj, None, jnp.int32(n), 128)
    got = td.seg_stats_bf16(
        torch.from_numpy(q_np).to(torch.bfloat16), torch.from_numpy(c_np).to(torch.bfloat16), n
    )
    for ref in (ref_p, ref_x):
        m1, l1, m2 = (np.asarray(a) for a in ref)
        if exact:
            np.testing.assert_array_equal(got[0].numpy(), m1)
            np.testing.assert_array_equal(got[2].numpy(), m2)
        else:
            np.testing.assert_allclose(got[0].numpy(), m1, rtol=RTOL)
            np.testing.assert_allclose(got[2].numpy(), m2, rtol=RTOL)
        np.testing.assert_array_equal(got[1].numpy(), l1)
    assert (got[0].numpy()[:, -1] == td.NEG_INF).all()  # the all-padding segment


def test_seg_stats_plain_int8_matches_xla():
    rng = np.random.default_rng(33)
    c = rng.normal(size=(500, 24)).astype(np.float32)
    q = rng.normal(size=(5, 24)).astype(np.float32)
    js = jd.build_verified_sidecar(c, rep="int8")
    ts = td.build_verified_sidecar(c, rep="int8")
    jrep, _ = jd._prescreen_query_side(
        jnp.asarray(q), jnp.asarray(js["corpus_lo"]), jnp.asarray(js["corpus_scale"])
    )
    trep, _ = td._prescreen_query_side(torch.from_numpy(q), ts["corpus_lo"], ts["corpus_scale"])
    ref = jd._seg_stats_xla(
        jrep, jnp.asarray(js["corpus_lo"]), jnp.asarray(js["corpus_scale"]), jnp.int32(480), 32
    )
    got = td._seg_stats_plain(trep, ts["corpus_lo"], ts["corpus_scale"], 480, 32)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------- verified
@pytest.mark.parametrize("seed", range(4))
def test_verified_matches_jax(seed):
    """Random corpora (some with duplicate rows), both prescreen reps, random
    knobs: ids, scores and (n_fail, covered) equal the JAX package's, whose
    bf16 run goes through its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(900 + seed)
    n = int(rng.integers(50, 2500))
    d = int(rng.choice([8, 24, 48]))
    k = int(rng.integers(1, 12))
    c = _corpus_with_dups(rng, n, d, n_dups=int(rng.integers(0, 4)))
    if seed % 2:
        c /= np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-9)
    q = rng.normal(size=(int(rng.integers(1, 9)), d)).astype(np.float32)
    knobs = dict(
        m=int(rng.integers(4, 40)), j=int(rng.integers(1, 3)),
        seg=int(rng.choice([8, 16, 32])), second_chance=int(rng.integers(0, 4)),
    )
    for rep in ("int8", "bf16"):
        js = jd.build_verified_sidecar(c, rep=rep)
        engines = (("xla", False), ("pallas", True)) if rep == "bf16" else (("xla", False),)
        ts = td.build_verified_sidecar(c, rep=rep)
        t_out = td.dense_topk_verified(
            torch.from_numpy(q), torch.from_numpy(c), ts, k, return_stats=True, **knobs
        )
        for engine, interp in engines:
            j_out = jd.dense_topk_verified(
                jnp.asarray(q), jnp.asarray(c), js, k, engine=engine, interpret=interp,
                return_stats=True, **knobs,
            )
            np.testing.assert_array_equal(t_out[1].numpy(), np.asarray(j_out[1]))
            np.testing.assert_allclose(t_out[0].numpy(), np.asarray(j_out[0]), rtol=RTOL, atol=ATOL)
            assert (t_out[2], t_out[3]) == (int(j_out[2]), bool(j_out[3])), (rep, engine)


def test_verified_batch_fallback_matches_jax(monkeypatch):
    """Coverage proof forced to fail with the flat fallback over budget in
    both packages: the streaming exact fallback decides every row."""
    rng = np.random.default_rng(5)
    n, d, nq, k = 4096, 32, 3, 10
    base = rng.standard_normal(d).astype(np.float32)
    corpus = np.tile(base, (n, 1)) + 1e-4 * rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    monkeypatch.setattr(jd, "FULL_MATERIALIZE_BUDGET", 1024)
    monkeypatch.setattr(td, "FULL_MATERIALIZE_BUDGET", 1024)
    knobs = dict(m=4, j=1, seg=128, second_chance=1, return_stats=True)
    js, ji, jf, jc = jd.dense_topk_verified(
        jnp.asarray(queries), jnp.asarray(corpus),
        jd.build_verified_sidecar(corpus, rep="bf16"), k, engine="xla", **knobs,
    )
    ts, ti, tf, tc = td.dense_topk_verified(
        torch.from_numpy(queries), torch.from_numpy(corpus),
        td.build_verified_sidecar(corpus, rep="bf16"), k, **knobs,
    )
    assert (tf, tc) == (int(jf), bool(jc)) == (nq, False)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


# planted boundary case, built as tests/test_verified_boundary_fuzz.py builds
# it: a non-candidate doc whose prescreen score sits `delta` f32 ulps from
# theta = e_k - eps, on either side
SEG, S, D, K, M, J = 8, 48, 32, 4, 4, 1


def _planted(rep, seed, delta):
    rng = np.random.default_rng(seed)
    qv = rng.normal(size=D).astype(np.float32)
    qv /= np.linalg.norm(qv)
    q = qv[None, :]
    c = rng.normal(size=(SEG * S, D)).astype(np.float32) * 0.02
    anchor = rng.normal(size=D).astype(np.float32)
    anchor -= (anchor @ qv) * qv
    c[1 * SEG] = anchor / np.linalg.norm(anchor)
    c[2 * SEG] = np.float32(0.30) * qv
    c[2 * SEG + 1] = np.float32(0.29) * qv
    for srow, sc in zip((20, 25, 30), (0.95, 0.85, 0.75)):
        c[srow * SEG + 3] = np.float32(sc) * qv
    c[10 * SEG + 5] = np.float32(0.5) * qv  # the planted boundary doc
    qq64 = float(qv.astype(np.float64) @ qv.astype(np.float64))
    s_val = 0.52
    for _ in range(3):
        c[35 * SEG + 3] = np.float32(s_val) * qv
        side = jd.build_verified_sidecar(c, rep=rep)
        qf = jnp.asarray(q)
        lo = jnp.asarray(side["corpus_lo"])
        cs = None if side["corpus_scale"] is None else jnp.asarray(side["corpus_scale"])
        q_rep, q_hat = jd._prescreen_query_side(qf, lo, cs)
        eps = float(jd._prescreen_eps(
            qf, q_hat, jnp.float32(side["nd_max"]), jnp.float32(side["r_max"])
        )[0])
        max1, _, _ = jd._seg_stats_xla(q_rep, lo, cs, jnp.int32(SEG * S), SEG)
        boundary = float(np.sort(np.asarray(max1[0]))[::-1][M])
        ulp = float(np.spacing(np.float32(abs(boundary))))
        s_val = (boundary - delta * ulp + eps) / qq64
    c[35 * SEG + 3] = np.float32(s_val) * qv
    return q, c


@pytest.mark.parametrize("rep", ["bf16", "int8"])
@pytest.mark.parametrize("delta", [-16, 16])
def test_verified_planted_boundary_matches_jax(rep, delta):
    q, c = _planted(rep, 4242 + delta, delta)
    knobs = dict(m=M, j=J, seg=SEG, second_chance=0, return_stats=True)
    js, ji, jf, jc = jd.dense_topk_verified(
        jnp.asarray(q), jnp.asarray(c), jd.build_verified_sidecar(c, rep=rep), K,
        engine="xla", **knobs,
    )
    ts, ti, tf, tc = td.dense_topk_verified(
        torch.from_numpy(q), torch.from_numpy(c), td.build_verified_sidecar(c, rep=rep), K,
        **knobs,
    )
    # boundary above theta must fail the proof (and fall back); below, pass
    assert (tf, tc) == (int(jf), bool(jc)) == (int(delta > 0), delta < 0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
    rs, ri = jd.dense_topk_xla_full(jnp.asarray(q), jnp.asarray(c), K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
