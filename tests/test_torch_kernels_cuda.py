"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA device.
The file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Inputs that are small multiples of 1/8 make every dot product exact in f32
whatever the summation order, so kernel and plain version agree bitwise.
"""

import numpy as np
import pytest
import torch

from autorag_research_tpu_torch.index.dense import DenseIndex
from autorag_research_tpu_torch.ops import dense as td


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _eighths(rng, shape):
    return (rng.integers(-8, 9, size=shape) / 8.0).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(3000, 2950), (2048, 2048), (77, 60)])
def test_seg_stats_kernel_matches_plain(cuda_device, rows, n):
    rng = np.random.default_rng(rows)
    q_np, c_np = _eighths(rng, (200, 96)), _eighths(rng, (rows, 96))
    c_np[40:44] = c_np[7]  # exact ties inside a segment and across segments
    q = torch.from_numpy(q_np).to(cuda_device, torch.bfloat16)
    c = torch.from_numpy(c_np).to(cuda_device, torch.bfloat16)
    before = td.LAUNCHES["seg_stats_bf16"]
    got = td.seg_stats_bf16(q, c, n)
    torch.cuda.synchronize()
    assert td.LAUNCHES["seg_stats_bf16"] == before + 1
    ref = td._seg_stats_plain((q, None), c, None, n, 128)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_kernel_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(42)
    c_np = _eighths(rng, (5000, 64))
    c_np[100:140] = c_np[7]  # exact ties across tiles and parts
    q_np = _eighths(rng, (130, 64))
    q = torch.from_numpy(q_np).to(cuda_device, dtype)
    c = torch.from_numpy(c_np).to(cuda_device, dtype)
    before = td.LAUNCHES["dense_topk_stream"]
    s, i = td.dense_topk_stream(q, c, 10)
    torch.cuda.synchronize()
    assert td.LAUNCHES["dense_topk_stream"] == before + 1
    rs, ri = td.dense_topk_plain(q, c, 10)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [33, 100, 256])
def test_stream_kernel_long_lists_match_plain(cuda_device, dtype, k):
    # lists longer than a warp's lanes, many exact ties (dot products of eighths)
    rng = np.random.default_rng(k)
    c_np = _eighths(rng, (7000, 64))
    c_np[500:800] = c_np[3]
    q_np = _eighths(rng, (70, 64))
    q = torch.from_numpy(q_np).to(cuda_device, dtype)
    c = torch.from_numpy(c_np).to(cuda_device, dtype)
    before = td.LAUNCHES["dense_topk_stream"]
    s, i = td.dense_topk_stream(q, c, k)
    torch.cuda.synchronize()
    assert td.LAUNCHES["dense_topk_stream"] == before + 1
    rs, ri = td.dense_topk_plain(q, c, k)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)


@pytest.mark.cuda
def test_stream_kernel_random_floats(cuda_device):
    # random f32: sums differ from cuBLAS's order by ~ulps, scores by ~1e-6
    rng = np.random.default_rng(43)
    c = torch.from_numpy(rng.normal(size=(20000, 128)).astype(np.float32)).to(cuda_device)
    q = torch.from_numpy(rng.normal(size=(300, 128)).astype(np.float32)).to(cuda_device)
    s, i = td.dense_topk_stream(q, c, 32)
    rs, ri = td.dense_topk_full(q, c, 32)
    torch.testing.assert_close(s, rs, rtol=1e-6, atol=1e-5)
    assert (i == ri).float().mean().item() > 0.999


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_operands(cuda_device):
    c = torch.zeros((256, 12), device=cuda_device)  # d % 8 != 0
    with pytest.raises(ValueError):
        td.dense_topk_stream(c[:4], c, 5)
    c16 = torch.zeros((512, 16), device=cuda_device)
    with pytest.raises(ValueError):
        td.dense_topk_stream(c16[:4], c16, td.STREAM_K_MAX + 1)
    cb = torch.zeros((256, 16), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        td.seg_stats_bf16(cb[:4], cb, 256, seg=64)
    with pytest.raises(ValueError):
        td.seg_stats_bf16(cb[:4], cb, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "verified"])
def test_dense_index_cuda_matches_cpu(cuda_device, mode):
    rng = np.random.default_rng(44)
    emb = rng.normal(size=(3000, 64)).astype(np.float32)
    emb[10] = emb[20]
    qs = rng.normal(size=(50, 64)).astype(np.float32)
    qs[3] = emb[10]
    ids = list(range(3000))
    cpu = DenseIndex(ids, emb, mode=mode, device="cpu").topk_rows(qs, 10)
    gpu_idx = DenseIndex(ids, emb, mode=mode, device=cuda_device)
    gpu = gpu_idx.topk_rows(torch.from_numpy(qs).to(cuda_device), 10)
    np.testing.assert_array_equal(gpu[1], cpu[1])
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ MaxSim
def _mv_data(rng, b, tq, n, td, d, empty=(), dyadic=True):
    """Padded token tensors with ragged lengths: queries [b, tq, d] + lens,
    docs [n, td, d] + lens, ``empty`` docs of length 0, rows 9 and n - 3
    duplicating row 4 (exact ties on dyadic data)."""
    def vals(shape):
        if dyadic:
            return _eighths(rng, shape)
        return rng.normal(size=shape).astype(np.float32)

    q = vals((b, tq, d))
    ql = rng.integers(1, tq + 1, size=b).astype(np.int32)
    ql[0] = tq
    docs = vals((n, td, d))
    dl = rng.integers(1, td + 1, size=n).astype(np.int32)
    docs[[9, n - 3]] = docs[4]
    dl[[9, n - 3]] = dl[4]
    dl[list(empty)] = 0
    docs *= (np.arange(td)[None, :] < dl[:, None])[:, :, None]
    return q, ql, docs, dl


def _mv_tensors(arrays, device, dtype):
    q, ql, docs, dl = arrays
    return (torch.from_numpy(q).to(device, dtype), torch.from_numpy(ql).to(device),
            torch.from_numpy(docs).to(device, dtype), torch.from_numpy(dl).to(device))


# B < 8 and several query blocks; Tq and Td not multiples of 8; a query longer
# than one 128-row tile; N not a multiple of the 32-document step
MV_SHAPES = [(3, 13, 1007, 70, 40), (21, 16, 333, 9, 64), (5, 150, 200, 33, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 16])
@pytest.mark.parametrize("shape", MV_SHAPES, ids=["long-docs", "blocks", "long-query"])
def test_maxsim_fused_kernel_matches_plain(cuda_device, dtype, k, shape):
    from autorag_research_tpu_torch.ops import maxsim as tm

    args = _mv_tensors(_mv_data(np.random.default_rng(k), *shape, empty=(0, 11)), cuda_device, dtype)
    before = tm.LAUNCHES["maxsim_topk_v2"]
    s, i = tm.maxsim_topk_v2(*args, k)
    torch.cuda.synchronize()
    assert tm.LAUNCHES["maxsim_topk_v2"] == before + 1
    rs, ri = tm.maxsim_topk_v2_plain(*args, k)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [100, 256])
def test_maxsim_fused_kernel_long_lists(cuda_device, dtype, k):
    # lists longer than a warp's lanes, 16 queries of 8 rows per block: the
    # largest list memory the kernel takes (16 x 256 entries)
    from autorag_research_tpu_torch.ops import maxsim as tm

    args = _mv_tensors(_mv_data(np.random.default_rng(k), 37, 7, 1500, 40, 32, empty=(3,)),
                       cuda_device, dtype)
    s, i = tm.maxsim_topk_v2(*args, k)
    rs, ri = tm.maxsim_topk_v2_plain(*args, k)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MV_SHAPES, ids=["long-docs", "blocks", "long-query"])
def test_maxsim_scores_kernel_matches_plain(cuda_device, dtype, shape):
    from autorag_research_tpu_torch.ops import maxsim as tm

    args = _mv_tensors(_mv_data(np.random.default_rng(7), *shape, empty=(2,)), cuda_device, dtype)
    before = tm.LAUNCHES["maxsim_scores_v2"]
    got = tm.maxsim_scores_v2(*args)
    torch.cuda.synchronize()
    assert tm.LAUNCHES["maxsim_scores_v2"] == before + 1
    torch.testing.assert_close(got, tm.maxsim_scores_v2_plain(*args), rtol=0, atol=0)
    assert (got[:, 2] == tm.NEG_INF).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxsim_scores_route_at_prescreen_k_with_query_chunks(cuda_device, dtype):
    # k'+1 = 65 through the scores kernel, four query chunks of 6 rows
    from autorag_research_tpu_torch.ops import maxsim as tm

    args = _mv_tensors(_mv_data(np.random.default_rng(65), 24, 11, 900, 40, 32, empty=(5,)),
                       cuda_device, dtype)
    tm.reset_launch_counts()
    s, i = tm.maxsim_topk_via_scores(*args, 65, chunk_b=6)
    assert tm.LAUNCHES["maxsim_scores_v2"] == 4
    rs, ri = tm.maxsim_topk_v2_plain(*args, 65)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)


@pytest.mark.cuda
def test_maxsim_auto_route_launches_kernels(cuda_device):
    from autorag_research_tpu_torch.ops import maxsim as tm

    args = _mv_tensors(_mv_data(np.random.default_rng(3), 9, 8, 500, 20, 32), cuda_device,
                       torch.float32)
    tm.reset_launch_counts()
    s16, i16 = tm.maxsim_topk(*args, 16)
    s17, i17 = tm.maxsim_topk(*args, 17)
    assert tm.LAUNCHES == {"maxsim_topk_v2": 1, "maxsim_scores_v2": 1}
    assert sum(tm.PLAIN_CALLS.values()) == 0  # the card's tensors never take a plain route
    torch.testing.assert_close(i17[:, :16], i16, rtol=0, atol=0)
    torch.testing.assert_close(s17[:, :16], s16, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxsim_kernels_random_floats(cuda_device, dtype):
    # random floats: sums differ from the plain order by ulps; an id may
    # differ only between scores within the f32 rounding term of the proof
    from autorag_research_tpu_torch.ops import maxsim as tm

    rng = np.random.default_rng(44)
    q, ql, docs, dl = _mv_data(rng, 40, 32, 3000, 64, 128, dyadic=False)
    q /= np.maximum(np.linalg.norm(q, axis=2, keepdims=True), 1e-9)
    docs /= np.maximum(np.linalg.norm(docs, axis=2, keepdims=True), 1e-9)
    args = _mv_tensors((q, ql, docs, dl), cuda_device, dtype)
    s, i = tm.maxsim_topk_v2(*args, 10)
    rs, ri = tm.maxsim_topk_v2_plain(*args, 10)
    torch.testing.assert_close(s, rs, rtol=1e-5, atol=1e-5)
    tol = (128 + 32) * 2.0**-23 * 32  # unit-norm tokens, 32 query tokens
    mism = i != ri
    assert bool(((s - rs).abs()[mism] <= tol).all())
    torch.testing.assert_close(tm.maxsim_scores_v2(*args), tm.maxsim_scores_v2_plain(*args),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_maxsim_wrappers_refuse_bad_operands(cuda_device):
    from autorag_research_tpu_torch.ops import maxsim as tm

    q = torch.zeros((2, 4, 12), device=cuda_device)  # d % 8 != 0
    docs = torch.zeros((50, 6, 12), device=cuda_device)
    lens = torch.full((50,), 6, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        tm.maxsim_topk_v2(q, lens[:2], docs, lens, 5)
    q16, d16 = torch.zeros((2, 4, 16), device=cuda_device), torch.zeros((300, 6, 16), device=cuda_device)
    with pytest.raises(ValueError):
        tm.maxsim_topk_v2(q16, lens[:2], d16, torch.full((300,), 6, device=cuda_device), 257)
    with pytest.raises(ValueError):
        tm.maxsim_scores_v2(q16, lens[:2], d16.to(torch.bfloat16), lens)
    with pytest.raises(NotImplementedError):
        tm.maxsim_topk(q16, lens[:2], d16[:50], lens, 5, method="pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{"mode": "exact"}, {"mode": "verified"}, {"bucketize": 3}],
                         ids=["exact", "verified", "bucketed"])
@pytest.mark.parametrize("k", [10, 40])
def test_multi_vector_index_cuda_matches_cpu(cuda_device, opts, k):
    from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex

    rng = np.random.default_rng(45)
    mats = [rng.normal(size=(int(rng.integers(0, 40)), 64)).astype(np.float32) for _ in range(2000)]
    queries = [rng.normal(size=(int(rng.integers(3, 33)), 64)).astype(np.float32) for _ in range(30)]
    ids = list(range(2000))
    cpu = MultiVectorIndex(ids, mats, device="cpu", **opts).topk_rows(queries, k)
    gpu_idx = MultiVectorIndex(ids, mats, device=cuda_device, **opts)
    gpu = gpu_idx.topk_rows(queries, k)
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-5, atol=1e-5)
    mism = gpu[1] != cpu[1]
    assert (np.abs(gpu[0] - cpu[0])[mism] <= 1e-5).all()
    if opts.get("mode") == "verified":
        # verified = exact mode on the card, sub-ulp near-ties aside
        exact = MultiVectorIndex(ids, mats, device=cuda_device).topk_rows(queries, k)
        mism = gpu[1] != exact[1]
        assert (np.abs(gpu[0] - exact[0])[mism] <= 1e-5).all()
        assert gpu_idx.last_stats is not None
