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
@pytest.mark.parametrize("rows,n,d,q_cnt", [
    (3000, 2950, 96, 200), (2048, 2048, 96, 200), (77, 60, 96, 200),
    (2048, 1500, 96, 200),  # whole segments past n
    (3000, 2950, 8, 70),  # d = 8, one query tile: single blocks
    (1000, 777, 104, 256),  # d = 104 (100 padded), two query tiles: a cluster of two
    (700, 700, 768, 130),
])
def test_seg_stats_kernel_matches_plain(cuda_device, rows, n, d, q_cnt):
    # Q = 200, 70 and 130 are not multiples of 64; ties planted inside a
    # segment, across the four threads of a quad (a whole segment of one row:
    # all 128 lanes tie) and across the two segments of one 256-row item
    rng = np.random.default_rng(rows + d)
    q_np, c_np = _eighths(rng, (q_cnt, d)), _eighths(rng, (rows, d))
    c_np[40:44] = c_np[7]
    if rows >= 256:
        c_np[128:256] = c_np[130]
    if rows > 400:
        c_np[300] = c_np[400] = 1.0
    q = torch.from_numpy(q_np).to(cuda_device, torch.bfloat16)
    c = torch.from_numpy(c_np).to(cuda_device, torch.bfloat16)
    before = td.LAUNCHES["seg_stats_bf16"]
    got = td.seg_stats_bf16(q, c, n)
    torch.cuda.synchronize()
    assert td.LAUNCHES["seg_stats_bf16"] == before + 1
    ref = td._seg_stats_plain((q, None), c, None, n, 128)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    if rows >= 256:
        assert bool((got[1][:, 1] == 0).all()) and torch.equal(got[0][:, 1], got[2][:, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("q_cnt", [200, 300])
def test_seg_stats_launcher_refuses_a_plan_off_its_layout(cuda_device, q_cnt):
    # the plan's shared-memory bytes equal the launcher's own count; a plan
    # whose bytes differ, or whose cluster does not divide the query tiles,
    # is refused before launch (cudaErrorInvalidValue)
    import ctypes

    from autorag_research_tpu_torch.ops import cuda_build

    lib = cuda_build.load("seg_stats")
    count = lib.seg_stats_smem_bytes
    count.argtypes = []
    count.restype = ctypes.c_int
    plan = td._seg_plan_on_card(q_cnt, 1000, 64, cuda_device)
    assert count() == plan.smem_bytes == td.SEG_SMEM_BYTES
    assert plan.cluster == (2 if q_cnt == 200 else 1) and plan.grid % plan.cluster == 0
    assert plan.grid // plan.cluster <= plan.resident  # one wave of what the card holds
    q = torch.zeros((q_cnt, 64), dtype=torch.bfloat16, device=cuda_device)
    c = torch.zeros((1000, 64), dtype=torch.bfloat16, device=cuda_device)
    out = [torch.empty((q_cnt, 8), device=cuda_device) for _ in range(3)]
    fn = lib.seg_stats_bf16_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(smem, cluster=plan.cluster, grid=plan.grid):
        return fn(q.data_ptr(), c.data_ptr(), *(t.data_ptr() for t in out), q_cnt, 1000, 64,
                  1000, 8, cluster, grid, smem, torch.cuda.current_stream().cuda_stream)

    assert launch(plan.smem_bytes + 16) == 1
    assert launch(plan.smem_bytes - 16) == 1
    assert launch(plan.smem_bytes, grid=plan.grid + 1) == (1 if plan.cluster == 2 else 0)
    if plan.cluster == 1:
        assert launch(plan.smem_bytes, cluster=2, grid=2) == 1  # three query tiles
    assert launch(plan.smem_bytes) == 0
    torch.cuda.synchronize()


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
    # d % 8 != 0 and lists beyond shared memory run (zero-padded d, lists in
    # the output); a wrong seg or valid-row count still raises
    rng = np.random.default_rng(12)
    c = torch.from_numpy(_eighths(rng, (256, 12))).to(cuda_device)
    for q, k in ((c[:4], 5), (c[:70], 257)):
        s, i = td.dense_topk_stream(q.contiguous(), c, k)
        rs, ri = td.dense_topk_plain(q.contiguous(), c, k)
        torch.testing.assert_close(i, ri, rtol=0, atol=0)
        torch.testing.assert_close(s, rs, rtol=0, atol=0)
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
def _mv_data(rng, b, tq, n, td, d, empty=(), dyadic=True, zero_q=()):
    """Padded token tensors with ragged lengths: queries [b, tq, d] + lens
    (the queries ``zero_q`` of length 0, their rows zero), docs [n, td, d] +
    lens, ``empty`` docs of length 0, rows 9 and n - 3 duplicating row 4
    (exact ties on dyadic data)."""
    def vals(shape):
        if dyadic:
            return _eighths(rng, shape)
        return rng.normal(size=shape).astype(np.float32)

    q = vals((b, tq, d))
    ql = rng.integers(1, tq + 1, size=b).astype(np.int32)
    ql[0] = tq
    if zero_q:
        ql[list(zero_q)] = 0
        q *= (np.arange(tq)[None, :] < ql[:, None])[:, :, None]
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


# The tile body's packing and walk: query lengths that fill a row tile (128
# rows in f32, 256 in bf16) exactly, run one row over, or span two and three
# tiles (a zero-length query among them); documents of 0, 1, each chunk and
# product-tile edge +- 1 and Td tokens; N = 1,307, a multiple of no step
# (groups of 32, chunks of 16).
MV_QUERY_MIXES = {
    "fill": [32, 32, 32, 32, 0, 5, 123],
    "over": [64, 65, 1, 128, 129, 256, 257],
    "span3": [3, 300, 2, 600, 7],
}
MV_EDGE_LENS = [0, 1, 15, 16, 17, 31, 32, 33, 127, 128, 129, 139, 140]


def _mv_edge_data(mix: str, d: int, n: int = 1307, td: int = 140):
    rng = np.random.default_rng(len(mix) * 1000 + d)
    ql = np.array(MV_QUERY_MIXES[mix], dtype=np.int32)
    q = _eighths(rng, (ql.size, int(ql.max()), d))
    q *= (np.arange(q.shape[1])[None, :] < ql[:, None])[:, :, None]
    docs = _eighths(rng, (n, td, d))
    dl = rng.integers(1, td + 1, size=n).astype(np.int32)
    dl[20 : 20 + len(MV_EDGE_LENS)] = MV_EDGE_LENS
    docs[[9, n - 3]] = docs[4]  # exact ties across groups and parts
    dl[[9, n - 3]] = dl[4]
    docs *= (np.arange(td)[None, :] < dl[:, None])[:, :, None]
    return q, ql, docs, dl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [0, 1, 10, 16, 65, 256, 1000], ids=lambda k: f"k{k}" if k else "scores")
@pytest.mark.parametrize("d", [8, 104, 128])
@pytest.mark.parametrize("mix", list(MV_QUERY_MIXES))
def test_maxsim_tile_body_edges_bitwise(cuda_device, mix, d, k, dtype):
    # #9 (k > 0) and #10 (k = 0) against their plain versions on CPU tensors,
    # bitwise; query lengths on the host as MultiVectorIndex passes them
    from autorag_research_tpu_torch.ops import maxsim as tm

    arrays = _mv_edge_data(mix, d)
    cpu = _mv_tensors(arrays, "cpu", dtype)
    q, ql, docs, dl = _mv_tensors(arrays, cuda_device, dtype)
    tm.reset_launch_counts()
    if k:
        s, i = tm.maxsim_topk_v2(q, ql.cpu(), docs, dl, k)
    else:
        got = tm.maxsim_scores_v2(q, ql.cpu(), docs, dl)
    torch.cuda.synchronize()
    assert tm.LAUNCHES["maxsim_topk_v2" if k else "maxsim_scores_v2"] == 1
    assert sum(tm.PLAIN_CALLS.values()) == 0  # no plain route on the card
    if k:
        rs, ri = tm.maxsim_topk_v2_plain(*cpu, k)
        torch.testing.assert_close(i.cpu(), ri, rtol=0, atol=0)
        torch.testing.assert_close(s.cpu(), rs, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got.cpu(), tm.maxsim_scores_v2_plain(*cpu), rtol=0, atol=0)
        assert (got[:, 20] == tm.NEG_INF).all()  # the empty document keeps NEG_INF


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxsim_tile_body_streamed_queries(cuda_device, dtype):
    # rows too wide to stay resident beside the ring (f32 d = 520, bf16 d =
    # 1,040): every slot carries the query k-box beside the tokens'
    from autorag_research_tpu_torch.ops import maxsim as tm

    d = 520 if dtype == torch.float32 else 1040
    arrays = _mv_data(np.random.default_rng(d), 9, 40, 700, 37, d, empty=(5,))
    plan = tm.maxsim_plan(arrays[1], 700, 37, d, 10, dtype, 132, 1)
    assert not plan.resident
    args = _mv_tensors(arrays, cuda_device, dtype)
    cpu = _mv_tensors(arrays, "cpu", dtype)
    s, i = tm.maxsim_topk_v2(*args, 10)
    rs, ri = tm.maxsim_topk_v2_plain(*cpu, 10)
    torch.testing.assert_close(i.cpu(), ri, rtol=0, atol=0)
    torch.testing.assert_close(s.cpu(), rs, rtol=0, atol=0)
    torch.testing.assert_close(tm.maxsim_scores_v2(*args).cpu(), tm.maxsim_scores_v2_plain(*cpu),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [0, 1])
@pytest.mark.parametrize("k", [0, 10, 1000])
def test_maxsim_launcher_refuses_a_plan_off_its_layout(cuda_device, bf16, k):
    # the plan's shared-memory bytes equal the launcher's own count; a plan
    # whose bytes differ is refused before launch (cudaErrorInvalidValue)
    import ctypes

    from autorag_research_tpu_torch.ops import cuda_build
    from autorag_research_tpu_torch.ops import maxsim as tm

    dtype = torch.bfloat16 if bf16 else torch.float32
    q, ql, docs, dl = _mv_tensors(_mv_data(np.random.default_rng(5), 4, 9, 2000, 20, 128),
                                  cuda_device, dtype)
    plan = tm.v2_plan_on_card(ql.cpu().numpy(), 2000, 20, 128, k, dtype, cuda_device)
    lib = cuda_build.load("maxsim_v2")
    count = lib.maxsim_v2_smem_bytes
    count.argtypes = [ctypes.c_int] * 6
    count.restype = ctypes.c_int
    assert count(bf16, plan.k_boxes, plan.stages, int(plan.resident),
                 int(plan.lists == "shared"), min(k, 2000)) == plan.smem_bytes
    table = torch.from_numpy(plan.table).to(cuda_device)
    qp = torch.zeros((plan.q_rows, 128), dtype=dtype, device=cuda_device)
    out_s = torch.empty((4, plan.parts, max(k, 1)) if k else (4, 2000), device=cuda_device)
    out_i = torch.empty((4, plan.parts, max(k, 1)), dtype=torch.int32, device=cuda_device)
    name = f"maxsim_{'topk' if k else 'scores'}_v2_{'bf16' if bf16 else 'f32'}_launch"
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(smem):
        return fn(qp.data_ptr(), docs.data_ptr(), dl.data_ptr(), table.data_ptr(),
                  out_s.data_ptr(), out_i.data_ptr(), 4, 2000, 20, 128, plan.q_rows, min(k, 2000),
                  plan.blocks, plan.parts, plan.part_docs, plan.grid, plan.stages,
                  int(plan.resident), int(plan.lists == "shared"), smem,
                  torch.cuda.current_stream().cuda_stream)

    assert launch(plan.smem_bytes + 16) == 1
    assert launch(plan.smem_bytes - 16) == 1
    assert launch(plan.smem_bytes) == 0
    torch.cuda.synchronize()


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
    assert tm.LAUNCHES == {
        "maxsim_topk_v2": 1, "maxsim_scores_v2": 1, "maxsim_topk_v1": 0, "maxsim_topk_v3": 0,
    }
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
    # d % 8 != 0, k beyond shared memory and the pallas pin run; mixed
    # dtypes still raise
    from autorag_research_tpu_torch.ops import maxsim as tm

    args = _mv_tensors(_mv_data(np.random.default_rng(12), 2, 4, 300, 6, 12, empty=(3,)),
                       cuda_device, torch.float32)
    for k in (5, 257):
        torch.testing.assert_close(tm.maxsim_topk_v2(*args, k), tm.maxsim_topk_v2_plain(*args, k),
                                   rtol=0, atol=0)
    torch.testing.assert_close(tm.maxsim_scores_v2(*args), tm.maxsim_scores_v2_plain(*args),
                               rtol=0, atol=0)
    q, ql, docs, dl = args
    with pytest.raises(ValueError):
        tm.maxsim_scores_v2(q, ql, docs.to(torch.bfloat16), dl)
    before = tm.LAUNCHES["maxsim_topk_v1"]
    torch.testing.assert_close(tm.maxsim_topk(*args, 5, method="pallas"),
                               tm.maxsim_topk_v1_plain(*args, 5), rtol=0, atol=0)
    assert tm.LAUNCHES["maxsim_topk_v1"] == before + 1


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


# ------------------------------------------- MaxSim pins (#11, #12), any k and d
# MV_SHAPES, and d = 128 (v3's bias lane alone in the last k-box: d' = 136)
# with a query of length 0 (the one row the pins keep for it) and Td = 37
# (a tail chunk past Td in every document)
PIN_CASES = {
    "long-docs": (MV_SHAPES[0], ()), "blocks": (MV_SHAPES[1], ()),
    "long-query": (MV_SHAPES[2], ()), "d128-empty-query": ((7, 20, 500, 37, 128), (2, 5)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 17, 300])
@pytest.mark.parametrize("shape", list(PIN_CASES))
@pytest.mark.parametrize("pin", ["v1", "v3"])
def test_maxsim_pin_kernels_match_plain(cuda_device, pin, dtype, k, shape):
    # dyadic tokens: every sum exact, so kernel and plain version agree
    # bitwise, empty documents at NEG_INF with their rows
    from autorag_research_tpu_torch.ops import maxsim as tm

    dims, zero_q = PIN_CASES[shape]
    args = _mv_tensors(_mv_data(np.random.default_rng(k), *dims, empty=(0, 11), zero_q=zero_q),
                       cuda_device, dtype)
    kernel = {"v1": tm.maxsim_topk_v1, "v3": tm.maxsim_topk_v3}[pin]
    plain = {"v1": tm.maxsim_topk_v1_plain, "v3": tm.maxsim_topk_v3_plain}[pin]
    before = tm.LAUNCHES[f"maxsim_topk_{pin}"]
    s, i = kernel(*args, k)
    torch.cuda.synchronize()
    assert tm.LAUNCHES[f"maxsim_topk_{pin}"] == before + 1
    rs, ri = plain(*args, k)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)
    # the same ranking as the v2 kernel
    vs, vi = tm.maxsim_topk_v2(*args, k)
    torch.testing.assert_close(i, vi, rtol=0, atol=0)
    torch.testing.assert_close(s, vs, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxsim_pins_launch_their_kernels_only(cuda_device, dtype):
    # method="pallas" / "pallas_v3" on the card's tensors, query lengths on
    # the host as MultiVectorIndex passes them: one launch of each pin's
    # kernel, none of another, no plain version and no scan
    from autorag_research_tpu_torch.ops import maxsim as tm

    q, ql, docs, dl = _mv_tensors(
        _mv_data(np.random.default_rng(13), 9, 12, 700, 30, 128, empty=(4,), zero_q=(1,)),
        cuda_device, dtype)
    tm.reset_launch_counts()
    s1, i1 = tm.maxsim_topk(q, ql.cpu(), docs, dl, 10, method="pallas")
    s3, i3 = tm.maxsim_topk(q, ql.cpu(), docs, dl, 10, method="pallas_v3")
    torch.cuda.synchronize()
    assert tm.LAUNCHES == {
        "maxsim_topk_v2": 0, "maxsim_scores_v2": 0, "maxsim_topk_v1": 1, "maxsim_topk_v3": 1,
    }
    assert sum(tm.PLAIN_CALLS.values()) == 0
    torch.testing.assert_close(i1, i3, rtol=0, atol=0)
    torch.testing.assert_close(s1, s3, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["maxsim_topk_v1", "maxsim_topk_v2", "maxsim_topk_v3"])
def test_maxsim_fused_kernels_any_k_and_d(cuda_device, name, dtype):
    # k = 1,000 (lists in the output) and d = 12 (padded to 16) in one call
    from autorag_research_tpu_torch.ops import maxsim as tm

    args = _mv_tensors(_mv_data(np.random.default_rng(1000), 19, 9, 1300, 21, 12, empty=(2, 700)),
                       cuda_device, dtype)
    s, i = getattr(tm, name)(*args, 1000)
    rs, ri = getattr(tm, f"{name}_plain")(*args, 1000)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxsim_pin_kernels_random_floats(cuda_device, dtype):
    # random floats: an id may differ only between scores within the f32
    # rounding term of the proof (the v2 kernel's test)
    from autorag_research_tpu_torch.ops import maxsim as tm

    rng = np.random.default_rng(46)
    q, ql, docs, dl = _mv_data(rng, 40, 32, 3000, 64, 100, empty=(7,), dyadic=False)
    q /= np.maximum(np.linalg.norm(q, axis=2, keepdims=True), 1e-9)
    docs /= np.maximum(np.linalg.norm(docs, axis=2, keepdims=True), 1e-9)
    args = _mv_tensors((q, ql, docs, dl), cuda_device, dtype)
    tol = (100 + 32) * 2.0**-23 * 32
    for pin in ("v1", "v3"):
        s, i = getattr(tm, f"maxsim_topk_{pin}")(*args, 10)
        rs, ri = getattr(tm, f"maxsim_topk_{pin}_plain")(*args, 10)
        torch.testing.assert_close(s, rs, rtol=1e-5, atol=1e-5)
        mism = i != ri
        assert bool(((s - rs).abs()[mism] <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_kernels_any_k_and_d(cuda_device, dtype):
    # the streaming kernel at k = 1,000 and d = 12, the seg-stats kernel at d = 12
    rng = np.random.default_rng(13)
    c = torch.from_numpy(_eighths(rng, (6000, 12))).to(cuda_device, dtype)
    c[300:340] = c[5]
    q = torch.from_numpy(_eighths(rng, (90, 12))).to(cuda_device, dtype)
    for k in (257, 1000):
        s, i = td.dense_topk_stream(q, c, k)
        rs, ri = td.dense_topk_plain(q, c, k)
        torch.testing.assert_close(i, ri, rtol=0, atol=0)
        torch.testing.assert_close(s, rs, rtol=0, atol=0)
    if dtype == torch.bfloat16:
        got = td.seg_stats_bf16(q, c, 5990)
        ref = td._seg_stats_plain((q, None), c, None, 5990, 128)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.cuda
def test_int8_products_on_card(cuda_device):
    # torch._int_mm's shape rules (M > 16, K and N multiples of 8; N of 16,
    # where cuBLASLt has no int8 algorithm for N = 11,784) met by zero
    # padding; the s32 products exact, equal to the CPU's
    rng = np.random.default_rng(14)
    for m, kd, n in ((3, 12, 5), (40, 768, 1001), (17, 8, 8), (960, 16, 11784)):
        a = torch.from_numpy(rng.integers(-127, 128, size=(m, kd)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, size=(n, kd)).astype(np.int8))
        got = td.int8_matmul(a.to(cuda_device), b.to(cuda_device)).cpu()
        torch.testing.assert_close(got, a.int() @ b.int().T, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["approx", "int8"])
@pytest.mark.parametrize("d", [64, 12])
def test_dense_index_serving_modes_cuda_match_cpu(cuda_device, mode, d):
    rng = np.random.default_rng(47)
    emb = rng.normal(size=(3000, d)).astype(np.float32)
    qs = rng.normal(size=(50, d)).astype(np.float32)
    ids = list(range(3000))
    cpu = DenseIndex(ids, emb, mode=mode, device="cpu").topk_rows(qs, 10)
    gpu_idx = DenseIndex(ids, emb, mode=mode, device=cuda_device)
    # queries normalized on the card (another rounding than numpy's)
    dev_q = gpu_idx.topk_rows(torch.from_numpy(qs).to(cuda_device), 10)
    np.testing.assert_allclose(dev_q[0], cpu[0], rtol=1e-6, atol=1e-6)
    mism = dev_q[1] != cpu[1]
    assert (np.abs(dev_q[0] - cpu[0])[mism] <= 1e-6).all()
    gpu = gpu_idx.topk_rows(qs, 10)  # normalized by numpy, as on the CPU
    np.testing.assert_allclose(gpu[0], cpu[0], rtol=1e-6, atol=1e-6)
    if mode == "int8":  # s32 products are exact: bitwise
        np.testing.assert_array_equal(gpu[1], cpu[1])
        np.testing.assert_array_equal(gpu[0], cpu[0])
        # rows stored up to a multiple of 16 (3008), masked by the search
        assert gpu_idx.device_bytes() == 3008 * (-(-d // 8) * 8) + 3008 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [{"search_method": "pallas"}, {"search_method": "pallas_v3"},
                                  {"mode": "int8"}, {"mode": "int8", "bucketize": 3}],
                         ids=["v1-pin", "v3-pin", "int8", "int8-bucketed"])
@pytest.mark.parametrize("d", [64, 12])
def test_multi_vector_index_pins_and_int8_cuda_match_cpu(cuda_device, opts, d):
    from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex
    from autorag_research_tpu_torch.ops import maxsim as tm

    rng = np.random.default_rng(48)
    mats = [rng.normal(size=(int(rng.integers(0, 40)), d)).astype(np.float32) for _ in range(1500)]
    queries = [rng.normal(size=(int(rng.integers(3, 33)), d)).astype(np.float32) for _ in range(30)]
    ids = list(range(1500))
    cpu = MultiVectorIndex(ids, mats, device="cpu", **opts).search(queries, 10)
    tm.reset_launch_counts()
    gpu = MultiVectorIndex(ids, mats, device=cuda_device, **opts).search(queries, 10)
    assert sum(tm.PLAIN_CALLS.values()) == 0
    pin = opts.get("search_method")
    if pin:
        assert tm.LAUNCHES["maxsim_topk_v1" if pin == "pallas" else "maxsim_topk_v3"] == 1
    for g, c in zip(gpu, cpu):
        gs, cs = np.array([h.score for h in g]), np.array([h.score for h in c])
        np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-5)
        mism = np.array([h.doc_id for h in g]) != np.array([h.doc_id for h in c])
        assert (np.abs(gs - cs)[mism] <= 1e-5).all()


# -------------------------------------------------------------------- BM25
def _bm25_data(rng, b, t, n, slots, vocab=3000, clustered=False, pad_frac=0.25):
    """Slot arrays of unique-term rows with scattered pads, as an index build
    gives them (no repeated id in a row), and queries of distinct terms. With
    ``clustered`` doc n draws from a window of 200 ids around n * vocab / n
    and each query from one window, so the tile predicate prunes. Query 0 is
    all pads, query 1 holds one unknown term only."""
    doc_ids = np.full((n, slots), -1, np.int32)
    for r in range(n):
        if clustered:
            lo = min(max(0, r * vocab // n - 100), vocab - 200)
            doc_ids[r] = lo + rng.choice(200, size=slots, replace=False)
        else:
            doc_ids[r] = rng.choice(vocab, size=slots, replace=False)
    doc_w = rng.random((n, slots)).astype(np.float32)
    pad = rng.random((n, slots)) < pad_frac
    doc_ids[pad] = -1
    doc_w[pad] = 0.0
    q_ids = np.full((b, t), -2, np.int32)
    q_w = np.zeros((b, t), np.float32)
    for i in range(2, b):
        m = int(rng.integers(1, t + 1))
        lo = int(rng.integers(0, vocab - 200)) if clustered else 0
        q_ids[i, :m] = lo + rng.choice(200 if clustered else vocab, size=m, replace=False)
        q_w[i, :m] = rng.uniform(0.2, 3.0, size=m).astype(np.float32)
    if b > 1:
        q_ids[1, 0], q_w[1, 0] = vocab + 7, 1.0
    return q_ids, q_w, doc_ids, doc_w


def _bm25_tensors(arrays, device):
    return tuple(torch.from_numpy(x).to(device) for x in arrays)


# B < 8 and several query tiles; N not a multiple of the 32-document step;
# L % 4 != 0 (scalar staging); L > 128 (two staged slot chunks); T > 16
BM25_SHAPES = [(5, 6, 3001, 24), (20, 9, 1000, 13), (11, 21, 700, 140)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 100, 256, 1500])
@pytest.mark.parametrize("shape", BM25_SHAPES, ids=["tiles", "scalar-rows", "long-rows"])
def test_bm25_v2_kernel_matches_plain(cuda_device, k, shape):
    # k = 1500 keeps the lists in global memory where k_eff > 1024
    from autorag_research_tpu_torch.ops import sparse as ts

    args = _bm25_tensors(_bm25_data(np.random.default_rng(k), *shape), cuda_device)
    before = ts.LAUNCHES["bm25_topk_v2"]
    s, i = ts.bm25_topk_v2(*args, k)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["bm25_topk_v2"] == before + 1
    rs, ri = ts.bm25_topk_v2_plain(*args, k)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("positive_only", [False, True])
@pytest.mark.parametrize("k", [1, 10, 100, 256, 1500])
@pytest.mark.parametrize("block_n", [128, 2048])
def test_bm25_skip_kernel_matches_plain(cuda_device, positive_only, k, block_n):
    from autorag_research_tpu_torch.ops import sparse as ts

    arrays = _bm25_data(np.random.default_rng(k + block_n), 13, 6, 6000, 20, clustered=True)
    args = _bm25_tensors(arrays, cuda_device)
    bitmaps = torch.from_numpy(ts.build_tile_bitmaps(arrays[2], block_n)).to(cuda_device)
    match = ts.tile_match(args[0], bitmaps)
    if block_n == 128:
        assert not bool(match.all())  # some (query tile, doc tile) pairs skip
    before = ts.LAUNCHES["bm25_topk_v2_skip"]
    s, i = ts.bm25_topk_v2_skip(*args, bitmaps, k, block_n=block_n, positive_only=positive_only)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["bm25_topk_v2_skip"] == before + 1
    rs, ri = ts.bm25_topk_v2_skip_plain(
        *args, bitmaps, k, block_n=block_n, positive_only=positive_only
    )
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)
    if not positive_only:  # bit-identical to the v2 kernel
        vs, vi = ts.bm25_topk_v2(*args, k)
        torch.testing.assert_close(i, vi, rtol=0, atol=0)
        torch.testing.assert_close(s, vs, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("positive_only", [False, True])
def test_bm25_skip_kernel_all_tiles_skipped(cuda_device, positive_only):
    # empty queries (all pads): every pair of tiles is cleared
    from autorag_research_tpu_torch.ops import sparse as ts

    q_ids, q_w, doc_ids, doc_w = _bm25_data(np.random.default_rng(3), 3, 4, 2000, 16)
    q_ids[:], q_w[:] = -2, 0.0
    args = _bm25_tensors((q_ids, q_w, doc_ids, doc_w), cuda_device)
    bitmaps = torch.from_numpy(ts.build_tile_bitmaps(doc_ids, 128)).to(cuda_device)
    assert not bool(ts.tile_match(args[0], bitmaps).any())
    s, i = ts.bm25_topk_v2_skip(*args, bitmaps, 10, block_n=128, positive_only=positive_only)
    rs, ri = ts.bm25_topk_v2_skip_plain(*args, bitmaps, 10, block_n=128, positive_only=positive_only)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)
    if positive_only:
        assert bool((s == 0).all()) and bool((i == ts.INT_MAX).all())
    else:  # zero-score documents in row order
        assert i[0].tolist() == list(range(10))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 100, 256, 1500])
@pytest.mark.parametrize("block_n", [128, 2048])
def test_bm25_probe_kernel_matches_plain(cuda_device, k, block_n):
    from autorag_research_tpu_torch.ops import sparse as ts

    arrays = _bm25_data(np.random.default_rng(k + 7 * block_n), 13, 6, 6000, 20, clustered=True)
    args = _bm25_tensors(arrays, cuda_device)
    n_tiles = -(-6000 // block_n)
    indptr, tiles = ts.build_term_tile_lists(arrays[2], block_n)
    cand, count, _ = ts.probe_candidates(arrays[0], indptr, tiles, 8, n_tiles)
    count[0] = max(0, count[0] - 1)  # a truncated list: its last tile is not scored
    cand[1, : count[1]] = cand[1, : count[1]][::-1].copy()  # the wrapper sorts live entries
    cand_t, count_t = torch.from_numpy(cand).to(cuda_device), torch.from_numpy(count).to(cuda_device)
    before = ts.LAUNCHES["bm25_topk_probe"]
    s, i = ts.bm25_topk_probe(*args, cand_t, count_t, k, block_n)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["bm25_topk_probe"] == before + 1
    rs, ri = ts.bm25_topk_probe_plain(*args, cand_t, count_t, k, block_n)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)
    # every tile listed: the skip kernel's positive_only result
    full = torch.arange(n_tiles, dtype=torch.int32, device=cuda_device).repeat(2, 1)
    every = torch.full((2,), n_tiles, dtype=torch.int32, device=cuda_device)
    bitmaps = torch.from_numpy(ts.build_tile_bitmaps(arrays[2], block_n)).to(cuda_device)
    ps, pi = ts.bm25_topk_probe(*args, full, every, k, block_n)
    vs, vi = ts.bm25_topk_v2_skip(*args, bitmaps, k, block_n=block_n, positive_only=True)
    torch.testing.assert_close(pi, vi, rtol=0, atol=0)
    torch.testing.assert_close(ps, vs, rtol=0, atol=0)


@pytest.mark.cuda
def test_bm25_probe_kernel_empty_lists(cuda_device):
    from autorag_research_tpu_torch.ops import sparse as ts

    args = _bm25_tensors(_bm25_data(np.random.default_rng(5), 11, 4, 3000, 16), cuda_device)
    cand = torch.zeros((2, 4), dtype=torch.int32, device=cuda_device)
    count = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    s, i = ts.bm25_topk_probe(*args, cand, count, 10, 128)
    assert bool((s == 0).all()) and bool((i == ts.INT_MAX).all())
    rs, ri = ts.bm25_topk_probe_plain(*args, cand, count, 10, 128)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)


@pytest.mark.cuda
def test_bm25_topk_auto_takes_the_v2_kernel_at_any_k(cuda_device):
    from autorag_research_tpu_torch.ops import sparse as ts

    arrays = _bm25_data(np.random.default_rng(4), 10, 5, 3000, 16)
    args = _bm25_tensors(arrays, cuda_device)
    ts.reset_launch_counts()
    s256, i256 = ts.bm25_topk(*args, 256)
    s1500, i1500 = ts.bm25_topk(*args, 1500)
    assert ts.LAUNCHES["bm25_topk_v2"] == 2 and sum(ts.LAUNCHES.values()) == 2
    assert sum(ts.PLAIN_CALLS.values()) == 0  # the card's tensors never take a plain route
    torch.testing.assert_close(i1500[:, :256], i256, rtol=0, atol=0)
    torch.testing.assert_close(s1500[:, :256], s256, rtol=0, atol=0)
    # the v1 pin launches its own kernel, with v2's results
    v1_s, v1_i = ts.bm25_topk(*args, 256, method="pallas")
    assert ts.LAUNCHES["bm25_topk_v1"] == 1 and sum(ts.PLAIN_CALLS.values()) == 0
    torch.testing.assert_close(v1_i, i256, rtol=0, atol=0)
    torch.testing.assert_close(v1_s, s256, rtol=0, atol=0)
    with pytest.raises(ValueError):
        ts.bm25_topk(*args, 10, method="pallas_probe")


@pytest.mark.cuda
@pytest.mark.parametrize("tile_skip", [True, False])
@pytest.mark.parametrize("k", [10, 300])
def test_sparse_index_cuda_matches_cpu(cuda_device, tile_skip, k):
    from autorag_research_tpu_torch.index.sparse import SparseIndex

    rng = np.random.default_rng(46)
    vocab = [f"w{i}" for i in range(800)]
    texts = [" ".join(rng.choice(vocab, size=int(rng.integers(3, 60)))) for _ in range(2500)]
    queries = [" ".join(rng.choice(vocab, size=int(rng.integers(1, 9)))) for _ in range(37)]
    ids = list(range(2500))
    cpu = SparseIndex(ids, texts, tile_skip=tile_skip, device="cpu").search(queries, k)
    gpu = SparseIndex(ids, texts, tile_skip=tile_skip, device=cuda_device).search(queries, k)
    assert [[(h.doc_id, h.score) for h in r] for r in gpu] == [[(h.doc_id, h.score) for h in r] for r in cpu]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["selective", "common"])
def test_sparse_index_pruned_legs_on_card(cuda_device, kind):
    # ten regions of local words plus a common band; a batch of two regions'
    # words is selective (probe), common words take the tile-WAND flow
    from autorag_research_tpu_torch.index.sparse import SparseIndex
    from autorag_research_tpu_torch.ops import sparse as ts

    rng = np.random.default_rng(47)
    n = 6000
    texts = []
    for i in range(n):
        local = [f"r{i * 10 // n}x{j}" for j in rng.choice(300, size=int(rng.integers(3, 20)), replace=False)]
        # 50 filler words no query holds: rows wider than 64 slots keep the
        # flat layout, whose legs this test holds (the packed ones below)
        filler = [f"f{j}" for j in rng.choice(5000, size=50, replace=False)]
        texts.append(" ".join(local + [f"c{j}" for j in rng.choice(30, size=3)] + filler))
    if kind == "selective":
        queries = [" ".join(f"r{b % 2}x{j}" for j in rng.choice(300, size=3)) for b in range(21)]
    else:
        queries = [" ".join(f"c{j}" for j in rng.choice(30, size=4)) + " r5x1" for _ in range(21)]
    ids = list(range(n))
    cpu = SparseIndex(ids, texts, device="cpu").search(queries, 10)
    gpu_idx = SparseIndex(ids, texts, device=cuda_device, probe_block_n=128)
    ts.reset_launch_counts()
    gpu = gpu_idx.search(queries, 10)
    assert gpu_idx._device_pack == 1
    assert sum(ts.PLAIN_CALLS.values()) == 0 and ts.LAUNCHES["bm25_topk_v2"] == 0
    if kind == "selective":
        assert ts.LAUNCHES["bm25_topk_probe"] == 1 and ts.LAUNCHES["bm25_topk_v2_skip"] == 0
    else:
        assert ts.LAUNCHES["bm25_topk_probe"] + ts.LAUNCHES["bm25_topk_v2_skip"] >= 1
    assert [[(h.doc_id, h.score) for h in r] for r in gpu] == [[(h.doc_id, h.score) for h in r] for r in cpu]


# ------------------------------------------------- BM25 packed layout, v1
PACK_WIDTHS = [1, 3, 16, 19, 24, 33, 64]
BM25_K = [1, 10, 100, 1000, 1500]


def _packed_case(seed, width, n=3001, b=5, t=21, clustered=False):
    """Short-document slot arrays of ``width`` slots (scattered pads, unique
    terms; N % 32 != 0, B < 8 and T > 16 by default), packed by pack_slots:
    (flat args, packed args, pack) on the card."""
    from autorag_research_tpu_torch.ops import sparse as ts

    arrays = _bm25_data(np.random.default_rng(seed), b, t, n, width, clustered=clustered)
    pids, pw, pack = ts.pack_slots(arrays[2], arrays[3], width)
    dev = torch.device("cuda")
    flat = _bm25_tensors(arrays, dev)
    packed = flat[:2] + _bm25_tensors((pids, pw), dev)
    return flat, packed, pack


@pytest.mark.cuda
@pytest.mark.parametrize("k", BM25_K)
@pytest.mark.parametrize("width", PACK_WIDTHS)
def test_bm25_packed_kernel_matches_plain_and_v2_on_flat(cuda_device, width, k):
    from autorag_research_tpu_torch.ops import sparse as ts

    flat, packed, pack = _packed_case(width * 31 + k, width, b=5 if width % 2 else 13,
                                      t=21 if width % 2 else 6)
    before = ts.LAUNCHES["bm25_topk_packed"]
    s, i = ts.bm25_topk_packed(*packed, 3001, k, pack)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["bm25_topk_packed"] == before + 1
    rs, ri = ts.bm25_topk_packed_plain(*packed, 3001, k, pack)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)
    vs, vi = ts.bm25_topk_v2(*flat, k)  # the v2 kernel over the flat layout
    torch.testing.assert_close(i, vi, rtol=0, atol=0)
    torch.testing.assert_close(s, vs, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("width", PACK_WIDTHS)
def test_bm25_packed_kernel_unaligned_rows(cuda_device, width):
    # packed rows that start off a 16-byte boundary take the scalar staging
    from autorag_research_tpu_torch.ops import sparse as ts

    flat, packed, pack = _packed_case(width + 5, width)
    views = []
    for t in packed[2:]:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        views.append(buf[1:].view(t.shape))
        views[-1].copy_(t)
    assert views[0].data_ptr() % 16 == 4
    s, i = ts.bm25_topk_packed(*packed[:2], *views, 3001, 10, pack)
    rs, ri = ts.bm25_topk_packed(*packed, 3001, 10, pack)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("lists", ["exact", "unsorted", "truncated", "empty"])
@pytest.mark.parametrize("k,block_rows", [(1, 16), (10, 16), (100, 128), (1000, 1536), (1500, 1536)])
def test_bm25_probe_packed_kernel_matches_plain(cuda_device, lists, k, block_rows):
    from autorag_research_tpu_torch.ops import sparse as ts

    n, width = 20_000, 16
    flat, packed, pack = _packed_case(k + block_rows, width, n=n, b=13, t=6, clustered=True)
    tile = block_rows * pack
    n_tiles = -(-n // tile)
    indptr, tiles = ts.build_term_tile_lists(flat[2].cpu().numpy(), tile)
    cand, count, _ = ts.probe_candidates(flat[0].cpu().numpy(), indptr, tiles, 8, n_tiles)
    if lists == "unsorted":
        cand[1, : count[1]] = cand[1, : count[1]][::-1].copy()  # the wrapper sorts live entries
    elif lists == "truncated":
        count[0] = max(0, count[0] - 1)
    elif lists == "empty":
        count[:] = 0
    cand_t, count_t = torch.from_numpy(cand).to(cuda_device), torch.from_numpy(count).to(cuda_device)
    before = ts.LAUNCHES["bm25_topk_probe_packed"]
    s, i = ts.bm25_topk_probe_packed(*packed, n, pack, cand_t, count_t, k, block_rows)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["bm25_topk_probe_packed"] == before + 1
    rs, ri = ts.bm25_topk_probe_packed_plain(*packed, n, pack, cand_t, count_t, k, block_rows)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)
    # the flat probe kernel over tiles of block_rows * pack documents
    fs, fi = ts.bm25_topk_probe(*flat, cand_t, count_t, k, tile)
    torch.testing.assert_close(i, fi, rtol=0, atol=0)
    torch.testing.assert_close(s, fs, rtol=0, atol=0)
    if lists == "empty":
        assert bool((s == 0).all()) and bool((i == ts.INT_MAX).all())
    with pytest.raises(ValueError, match="block_n"):
        ts.bm25_topk_probe_packed(*packed, n, pack, cand_t, count_t, block_rows + 1, block_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 100, 256, 1500])
@pytest.mark.parametrize("shape", BM25_SHAPES, ids=["tiles", "scalar-rows", "long-rows"])
def test_bm25_v1_kernel_matches_plain_and_v2(cuda_device, k, shape):
    from autorag_research_tpu_torch.ops import sparse as ts

    args = _bm25_tensors(_bm25_data(np.random.default_rng(k + 3), *shape), cuda_device)
    before = ts.LAUNCHES["bm25_topk_v1"]
    s, i = ts.bm25_topk_v1(*args, k)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["bm25_topk_v1"] == before + 1
    rs, ri = ts.bm25_topk_v1_plain(*args, k)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)
    vs, vi = ts.bm25_topk_v2(*args, k)
    torch.testing.assert_close(i, vi, rtol=0, atol=0)
    torch.testing.assert_close(s, vs, rtol=0, atol=0)


def _short_texts(rng, n):
    """Short documents (at most 22 unique words: the index packs them) of ten
    regions' words plus a common band, and two query batches."""
    texts = []
    for i in range(n):
        local = [f"r{i * 10 // n}x{j}" for j in rng.choice(300, size=int(rng.integers(3, 20)), replace=False)]
        texts.append(" ".join(local + [f"c{j}" for j in rng.choice(30, size=3)]))
    selective = [" ".join(f"r{b % 2}x{j}" for j in rng.choice(300, size=3)) for b in range(21)]
    common = [" ".join(f"c{j}" for j in rng.choice(30, size=4)) + " r5x1" for _ in range(21)]
    return texts, {"selective": selective, "common": common}


@pytest.mark.cuda
@pytest.mark.parametrize("tile_skip", [True, False])
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("kind", ["selective", "common"])
def test_sparse_index_packed_legs_on_card(cuda_device, kind, k, tile_skip):
    # the packed probe for a selective batch, packed tile-WAND (or its
    # fallback, the packed kernel) for common words, the packed kernel without
    # tile_skip or beyond a candidate tile: the CPU route's hits (its plain
    # packed version)
    from autorag_research_tpu_torch.index.sparse import SparseIndex
    from autorag_research_tpu_torch.ops import sparse as ts

    texts, batches = _short_texts(np.random.default_rng(48), 6000)
    ids = list(range(6000))
    cpu = SparseIndex(ids, texts, device="cpu", probe_block_n=256).search(batches[kind], k)
    gpu_idx = SparseIndex(ids, texts, device=cuda_device, probe_block_n=256, tile_skip=tile_skip)
    ts.reset_launch_counts()
    gpu = gpu_idx.search(batches[kind], k)
    assert gpu_idx._device_pack == 5 and ts.packed_block_rows(256, 5) == 48
    assert sum(ts.PLAIN_CALLS.values()) == 0
    assert sum(ts.LAUNCHES[n] for n in ("bm25_topk_v2", "bm25_topk_v2_skip", "bm25_topk_probe")) == 0
    if not tile_skip or k > 48:
        assert ts.LAUNCHES["bm25_topk_packed"] == 1 and ts.LAUNCHES["bm25_topk_probe_packed"] == 0
    elif kind == "selective":
        assert ts.LAUNCHES["bm25_topk_probe_packed"] == 1 and ts.LAUNCHES["bm25_topk_packed"] == 0
    else:
        assert ts.LAUNCHES["bm25_topk_probe_packed"] + ts.LAUNCHES["bm25_topk_packed"] >= 1
    expected = [[(h.doc_id, h.score) for h in r] for r in cpu]
    assert [[(h.doc_id, h.score) for h in r] for r in gpu] == expected
    # the kernel pins run on a flat upload, with the same hits
    for pin, name in (("xla", None), ("pallas_v2", "bm25_topk_v2"), ("pallas", "bm25_topk_v1")):
        ts.reset_launch_counts()
        pinned = gpu_idx.search(batches[kind], k, method=pin)
        assert [[(h.doc_id, h.score) for h in r] for r in pinned] == expected
        if name:
            assert ts.LAUNCHES[name] == 1 and sum(ts.PLAIN_CALLS.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 300])
def test_sparse_index_bucketed_cuda_matches_cpu(cuda_device, k):
    from autorag_research_tpu_torch.index.sparse import SparseIndex
    from autorag_research_tpu_torch.ops import sparse as ts

    rng = np.random.default_rng(49)
    texts = []
    for _ in range(5000):
        if rng.random() < 0.9:
            texts.append(" ".join(f"s{j}" for j in rng.choice(800, size=int(rng.integers(8, 15)))))
        else:
            texts.append(" ".join(f"l{j}" for j in rng.choice(5000, size=int(rng.integers(100, 128)),
                                                               replace=False)))
    queries = [" ".join(f"s{j}" for j in rng.choice(800, size=3)) + f" l{int(rng.integers(5000))}"
               for _ in range(37)]
    ids = list(range(5000))
    cpu = SparseIndex(ids, texts, bucketize=2, device="cpu").search(queries, k)
    flat = SparseIndex(ids, texts, device="cpu").search(queries, k)
    gpu_idx = SparseIndex(ids, texts, bucketize=2, device=cuda_device)
    ts.reset_launch_counts()
    gpu = gpu_idx.search(queries, k)
    assert [b["pack"] > 1 for b in gpu_idx._device_buckets] == [True, False]
    assert ts.LAUNCHES["bm25_topk_packed"] == 1 and ts.LAUNCHES["bm25_topk_v2"] == 1
    assert sum(ts.PLAIN_CALLS.values()) == 0
    pairs = [[(h.doc_id, h.score) for h in r] for r in gpu]
    assert pairs == [[(h.doc_id, h.score) for h in r] for r in cpu]
    # a pruned pin falls back to auto on the bucketed layout
    ts.reset_launch_counts()
    pinned = gpu_idx.search(queries, k, method="pallas_wand")
    assert ts.LAUNCHES["bm25_topk_packed"] == 1 and ts.LAUNCHES["bm25_topk_v2"] == 1
    assert [[(h.doc_id, h.score) for h in r] for r in pinned] == pairs
    assert pairs == [[(h.doc_id, h.score) for h in r] for r in flat]


# ------------------------------------------- BM25 hash body (#3 and #4)
HIGH_ID = 2**31 - 2  # the largest term id a query pad (-2) leaves free


def _hash_data(rng, b, t, n, slots, high=False):
    """Dyadic slot arrays (weights k/8: every sum exact) for the hash body:
    rows of unique terms with scattered pads, row 5 repeating one term in its
    first min(3, L) slots (the build sums them in slot order), row 7 all pads;
    queries of t terms drawn from the documents' terms with repeats and pads
    mid-row, query 0 all pads, query 1 one unknown term. ``high``: ids end at
    2**31 - 2."""
    vocab = max(3000, 3 * slots)
    base = HIGH_ID + 1 - vocab if high else 0
    doc_ids = np.stack([rng.choice(vocab, size=slots, replace=False) for _ in range(n)]).astype(np.int64)
    doc_w = (rng.integers(1, 17, size=(n, slots)) / 8.0).astype(np.float32)
    pad = rng.random((n, slots)) < 0.25
    doc_ids[pad] = -1 - base
    doc_w[pad] = 0.0
    doc_ids[5, : min(3, slots)] = 17
    doc_w[5, : min(3, slots)] = (np.arange(1, min(3, slots) + 1) / 8.0).astype(np.float32)
    doc_ids[7], doc_w[7] = -1 - base, 0.0
    doc_ids = (doc_ids + base).astype(np.int32)
    live = doc_ids[doc_ids >= 0]
    q_ids = np.full((b, t), -2, np.int32)
    q_w = np.zeros((b, t), np.float32)
    for i in range(2, b):
        m = int(rng.integers(1, t + 1))
        pos = np.sort(rng.choice(t, size=m, replace=False))  # pads mid-row
        q_ids[i, pos] = rng.choice(live, size=m) if len(live) else base + 1
        if m > 1:
            q_ids[i, pos[-1]] = q_ids[i, pos[0]]  # a repeated term
        q_w[i, pos] = rng.integers(1, 3, size=m)
    if b > 2 and slots >= 1:
        q_ids[2, 0], q_w[2, 0] = doc_ids[5, 0], 1.0  # the repeated doc term
    if b > 1 and t > 0:  # an id no document holds
        q_ids[1, :], q_w[1, :] = -2, 0.0
        q_ids[1, t // 2], q_w[1, t // 2] = base - 5 if high else vocab + 7, 2.0
    return q_ids, q_w, doc_ids, doc_w


def _hash_check(args, ks):
    from autorag_research_tpu_torch.ops import sparse as ts

    for k in ks:
        before = dict(ts.LAUNCHES)
        got2 = ts.bm25_topk_v2(*args, k)
        got1 = ts.bm25_topk_v1(*args, k)
        torch.cuda.synchronize()
        assert ts.LAUNCHES["bm25_topk_v2"] == before["bm25_topk_v2"] + 1
        assert ts.LAUNCHES["bm25_topk_v1"] == before["bm25_topk_v1"] + 1
        ref = ts.bm25_topk_v2_plain(*args, k)
        for got in (got2, got1):  # #3 and #4 bitwise the plain version, so each other
            torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)
            torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t, high", [(1, False), (16, False), (33, True)], ids=["T1", "T16", "T33-high-ids"])
@pytest.mark.parametrize("slots", [1, 3, 20, 104, 128, 1500])
def test_bm25_hash_body_v2_and_v1_match_plain(cuda_device, slots, t, high):
    # B = 133: two query tiles, the second under-full; N = 3001 (701 at
    # L = 1,500, one document per tile) is no multiple of a tile or a part
    from autorag_research_tpu_torch.ops import sparse as ts

    n = 701 if slots >= 1500 else 3001
    args = _bm25_tensors(_hash_data(np.random.default_rng(slots + t), 133, t, n, slots, high),
                         cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = ts.bm25_hash_plan(133, t, n, slots, 10, sms)
    assert plan.staged and 133 % plan.qb and n % plan.docs + n % plan.part
    _hash_check(args, (1, 10, 257, 1000))


@pytest.mark.cuda
def test_bm25_hash_body_unstaged_wide_rows(cuda_device):
    # rows too wide to stage (L = 9,000): D = 1, the table in global scratch
    from autorag_research_tpu_torch.ops import sparse as ts

    args = _bm25_tensors(_hash_data(np.random.default_rng(11), 20, 16, 300, 9000), cuda_device)
    assert not ts.bm25_hash_plan(20, 16, 300, 9000, 10, 132).staged
    _hash_check(args, (1, 10, 257))


@pytest.mark.cuda
def test_bm25_hash_body_unaligned_rows(cuda_device):
    # L % 4 == 0 on arrays that start 4 bytes past a 16-byte boundary: 4-byte
    # copies
    q_ids, q_w, doc_ids, doc_w = _bm25_tensors(
        _hash_data(np.random.default_rng(12), 40, 16, 2001, 20), cuda_device)
    views = []
    for x in (doc_ids, doc_w):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
        v = buf[1:].view(x.shape)
        v.copy_(x)
        assert v.is_contiguous() and v.data_ptr() % 16 == 4
        views.append(v)
    _hash_check((q_ids, q_w, *views), (10, 300))


# ------------------------------- BM25 skip and packed walks on the hash body
SKIP_K = [1, 10, 65, 257, 1000]


def _skip_stats(device):
    return torch.zeros(2, dtype=torch.int64, device=device)


def _skip_check(args, bitmaps, k, block_n, positive_only, stats=None):
    """#5 on the hash body, bitwise its plain version (and, in v2 mode, the
    v2 kernel), its launch counted; returns the group masks it read."""
    from autorag_research_tpu_torch.ops import sparse as ts

    before = ts.LAUNCHES["bm25_topk_v2_skip"]
    if stats is None:
        s, i = ts.bm25_topk_v2_skip(*args, bitmaps, k, block_n=block_n, positive_only=positive_only)
    else:
        s, i = ts._hash_topk("bm25_topk_v2_skip", *args, k, block_n=block_n,
                             positive_only=positive_only, stats=stats,
                             group_masks=lambda qb: ts.tile_group_masks(args[0], bitmaps, qb))
    torch.cuda.synchronize()
    assert ts.LAUNCHES["bm25_topk_v2_skip"] == before + 1
    rs, ri = ts.bm25_topk_v2_skip_plain(*args, bitmaps, k, block_n=block_n,
                                        positive_only=positive_only)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)
    if not positive_only:
        vs, vi = ts.bm25_topk_v2(*args, k)
        torch.testing.assert_close(i, vi, rtol=0, atol=0)
        torch.testing.assert_close(s, vs, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("positive_only", [True, False])
@pytest.mark.parametrize("k", SKIP_K)
def test_bm25_skip_hash_body_groups_skip_apart(cuda_device, positive_only, k):
    # B = 133: two query tiles of QB = 128, the second of 5 queries (B is no
    # multiple of 8 or of QB); clustered rows, so within one (query tile,
    # skip tile) pair some 8-query groups skip and others do not
    from autorag_research_tpu_torch.ops import sparse as ts

    arrays = _bm25_data(np.random.default_rng(k + 11), 133, 6, 6000, 20, clustered=True)
    args = _bm25_tensors(arrays, cuda_device)
    bitmaps = torch.from_numpy(ts.build_tile_bitmaps(arrays[2], 128)).to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = ts.bm25_hash_plan(133, 6, 6000, 20, k, sms, block_n=128)
    assert plan.qb == 128 and plan.q_tiles == 2 and 128 % plan.docs == 0
    masks = ts.tile_group_masks(args[0], bitmaps, plan.qb)
    first = masks[0]
    assert bool(((first != 0) & (first != 0xFFFF)).any())  # some groups skip, others not
    stats = _skip_stats(cuda_device)
    _skip_check(args, bitmaps, k, 128, positive_only, stats)
    pairs, docs = stats.tolist()  # (query, document) pairs that probed nothing, docs never staged
    assert 0 < pairs < 133 * 6000
    if positive_only:  # a skip tile that no group of a query tile needs is never staged
        sizes = torch.full((masks.shape[1],), 128, device=cuda_device)
        sizes[-1] = 6000 - 128 * (masks.shape[1] - 1)
        assert docs == int(((masks == 0) * sizes).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10])
def test_bm25_skip_hash_body_v2_warms_partway(cuda_device, k):
    # every query holds term 7, which only the first 64 documents of each
    # part hold: each list reaches a k-th score > 0 on a part's first skip
    # tile, then the v2 walk skips the tiles no group needs (the next one is
    # already prefetched)
    from autorag_research_tpu_torch.ops import sparse as ts

    rng = np.random.default_rng(21 + k)
    n, slots, b = 200_000, 12, 40
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = ts.bm25_hash_plan(b, 4, n, slots, k, sms, block_n=128)
    assert plan.part >= 4 * 128
    doc_ids = rng.integers(1000, 51_000, size=(n, slots)).astype(np.int32)  # repeats summed
    doc_w = (rng.integers(1, 17, size=(n, slots)) / 8.0).astype(np.float32)
    first = np.arange(n) % plan.part < 64
    doc_ids[first, 0] = 7
    q_ids = np.full((b, 4), -2, np.int32)
    q_w = np.zeros((b, 4), np.float32)
    q_ids[:, 0], q_w[:, 0] = 7, 1.0
    q_ids[:, 2], q_w[:, 2] = 999, 2.0  # a term no document holds
    args = _bm25_tensors((q_ids, q_w, doc_ids, doc_w), cuda_device)
    bitmaps = torch.from_numpy(ts.build_tile_bitmaps(doc_ids, 128)).to(cuda_device)
    stats = _skip_stats(cuda_device)
    _skip_check(args, bitmaps, k, 128, False, stats)
    pairs, docs = stats.tolist()
    # each part stages the skip tiles of its first 64 documents and the tile
    # after (prefetched while its lists warmed), a few Bloom false positives aside
    assert docs > plan.q_tiles * (n - plan.parts * (3 * 128 + plan.docs))
    assert pairs >= docs * b // plan.q_tiles


@pytest.mark.cuda
@pytest.mark.parametrize("positive_only", [True, False])
def test_bm25_skip_hash_body_every_tile_skipped(cuda_device, positive_only):
    # empty queries: no group matches anywhere; positive_only stages nothing
    from autorag_research_tpu_torch.ops import sparse as ts

    q_ids, q_w, doc_ids, doc_w = _bm25_data(np.random.default_rng(4), 21, 4, 5000, 16)
    q_ids[:], q_w[:] = -2, 0.0
    args = _bm25_tensors((q_ids, q_w, doc_ids, doc_w), cuda_device)
    bitmaps = torch.from_numpy(ts.build_tile_bitmaps(doc_ids, 128)).to(cuda_device)
    for k in (10, 257):
        stats = _skip_stats(cuda_device)
        _skip_check(args, bitmaps, k, 128, positive_only, stats)
        # every (query, document) pair probed nothing; positive_only staged no document
        assert stats.tolist() == [21 * 5000, 5000 if positive_only else 0]


@pytest.mark.cuda
@pytest.mark.parametrize("positive_only", [True, False])
def test_bm25_skip_hash_body_unstaged_wide_rows(cuda_device, positive_only):
    # L = 9,000: D = 1, the table in global scratch; queries 8-15 (a whole
    # group) hold only terms no document has, so their group skips
    from autorag_research_tpu_torch.ops import sparse as ts

    q_ids, q_w, doc_ids, doc_w = _hash_data(np.random.default_rng(13), 20, 16, 300, 9000)
    q_ids[8:16], q_w[8:16] = -2, 0.0
    q_ids[8:16, 3], q_w[8:16, 3] = 1_000_000_007, 1.0
    args = _bm25_tensors((q_ids, q_w, doc_ids, doc_w), cuda_device)
    assert not ts.bm25_hash_plan(20, 16, 300, 9000, 10, 132, block_n=128).staged
    bitmaps = torch.from_numpy(ts.build_tile_bitmaps(doc_ids, 128)).to(cuda_device)
    for k in (1, 10, 257):
        stats = _skip_stats(cuda_device)
        _skip_check(args, bitmaps, k, 128, positive_only, stats)
        # group 1 probes nothing (a Bloom false positive in one skip tile aside)
        assert stats[0].item() >= 8 * (300 - 128)


# pack_slots widths of the packs 2, 3, 5, 6, 7, 8, 42, 64, 128 (3,001 documents:
# no multiple of any)
HASH_PACK_WIDTHS = [64, 42, 25, 21, 18, 16, 3, 2, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("k", SKIP_K)
@pytest.mark.parametrize("width", HASH_PACK_WIDTHS)
def test_bm25_packed_hash_body_matches_plain_and_v2_on_flat(cuda_device, width, k):
    from autorag_research_tpu_torch.ops import sparse as ts

    flat, packed, pack = _packed_case(width * 7 + k, width, b=133, t=13)
    assert pack == 128 // width and 3001 % pack
    before = ts.LAUNCHES["bm25_topk_packed"]
    s, i = ts.bm25_topk_packed(*packed, 3001, k, pack)
    torch.cuda.synchronize()
    assert ts.LAUNCHES["bm25_topk_packed"] == before + 1
    rs, ri = ts.bm25_topk_packed_plain(*packed, 3001, k, pack)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)
    vs, vi = ts.bm25_topk_v2(*flat, k)  # #3 over the flat layout of the same slots
    torch.testing.assert_close(i, vi, rtol=0, atol=0)
    torch.testing.assert_close(s, vs, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("width", HASH_PACK_WIDTHS)
def test_bm25_packed_hash_body_unaligned_rows(cuda_device, width):
    # packed rows 4 bytes past a 16-byte boundary: 4-byte copies
    from autorag_research_tpu_torch.ops import sparse as ts

    flat, packed, pack = _packed_case(width + 50, width, b=133, t=13)
    views = []
    for t in packed[2:]:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        views.append(buf[1:].view(t.shape))
        views[-1].copy_(t)
    assert views[0].data_ptr() % 16 == 4
    for k in (10, 257):
        s, i = ts.bm25_topk_packed(*packed[:2], *views, 3001, k, pack)
        rs, ri = ts.bm25_topk_packed_plain(*packed, 3001, k, pack)
        torch.testing.assert_close(i, ri, rtol=0, atol=0)
        torch.testing.assert_close(s, rs, rtol=0, atol=0)


# ---- the probes (#6 flat, #8 packed) on the hash body's skip walk
PROBE_LISTS = ["exact", "truncated", "messy"]


def _probe_queries(rng, b, t, n, slots, clustered=True):
    """``_bm25_data``'s arrays for B queries; B < 3 keeps real queries (its
    first two rows are an empty query and an unknown term)."""
    q_ids, q_w, doc_ids, doc_w = _bm25_data(rng, max(b, 3), t, n, slots, clustered=clustered)
    return q_ids[-b:].copy(), q_w[-b:].copy(), doc_ids, doc_w


def _probe_lists(rng, q_ids, doc_ids, tile, kind):
    """(cand, count) per 8-query tile over doc tiles of ``tile`` documents:
    the exact lists (``probe_candidates``); a random subset of each, in
    order, as a tile-WAND pass lists (documents of the dropped tiles stay
    out though they score); or the exact lists unsorted, with repeats, -1,
    entries past the corpus's tiles, and counts of 0 and past the length."""
    from autorag_research_tpu_torch.ops import sparse as ts

    n_tiles = -(-doc_ids.shape[0] // tile)
    indptr, tiles = ts.build_term_tile_lists(doc_ids, tile)
    cand, count, _ = ts.probe_candidates(q_ids, indptr, tiles, 8, n_tiles)
    if kind == "truncated":
        for r in range(len(count)):
            keep = cand[r, : count[r]][rng.random(count[r]) < 0.5]
            cand[r, : len(keep)], count[r] = keep, len(keep)
    elif kind == "messy":
        rows, cap = len(count), 2 * n_tiles + 8
        messy = np.full((rows, cap), -1, np.int32)
        for r in range(rows):
            live = cand[r, : count[r]]
            extra = np.array([-1, n_tiles, n_tiles + 5], np.int32)
            row = np.concatenate([live, live[: len(live) // 2], extra])
            messy[r, : len(row)] = rng.permutation(row)[:cap]
        count = np.full(rows, cap + 3, np.int32)  # every entry counts, past the length too
        count[0] = 0  # an empty list
        cand = messy
    return cand, count


def _probe_check(name, got, ref, before):
    from autorag_research_tpu_torch.ops import sparse as ts

    torch.cuda.synchronize()
    assert ts.LAUNCHES[name] == before + 1
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("block_n", [128, 1000])
@pytest.mark.parametrize("b", [1, 33, 1024])
@pytest.mark.parametrize("k", [10, 100, 257, 1000])
@pytest.mark.parametrize("lists", PROBE_LISTS)
def test_bm25_probe_hash_body_matches_plain(cuda_device, lists, k, b, block_n):
    # #6 on the skip walk: bitwise its plain version, one launch counted, no
    # plain call; block_n = 1,000 is no power of two (D = 8 divides it)
    from autorag_research_tpu_torch.ops import sparse as ts

    rng = np.random.default_rng(k + b + block_n)
    arrays = _probe_queries(rng, b, 6, 6000, 20)
    cand, count = _probe_lists(rng, arrays[0], arrays[2], block_n, lists)
    args = _bm25_tensors(arrays, cuda_device)
    cand_t, count_t = torch.from_numpy(cand).to(cuda_device), torch.from_numpy(count).to(cuda_device)
    before, plain_before = ts.LAUNCHES["bm25_topk_probe"], sum(ts.PLAIN_CALLS.values())
    got = ts.bm25_topk_probe(*args, cand_t, count_t, k, block_n)
    assert sum(ts.PLAIN_CALLS.values()) == plain_before
    _probe_check("bm25_topk_probe", got, ts.bm25_topk_probe_plain(*args, cand_t, count_t, k, block_n),
                 before)
    if lists == "messy":
        assert bool((got[0][:8] == 0).all()) and bool((got[1][:8] == ts.INT_MAX).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 33, 1024])
@pytest.mark.parametrize("k", [10, 100, 257, 1000])
@pytest.mark.parametrize("width", [21, 16], ids=["pack6", "pack8"])
@pytest.mark.parametrize("lists", PROBE_LISTS)
def test_bm25_probe_packed_hash_body_matches_plain(cuda_device, lists, width, k, b):
    # #8 on the skip walk: pack 6 on the packed rows, pack 8 on their flat
    # view; tiles of an odd number of rows, just past k; bitwise its plain
    # version and the flat probe over the same documents
    from autorag_research_tpu_torch.ops import sparse as ts

    rng = np.random.default_rng(k + b + width)
    n = 20_000
    q_ids, q_w, doc_ids, doc_w = _probe_queries(rng, b, 6, n, width)
    pids, pw, pack = ts.pack_slots(doc_ids, doc_w, width)
    assert pack == 128 // width
    block_rows = max(37, k + 1) | 1
    cand, count = _probe_lists(rng, q_ids, doc_ids, block_rows * pack, lists)
    flat = _bm25_tensors((q_ids, q_w, doc_ids, doc_w), cuda_device)
    packed = flat[:2] + _bm25_tensors((pids, pw), cuda_device)
    cand_t, count_t = torch.from_numpy(cand).to(cuda_device), torch.from_numpy(count).to(cuda_device)
    before, plain_before = ts.LAUNCHES["bm25_topk_probe_packed"], sum(ts.PLAIN_CALLS.values())
    got = ts.bm25_topk_probe_packed(*packed, n, pack, cand_t, count_t, k, block_rows)
    assert sum(ts.PLAIN_CALLS.values()) == plain_before
    _probe_check("bm25_topk_probe_packed", got,
                 ts.bm25_topk_probe_packed_plain(*packed, n, pack, cand_t, count_t, k, block_rows),
                 before)
    fs, fi = ts.bm25_topk_probe(*flat, cand_t, count_t, k, block_rows * pack)
    torch.testing.assert_close(got[1], fi, rtol=0, atol=0)
    torch.testing.assert_close(got[0], fs, rtol=0, atol=0)
    with pytest.raises(ValueError, match="block_n"):
        ts.bm25_topk_probe_packed(*packed, n, pack, cand_t, count_t, block_rows + 1, block_rows)


@pytest.mark.cuda
def test_bm25_probe_hash_body_counters_and_query_tiles(cuda_device):
    # the skip walk's counters on a probe: every listed (group, skip tile)
    # pair probes, the rest not; a skip tile no group of a query tile lists
    # is never staged; every query tile size gives the same lists
    from autorag_research_tpu_torch.ops import sparse as ts

    rng = np.random.default_rng(61)
    b, n, block_n = 133, 6000, 128
    arrays = _probe_queries(rng, b, 6, n, 20)
    cand, count = _probe_lists(rng, arrays[0], arrays[2], block_n, "exact")
    args = _bm25_tensors(arrays, cuda_device)
    cand_t, count_t = torch.from_numpy(cand).to(cuda_device), torch.from_numpy(count).to(cuda_device)
    ref = ts.bm25_topk_probe_plain(*args, cand_t, count_t, 10, block_n)
    n_tiles = -(-n // block_n)
    sizes = torch.full((n_tiles,), block_n, device=cuda_device)
    sizes[-1] = n - block_n * (n_tiles - 1)
    for qb in (8, 64, 128, 256):
        stats = torch.zeros(2, dtype=torch.int64, device=cuda_device)
        got = ts._hash_topk("bm25_topk_probe", *args, 10, qb, block_n=block_n, stats=stats,
                            group_masks=lambda q: ts.probe_group_masks(cand_t, count_t, b, q, n_tiles))
        torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        plan = ts.bm25_tile_plan(b, 6, n, 20, 10, sms, qb, block_n)
        masks = ts.probe_group_masks(cand_t, count_t, b, plan.qb, n_tiles)
        listed = ts._candidate_mask(cand_t.long(), count_t.long(), b, n_tiles)
        pairs, docs = stats.tolist()
        assert pairs == b * n - int((listed * sizes).sum())
        assert docs == int(((masks == 0) * sizes).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("width", [21, 16], ids=["pack6", "pack8"])
def test_sparse_index_packed_probe_route_on_card(cuda_device, width):
    # a packed SparseIndex of pack 6 / 8 takes the packed probe for a
    # selective batch: the CPU route's hits; its flat counterpart at the
    # same tile takes the flat probe with the same hits
    from autorag_research_tpu_torch.index.sparse import SparseIndex
    from autorag_research_tpu_torch.ops import sparse as ts

    rng = np.random.default_rng(62 + width)
    n, local_max = 6000, width - 3
    texts = []
    for i in range(n):
        local = rng.choice(300, size=int(rng.integers(3, local_max + 1)), replace=False)
        texts.append(" ".join([f"r{i * 10 // n}x{j}" for j in local]
                              + [f"c{j}" for j in rng.choice(30, size=3, replace=False)]))
    queries = [" ".join(f"r{q % 2}x{j}" for j in rng.choice(300, size=3)) for q in range(21)]
    ids = list(range(n))
    expected = [[(h.doc_id, h.score) for h in r]
                for r in SparseIndex(ids, texts, device="cpu", probe_block_n=256).search(queries, 10)]
    gpu = SparseIndex(ids, texts, device=cuda_device, probe_block_n=256)
    ts.reset_launch_counts()
    hits = gpu.search(queries, 10)
    assert gpu._device_pack == 128 // width
    assert ts.LAUNCHES["bm25_topk_probe_packed"] == 1 and sum(ts.LAUNCHES.values()) == 1
    assert sum(ts.PLAIN_CALLS.values()) == 0
    assert [[(h.doc_id, h.score) for h in r] for r in hits] == expected
    # the flat probe through the pruned legs of a flat index (rows of more
    # than 64 slots stay flat: 50 filler words no query holds)
    wide = [t + " " + " ".join(f"f{j}" for j in rng.choice(5000, size=50, replace=False)) for t in texts]
    flat_cpu = SparseIndex(ids, wide, device="cpu").search(queries, 10)
    flat = SparseIndex(ids, wide, device=cuda_device, probe_block_n=128)
    ts.reset_launch_counts()
    flat_hits = flat.search(queries, 10)
    assert flat._device_pack == 1 and ts.LAUNCHES["bm25_topk_probe"] == 1
    assert sum(ts.PLAIN_CALLS.values()) == 0
    assert [[(h.doc_id, h.score) for h in r] for r in flat_hits] == \
        [[(h.doc_id, h.score) for h in r] for r in flat_cpu]


# ---- the streaming kernel's redesign: tails, ties at every boundary, rounds
STREAM_TAIL_Q = (1, 127, 129, 300)
STREAM_TAIL_N = (1, 127, 129, 7000)


def _tie_case(rng, q, n, d, k, dtype):
    """Eighths with exact ties planted across buffer, tile, part and block
    boundaries: corpus rows around every multiple of 128 and every part
    boundary copy row 0, and query rows 126-130 copy query 0."""
    c_np = _eighths(rng, (n, d))
    q_np = _eighths(rng, (q, d))
    d8 = -(-d // 8) * 8  # the width the wrapper pads to
    part_rows = td._stream_plan_on_card(q, n, d8, k, dtype, torch.device("cuda")).part_rows
    for edge in sorted(set(range(128, n, 128 * 7)) | set(range(part_rows, n, part_rows))):
        c_np[max(edge - 3, 0) : edge + 3] = c_np[0]
    c_np[: min(n, 40)] = c_np[0]  # more than 32 equal candidates in the cold first tile
    q_np[126:131] = q_np[0]
    return (torch.from_numpy(q_np).to("cuda", dtype), torch.from_numpy(c_np).to("cuda", dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 12, 768])
@pytest.mark.parametrize("k", [1, 10, 33, 128, 257, 1000, 7001])
def test_stream_kernel_tails_and_ties_match_plain(cuda_device, dtype, d, k):
    # bitwise the plain version on dyadic data at Q and N tails, any k (k > N
    # too), lists in shared memory (k <= 128) and in the output (257, 1,000)
    rng = np.random.default_rng(d * 10_000 + k)
    for q in STREAM_TAIL_Q:
        for n in STREAM_TAIL_N:
            if d == 768 and q * n > 300 * 129 and k > 33:
                continue  # the large width at small k only: the long lists run at d = 8, 12
            qt, ct = _tie_case(rng, q, n, d, k, dtype)
            before = td.LAUNCHES["dense_topk_stream"]
            s, i = td.dense_topk_stream(qt, ct, k)
            torch.cuda.synchronize()
            assert td.LAUNCHES["dense_topk_stream"] == before + 1
            rs, ri = td.dense_topk_plain(qt, ct, k)
            torch.testing.assert_close(i, ri, rtol=0, atol=0, msg=f"q={q} n={n}")
            torch.testing.assert_close(s, rs, rtol=0, atol=0, msg=f"q={q} n={n}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [33, 100, 128, 300])
def test_stream_kernel_cold_tile_rounds_keep_id_order(cuda_device, dtype, k):
    # every row of the first tile scores the same for every query: 128
    # winners a row from one tile, taken in rounds of 32, ordered by id
    rng = np.random.default_rng(k)
    c_np = _eighths(rng, (3000, 16))
    c_np[:128] = 1.0
    c_np[128:] *= 0.0625  # below the planted rows for a positive query
    q_np = np.abs(_eighths(rng, (140, 16))) + 0.125
    q = torch.from_numpy(q_np).to(cuda_device, dtype)
    c = torch.from_numpy(c_np).to(cuda_device, dtype)
    s, i = td.dense_topk_stream(q, c, k)
    rs, ri = td.dense_topk_plain(q, c, k)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)
    assert (i[:, : min(k, 128)].cpu() == torch.arange(min(k, 128), dtype=torch.int32)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_kernel_one_part(cuda_device, dtype):
    # a corpus of two tiles at k = 33 is one part (fewer than 4 k rows a part)
    rng = np.random.default_rng(9)
    q = torch.from_numpy(_eighths(rng, (200, 24))).to(cuda_device, dtype)
    c = torch.from_numpy(_eighths(rng, (250, 24))).to(cuda_device, dtype)
    assert td._stream_plan_on_card(200, 250, 24, 33, dtype, cuda_device).parts == 1
    s, i = td.dense_topk_stream(q, c, 33)
    rs, ri = td.dense_topk_plain(q, c, 33)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)


@pytest.mark.cuda
def test_stream_launcher_checks_the_plan(cuda_device):
    # the launcher's layout count equals the plan's; a plan that disagrees,
    # or parts that do not cover N, is refused
    import ctypes

    lib = td.cuda_build.load("dense_topk_stream")
    count = lib.dense_topk_stream_smem_bytes
    count.argtypes = [ctypes.c_int] * 3
    count.restype = ctypes.c_int
    for dtype in (torch.float32, torch.bfloat16):
        for k in (1, 10, 95, 96, 100, 131, 132, 257, 1000):
            lists, smem = td.dense_stream_layout(k, dtype)
            assert count(int(dtype == torch.bfloat16), k, int(lists == "shared")) == smem
            assert smem <= td.SMEM_BLOCK_MAX
    q = torch.zeros((10, 16), device=cuda_device)
    c = torch.zeros((1000, 16), device=cuda_device)
    out_s = torch.empty((10, 8, 10), device=cuda_device)
    out_i = torch.empty((10, 8, 10), dtype=torch.int32, device=cuda_device)
    fn = lib.dense_topk_stream_f32_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = td.dense_stream_layout(10, torch.float32)[1]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), c.data_ptr(), out_s.data_ptr(), out_i.data_ptr())
    assert fn(*ptrs, 10, 1000, 16, 10, 128, 8, 1, smem, stream) == 0
    assert fn(*ptrs, 10, 1000, 16, 10, 128, 8, 1, smem + 16, stream) != 0  # bytes differ
    assert fn(*ptrs, 10, 1000, 16, 10, 128, 8, 0, smem, stream) != 0  # lists elsewhere
    assert fn(*ptrs, 10, 1000, 16, 10, 128, 7, 1, smem, stream) != 0  # N not covered
    assert fn(*ptrs, 10, 1000, 16, 10, 100, 8, 1, smem, stream) != 0  # rows not of 128
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [-1, 2**31 - 1], ids=["pad-1", "pad-intmax"])
def test_device_fusers_on_the_card_match_their_cpu_results(cuda_device, pad):
    # the hybrid fusers are plain PyTorch (no kernel): on the card they give
    # their CPU results' ids, scores within 1e-6 (f32 sums in another order)
    from autorag_research_tpu_torch.ops.fusion import fuse_batch_cc, fuse_batch_rrf

    rng = np.random.default_rng(11)
    b, f = 64, 20
    ids = [np.full((b, f), pad, np.int32) for _ in range(2)]
    scores = [np.full((b, f), -3.4e38, np.float32) for _ in range(2)]
    for r in range(b):
        for leg, (lo, hi) in enumerate(((-0.5, 1.0), (0.0, 30.0))):
            n = int(rng.integers(0, f + 1))
            ids[leg][r, :n] = rng.choice(60, size=n, replace=False)
            scores[leg][r, :n] = np.sort(rng.uniform(lo, hi, n))[::-1]

    def both(fn, *args, **kw):
        cpu = fn(*[torch.from_numpy(a) for a in args], **kw)
        card = fn(*[torch.from_numpy(a).to(cuda_device) for a in args], **kw)
        assert card[0].device.type == "cuda"
        torch.testing.assert_close(card[1].cpu(), cpu[1], rtol=0, atol=0)
        torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-6, atol=1e-6)

    for top_k in (10, 2 * f + 5):
        both(fuse_batch_rrf, ids[0], ids[1], k=60, top_k=top_k, fetch_k=f)
        for method, mins in (("mm", (None, None)), ("tmm", (-1.0, 0.0)), ("z", (None, None)),
                             ("dbsf", (None, None))):
            both(fuse_batch_cc, ids[0], scores[0], ids[1], scores[1], weight=0.5, top_k=top_k,
                 normalize_method=method, pipeline_1_min=mins[0], pipeline_2_min=mins[1])
