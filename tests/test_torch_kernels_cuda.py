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
