"""The tile plan of the streaming dense kernel (``ops/dense.py::dense_stream_plan``).

``csrc/dense_topk_stream.cu`` runs only on the card; its plan is host code, a
pure function of (Q, N, d, k, dtype, SMs, blocks per SM), so its invariants are
checked here: parts that cover N exactly with none empty, shared memory within
a block's 227 KB and equal to the layout's count, lists in shared memory only
within that budget, one wave (or the fewest waves there are), parts that never
grow with k. The kernel's launcher refuses a plan whose shared memory differs
from its own layout's, so the CUDA tests in ``test_torch_kernels_cuda.py`` hold
the two byte counts equal on the card.
"""

import pytest
import torch

from autorag_research_tpu_torch.ops import dense as td

QS = (1, 63, 128, 129, 1_100, 2_048, 10_000)
NS = (1, 127, 129, 500_000, 10_000_000)
DS = (8, 104, 768)
KS = (1, 10, 100, 256, 257, 1_000, 20_000_000)  # the last beyond every N
CARDS = ((132, 1), (132, 2), (114, 1), (1, 1), (8, 3))
DTYPES = (torch.float32, torch.bfloat16)


def _layout_bytes(k: int, dtype, shared: bool) -> int:
    """The kernel's shared-memory layout, counted apart from the plan: 1,024
    bytes of alignment slack, a ring of 3 slices (f32: TMA boxes of 128 rows
    x 32 floats of both operands; bf16: 128 rows of 32 k-columns at a stride
    of 40, both operands), 64 bytes of ring barriers, 4 words per query row
    (k-th score and id, counter, filled length), 32 (score, id) candidates per
    row, and the [128, k] lists when shared."""
    ring = 3 * (2 * 128 * 32 * 4 if dtype == torch.float32 else 2 * 128 * 40 * 2)
    return 1024 + ring + 64 + 128 * 4 * 4 + 128 * 32 * 8 + (128 * k * 8 if shared else 0)


def _check(plan, q, n, d, k, dtype, sms, bps):
    k_eff = min(k, n)
    assert (plan.bq, plan.bn, plan.stages) == (128, 128, 3)
    assert plan.bk == 32
    assert plan.k_slices == -(-d // plan.bk)
    assert plan.q_tiles == -(-q // 128)
    # parts cover N exactly, none empty, whole tiles of 128 rows
    assert plan.part_rows % 128 == 0
    assert (plan.parts - 1) * plan.part_rows < n <= plan.parts * plan.part_rows
    # shared memory: within a block's 227 KB and equal to the layout's count
    shared = plan.lists == "shared"
    assert plan.lists in ("shared", "global")
    assert plan.smem_bytes == _layout_bytes(k_eff, dtype, shared) <= td.SMEM_BLOCK_MAX
    # lists in shared memory exactly when they fit the budget
    assert shared == (_layout_bytes(k_eff, dtype, True) <= td.SMEM_BLOCK_MAX)
    # one wave of the resident slots, or the fewest waves there are
    assert plan.slots == sms * bps
    blocks = plan.q_tiles * plan.parts
    assert plan.waves == -(-blocks // plan.slots)
    assert plan.waves == max(1, -(-plan.q_tiles // plan.slots))
    if plan.parts > 1:
        assert blocks <= plan.slots
        assert plan.part_rows >= min(n, 4 * k_eff)  # at least 4 k rows a part


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_plan_invariants(n, d, dtype):
    for q in QS:
        for sms, bps in CARDS:
            for k in KS:
                plan = td.dense_stream_plan(q, n, d, k, dtype, sms, bps)
                _check(plan, q, n, d, k, dtype, sms, bps)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", NS)
def test_parts_never_grow_with_k(n, dtype):
    for q in QS:
        for sms, bps in CARDS:
            parts = [td.dense_stream_plan(q, n, 768, k, dtype, sms, bps).parts
                     for k in range(1, 3000, 7)]
            assert parts == sorted(parts, reverse=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_lists_leave_shared_memory_past_the_budget(dtype):
    # the largest k whose [128, k] lists fit beside the ring and the buffers
    top = max(k for k in range(1, 300) if _layout_bytes(k, dtype, True) <= td.SMEM_BLOCK_MAX)
    assert top == (95 if dtype == torch.float32 else 131)
    assert td.dense_stream_layout(top, dtype) == ("shared", _layout_bytes(top, dtype, True))
    assert td.dense_stream_layout(top + 1, dtype) == ("global", _layout_bytes(top, dtype, False))


def test_main_path_plan():
    # the dense exact main path: 2,048 queries x 500,000 x 768 f32, k = 10, on
    # an H100's 132 SMs at one block an SM: 16 query tiles x 8 parts of 62,592
    # rows = 128 blocks, one wave, lists in shared memory
    plan = td.dense_stream_plan(2048, 500_000, 768, 10, torch.float32, 132, 1)
    assert plan == td.StreamPlan(
        bq=128, bn=128, bk=32, stages=3, k_slices=24, q_tiles=16, part_rows=62_592, parts=8,
        lists="shared", smem_bytes=144_448, slots=132, waves=1,
    )
    # k = 1,000 (a TREC-style top-1,000): the same parts, lists in the output
    big = td.dense_stream_plan(2048, 500_000, 768, 1000, torch.float32, 132, 1)
    assert (big.parts, big.part_rows, big.lists, big.smem_bytes) == (8, 62_592, "global", 134_208)
    # bf16 at the main path's shapes, and at two blocks an SM: twice the parts
    bf16 = td.dense_stream_plan(2048, 500_000, 768, 10, torch.bfloat16, 132, 1)
    assert (bf16.parts, bf16.lists, bf16.smem_bytes) == (8, "shared", 107_584)
    assert td.dense_stream_plan(2048, 500_000, 768, 10, torch.float32, 132, 2).parts == 16


@pytest.mark.parametrize("bad", [dict(q=0), dict(n=0), dict(d=0), dict(d=12), dict(k=0),
                                 dict(sms=0), dict(blocks_per_sm=0)])
def test_plan_refuses_empty_shapes(bad):
    args = dict(q=4, n=100, d=16, k=5, dtype=torch.float32, sms=132, blocks_per_sm=1)
    args.update(bad)
    with pytest.raises(ValueError):
        td.dense_stream_plan(**args)
