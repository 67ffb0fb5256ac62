"""The tile plan of the BM25 hash body (``ops/sparse.py::bm25_hash_plan``).

``csrc/bm25_hash.cuh`` runs only on the card; its plan is host code, a pure
function of (B, T, N, L, k, SM count), so its invariants are checked here:
shared memory within a block's 227 KB, a table of at least 2 L entries, parts
that cover N exactly, lists in shared memory only within their budget. The
kernel's launcher refuses a plan whose shared memory differs from its own
layout's, so the CUDA tests in ``test_torch_kernels_cuda.py`` hold the two
byte counts equal on the card.
"""

import pytest

from autorag_research_tpu_torch.ops import sparse as ts

BATCHES = (1, 5, 8, 33, 200, 1024)
TERMS = (0, 1, 16, 33, 2048)
SMS = (132, 114, 1)


def _is_pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def _check(plan, b, t, n, slots, k, sms, qb_max=ts.HASH_QB):
    assert plan.smem <= ts.SMEM_BLOCK_MAX
    assert plan.smem == ts._hash_smem(plan.docs, plan.table, slots, t, plan.qb, k, plan.list_smem,
                                      plan.staged)
    assert _is_pow2(plan.table) and plan.table >= max(8, 2 * slots)
    # the next power of two, no larger; the cap gives way to 2 L only
    assert plan.table == 8 or plan.table < 2 * ts.HASH_TABLE_FACTOR * slots
    assert plan.table <= max(ts.HASH_TABLE_CAP, 8, 4 * slots - 1)
    assert _is_pow2(plan.docs) and plan.docs <= 32
    assert plan.qb % 8 == 0 and 8 <= plan.qb <= qb_max
    assert plan.q_tiles * plan.qb >= b > (plan.q_tiles - 1) * plan.qb
    assert plan.part % plan.docs == 0
    assert plan.parts * plan.part >= n > (plan.parts - 1) * plan.part
    if plan.list_smem:
        assert plan.qb * k * 8 <= ts.HASH_LIST_SMEM_MAX
    assert plan.blocks_per_sm * (plan.smem + ts.SMEM_BLOCK_RESERVED) <= ts.SMEM_SM
    assert plan.q_tiles * plan.parts <= max(plan.blocks_per_sm * sms, plan.q_tiles)  # one wave
    if not plan.staged:  # only when one document's staged table fits no block
        assert plan.docs == 1 and not plan.list_smem and plan.qb == 8
        assert ts._hash_smem(1, plan.table, slots, t, 8, k, False, True) > ts.SMEM_BLOCK_MAX
        assert plan.q_tiles * plan.parts <= max(sms, plan.q_tiles)  # one block an SM


@pytest.mark.parametrize("k", [1, 10, 257, 1000])
@pytest.mark.parametrize("slots", [0, 1, 3, 20, 104, 128, 1500, 5000, 9000])
def test_plan_invariants(slots, k):
    for b in BATCHES:
        for t in TERMS:
            for sms in SMS:
                for n in (1, 31, 3001, 500_000):
                    _check(ts.bm25_hash_plan(b, t, n, slots, k, sms), b, t, n, slots, k, sms)


def test_main_path_plan_stages_the_corpus_once_per_128_queries():
    # the flat main path: 1,024 NQ-like queries x 16 terms vs 500,000 x 104
    plan = ts.bm25_hash_plan(1024, 16, 500_000, 104, 10, 132)
    assert (plan.qb, plan.table, plan.list_smem, plan.staged) == (128, 1024, True, True)
    assert plan.q_tiles == 8 and plan.blocks_per_sm == 2
    # lists past the budget move to the output; the tile plan stays
    long = ts.bm25_hash_plan(1024, 16, 500_000, 104, 1000, 132)
    assert not long.list_smem and long.qb == 128 and long.staged


def test_query_tile_shrinks_for_long_queries_and_wide_rows_go_unstaged():
    plan = ts.bm25_hash_plan(1024, 2048, 10_000, 104, 10, 132)
    assert plan.staged and plan.qb < ts.HASH_QB
    wide = ts.bm25_hash_plan(5, 33, 3001, 1500, 10, 132)  # one document per tile
    assert wide.staged and wide.docs == 1
    huge = ts.bm25_hash_plan(5, 33, 3001, 9000, 10, 132)  # table in global scratch
    assert not huge.staged and huge.q_tiles * huge.parts <= 132


@pytest.mark.parametrize("qb_max", [64, 256])
def test_query_tile_cap(qb_max):
    # the main path under another cap: the tile takes the cap, the plan stays valid
    for k in (10, 1000):
        plan = ts.bm25_hash_plan(1024, 16, 500_000, 104, k, 132, qb_max)
        assert plan.qb == qb_max and plan.staged
        _check(plan, 1024, 16, 500_000, 104, k, 132, qb_max)

