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



# ---- the skip walk (#5) and the packed layout (#7) on the hash body
def _check_skip(plan, b, t, n, slots, k, sms, block_n, qb_max=ts.HASH_QB):
    _check(plan, b, t, n, slots, k, sms, qb_max)
    assert block_n % plan.docs == 0  # a staged tile lies in one skip tile


@pytest.mark.parametrize("block_n", [128, 2048])
@pytest.mark.parametrize("k", [1, 10, 257, 1000])
def test_skip_plan_invariants(block_n, k):
    for slots in (1, 3, 20, 104, 128, 1500, 9000):
        for b in BATCHES:
            for t in (1, 16, 33):
                for sms in SMS:
                    for n in (1, 2049, 3001, 500_000):
                        plan = ts.bm25_hash_plan(b, t, n, slots, k, sms, block_n=block_n)
                        _check_skip(plan, b, t, n, slots, k, sms, block_n)


def test_skip_plan_takes_the_tile_that_divides_block_n():
    # D is a power of two dividing block_n: odd block_n stages one document
    assert ts.bm25_hash_plan(40, 6, 10_000, 20, 10, 132, block_n=100).docs == 4
    assert ts.bm25_hash_plan(40, 6, 10_000, 20, 10, 132, block_n=1001).docs == 1
    for block_n in (100, 1001, 4096):
        plan = ts.bm25_hash_plan(40, 6, 10_000, 20, 10, 132, block_n=block_n)
        _check_skip(plan, 40, 6, 10_000, 20, 10, 132, block_n)


def test_skip_main_path_plan_is_the_whole_walks():
    # the flat main path's skip walk takes #3's plan: its query tile, table,
    # D and parts (a part may start inside a 2,048-document skip tile)
    full = ts.bm25_hash_plan(1024, 16, 500_000, 104, 10, 132)
    skip = ts.bm25_hash_plan(1024, 16, 500_000, 104, 10, 132, block_n=2048)
    assert skip == full and (full.qb, full.docs, full.parts) == (128, 8, 33)
    for qb_max in (64, 256):
        plan = ts.bm25_hash_plan(1024, 16, 500_000, 104, 10, 132, qb_max, block_n=2048)
        assert plan.qb == qb_max
        _check_skip(plan, 1024, 16, 500_000, 104, 10, 132, 2048, qb_max)


def _rows_touched(docs: int, pack: int) -> int:
    """The most packed rows a tile of ``docs`` documents, starting at a
    multiple of ``docs``, lies in (by brute force over one period)."""
    return max((base + docs - 1) // pack - base // pack + 1
               for base in range(0, docs * pack + 1, docs))


@pytest.mark.parametrize("pack", range(2, 129))
def test_staged_packed_rows_cover_every_tile(pack):
    for docs in (1, 2, 4, 8, 16, 32):
        assert ts._stage_words(docs, 128 // pack, pack) == 128 * _rows_touched(docs, pack)
    assert ts._stage_words(8, 21, 1) == 8 * 21  # flat: D rows of L slots


@pytest.mark.parametrize("pack", range(2, 65))
def test_packed_plan_invariants(pack):
    # the wrapper reads a power-of-two pack's rows as the flat array (pack 1)
    slots = 128 // pack
    kernel_pack = 1 if pack & (pack - 1) == 0 else pack
    for b in (1, 133, 1024):
        for t in (1, 13, 33):
            for k in (1, 10, 1000):
                for n in (1, 3001, 522_931):
                    plan = ts.bm25_hash_plan(b, t, n, slots, k, 132, pack=kernel_pack)
                    assert plan.staged  # a packed row's documents always fit
                    assert plan.smem == ts._hash_smem(plan.docs, plan.table, slots, t, plan.qb, k,
                                                      plan.list_smem, True, kernel_pack)
                    _check_packed(plan, b, t, n, slots, k)


def _check_packed(plan, b, t, n, slots, k):
    assert plan.smem <= ts.SMEM_BLOCK_MAX
    assert plan.qb % 8 == 0 and plan.q_tiles * plan.qb >= b > (plan.q_tiles - 1) * plan.qb
    assert plan.part % plan.docs == 0
    assert plan.parts * plan.part >= n > (plan.parts - 1) * plan.part
    assert plan.blocks_per_sm * (plan.smem + ts.SMEM_BLOCK_RESERVED) <= ts.SMEM_SM


def test_short_doc_main_path_packed_plan():
    # pack 6 (L = 21) at the Quora-size main path: #3's plan over a flat
    # upload of 20 slots, but whole staged rows
    packed = ts.bm25_hash_plan(1024, 13, 522_931, 21, 10, 132, pack=6)
    flat = ts.bm25_hash_plan(1024, 13, 522_931, 20, 10, 132)
    assert packed.staged and packed.qb == flat.qb == 128 and packed.table == flat.table
    assert packed.blocks_per_sm == 2 and packed.docs == flat.docs
    rows = _rows_touched(packed.docs, 6)
    assert packed.smem - ts._hash_smem(packed.docs, packed.table, 21, 13, 128, 10, packed.list_smem,
                                       True) == 4 * ts._r16(rows * 128 * 4) + 128 - 4 * ts._r16(
                                           packed.docs * 21 * 4)
