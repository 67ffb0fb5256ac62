"""The tile plan of the BM25 hash body (``ops/sparse.py::bm25_hash_plan``).

``csrc/bm25_hash.cuh`` runs only on the card; its plan is host code, a pure
function of (B, T, N, L, k, SM count), so its invariants are checked here:
shared memory within a block's 227 KB, a table of at least 2 L entries, parts
that cover N exactly, lists in shared memory only within their budget. The
kernel's launcher refuses a plan whose shared memory differs from its own
layout's, so the CUDA tests in ``test_torch_kernels_cuda.py`` hold the two
byte counts equal on the card. The probes' masks (``probe_group_masks``,
built from candidate lists on the device) are decoded bit by bit against
``_candidate_mask``, the rows the plain versions score, on seeded and
hypothesis-drawn lists.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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


# ---- the probes (#6 flat, #8 packed) on the skip walk

def _check_probe_masks(cand, count, b, qb, n_tiles):
    """``probe_group_masks`` decoded bit by bit against ``_candidate_mask``:
    query q's row is the bits of its 8-query group q // 8; groups past
    ceil(B/8) hold none."""
    masks = ts.probe_group_masks(cand, count, b, qb, n_tiles)
    q_tiles = -(-b // qb)
    assert masks.shape == (q_tiles, n_tiles) and masks.dtype == torch.int32
    bits = (masks.to(torch.int64)[:, None, :] >> torch.arange(qb // 8)[None, :, None]) & 1
    groups = bits.reshape(q_tiles * qb // 8, n_tiles).bool()
    ref = ts._candidate_mask(cand.long(), count.long(), b, n_tiles)
    assert torch.equal(groups[torch.arange(b) // 8], ref)
    assert not groups[-(-b // 8):].any()


@pytest.mark.parametrize("qb", [8, 32, 128, 256])
@pytest.mark.parametrize("b", [1, 5, 8, 13, 129, 300, 1024])
def test_probe_group_masks_match_candidate_mask(b, qb):
    # unsorted lists with repeats, -1 and out-of-range entries, empty rows,
    # counts past the list length, and rows past ceil(B/8)
    rng = np.random.default_rng(b * 7 + qb)
    rows, cap, n_tiles = -(-b // 8) + b % 3, 12, 37
    cand = rng.integers(-1, n_tiles + 3, size=(rows, cap)).astype(np.int32)
    cand[:, 1] = cand[:, 0]  # a repeat in every row
    count = rng.integers(0, cap + 5, size=rows).astype(np.int32)
    count[0] = 0
    if rows > 2:
        count[2] = cap + 100
    _check_probe_masks(torch.from_numpy(cand), torch.from_numpy(count), b, qb, n_tiles)


def test_probe_group_masks_fill_every_bit_and_refuse_a_bad_query_tile():
    # 256 queries in one tile of 256, every group listing every tile: all
    # 32 bits set, bit 31 as the sign bit
    cand = torch.arange(5, dtype=torch.int32).repeat(32, 1)
    count = torch.full((32,), 5, dtype=torch.int32)
    masks = ts.probe_group_masks(cand, count, 256, 256, 5)
    assert masks.tolist() == [[-1] * 5]
    # B = 250: the last group (queries 248, 249) still sets its bit
    assert ts.probe_group_masks(cand, count, 250, 256, 5).tolist() == [[-1] * 5]
    for qb in (0, 12, 264):
        with pytest.raises(ValueError):
            ts.probe_group_masks(cand, count, 256, qb, 5)


@settings(max_examples=150, deadline=None, database=None)
@given(b=st.integers(1, 600), qb=st.sampled_from([8, 16, 32, 64, 128, 256]),
       n_tiles=st.integers(1, 70), cap=st.integers(0, 20), seed=st.integers(0, 2**32 - 1))
def test_probe_group_masks_drawn_lists(b, qb, n_tiles, cap, seed):
    rng = np.random.default_rng(seed)
    rows = -(-b // 8)
    cand = rng.integers(-3, n_tiles + 3, size=(rows, cap)).astype(np.int32)
    count = rng.integers(-1, cap + 3, size=rows).astype(np.int32)
    _check_probe_masks(torch.from_numpy(cand), torch.from_numpy(count), b, qb, n_tiles)


# (B, T, N, L, k, block_n in documents, pack): the probe shapes. Flat: the
# flat main path's lookups (1,024 x 2 live terms vs 500,000 x 104) at the
# index's probe_block_n 2,048, tile-WAND's 128 and an odd 999, and phase 9's
# clustered benchmark arrays; packed: the Quora-size main path's lookups
# (pack 6, packed_block_rows(2048, 6) = 336 rows = 2,016 documents) and the
# packed probe benchmark (pack 8 read as the flat [N, 16] view, 1,024 rows)
PROBE_SHAPES = [
    (1024, 2, 500_000, 104, 10, 2048, 1), (1024, 2, 500_000, 104, 1000, 2048, 1),
    (1024, 2, 500_000, 104, 10, 128, 1), (1024, 2, 500_000, 104, 10, 999, 1),
    (32, 16, 500_000, 128, 100, 2048, 1),
    (1024, 2, 522_931, 21, 10, 336 * 6, 6), (1024, 2, 522_931, 21, 1000, 336 * 6, 6),
    (32, 8, 500_000, 16, 10, 1024 * 8, 1), (33, 8, 3001, 16, 1000, 1024 * 8, 1),
]


@pytest.mark.parametrize("shape", PROBE_SHAPES)
def test_probe_plans_tile_within_the_skip_tile(shape):
    # the plan a probe launches with (query tiles up to 256): D divides the
    # skip tile, shared memory within the budget and equal to the layout's
    b, t, n, slots, k, block_n, pack = shape
    for sms in (132, 114):
        plan = ts.bm25_tile_plan(b, t, n, slots, min(k, n), sms, ts.HASH_QB_MAX, block_n, pack)
        assert plan.staged and block_n % plan.docs == 0  # a staged tile lies in one skip tile
        assert plan.smem == ts._hash_smem(plan.docs, plan.table, slots, t, plan.qb, min(k, n),
                                          plan.list_smem, True, pack)
        _check_packed(plan, b, t, n, slots, min(k, n))
    # the main paths: query tiles of 256 at k = 10, of 128 at k = 1,000
    # (where 256 would halve D), two blocks an SM, one wave; the odd
    # block_n stages one document a tile
    plan = ts.bm25_tile_plan(b, t, n, slots, min(k, n), 132, ts.HASH_QB_MAX, block_n, pack)
    if b == 1024:
        assert plan.qb == (256 if k == 10 else 128) and plan.blocks_per_sm == 2
        assert plan.q_tiles * plan.parts == 264
        assert (plan.docs == 1) == (block_n == 999)


@pytest.mark.parametrize("k", [1, 10, 257, 1000])
@pytest.mark.parametrize("slots", [1, 20, 104, 1500])
def test_tile_plan_widens_the_query_tile_only_where_it_keeps_d(slots, k):
    for b in BATCHES:
        for t in (1, 2, 16, 33):
            for block_n in (None, 128, 999, 2048):
                args = (b, t, 500_000, slots, k, 132)
                base = ts.bm25_hash_plan(*args, ts.HASH_QB, block_n)
                for qb_max in (8, 64, ts.HASH_QB):  # up to 128: bm25_hash_plan's own
                    assert ts.bm25_tile_plan(*args, qb_max, block_n) == \
                        ts.bm25_hash_plan(*args, qb_max, block_n)
                wide = ts.bm25_hash_plan(*args, ts.HASH_QB_MAX, block_n)
                plan = ts.bm25_tile_plan(*args, ts.HASH_QB_MAX, block_n)
                assert plan == (wide if wide.docs >= base.docs else base)
                assert plan.docs >= base.docs
                _check(plan, b, t, 500_000, slots, k, 132, ts.HASH_QB_MAX)
    # the probes' main paths: flat k = 10 keeps D 8 at 256, k = 1,000 would
    # halve D 4 to 2; pack 6 keeps D 32 at k = 10
    assert ts.bm25_tile_plan(1024, 2, 500_000, 104, 10, 132, 256, 2048).qb == 256
    assert ts.bm25_tile_plan(1024, 2, 500_000, 104, 1000, 132, 256, 2048)[:2] == (128, 4)
    assert ts.bm25_tile_plan(1024, 2, 522_931, 21, 10, 132, 256, 2016, 6)[:2] == (256, 32)
