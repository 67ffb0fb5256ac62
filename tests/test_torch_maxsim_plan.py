"""The launch plan of the MaxSim tile body (``ops/maxsim.py::maxsim_plan``).

``csrc/maxsim_tile.cuh`` runs only on the card; its plan is host code, a pure
function of (query lengths, N, Td, d, k, dtype, SMs, blocks per SM), so its
invariants are checked here against counts made apart from it: whole queries
packed in order into row tiles of 128 rows (f32) or 256 (bf16) (every valid
row in exactly one tile, no query split across blocks, at most 32 queries a
tile), the table and the packed
rows' sources decoding back to each query's rows, parts that cover N exactly,
shared memory equal to an independent count of the layout and within a
block's 227 KB, the ring as long as fits, and the refusals. The kernel's
launcher refuses a plan whose bytes differ from its own layout's, which the
CUDA tests in ``test_torch_kernels_cuda.py`` hold on the card.

The pins' policies ("bias" for #11, "lane" for #12) keep those invariants
over each query's rows, one row for a query of length 0, walk all Td
tokens of every document, and size their k-boxes from the operand width
they see (d' = 136 for "lane" at d = 128).
"""

import numpy as np
import pytest
import torch

from autorag_research_tpu_torch.ops import maxsim as tm

BS = (1, 3, 37, 128, 300)
MIXES = ("equal", "uniform", "long", "zeros")
TDS = (9, 40, 128, 1024)
DS = (8, 104, 128)
KS = (1, 10, 16, 65, 256, 1000)
CARDS = ((132, 1), (114, 1), (8, 2))
DTYPES = (torch.float32, torch.bfloat16)
SMEM_MAX = 232448


def _lens(mix: str, b: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if mix == "equal":
        return np.full(b, 20)
    if mix == "uniform":
        return rng.integers(8, 33, size=b)
    if mix == "long":  # one query of 150 or 300 tokens among short ones
        lens = rng.integers(1, 33, size=b)
        lens[b // 2] = 150 if b % 2 else 300
        return lens
    lens = rng.integers(0, 33, size=b)  # zeros among them, and all zero for b < 4
    lens[::3] = 0
    return lens if b >= 4 else np.zeros(b, dtype=np.int64)


ROWS = {torch.float32: 128, torch.bfloat16: 256}  # query-token rows of a tile


def _layout(d: int, k: int, dtype, stages: int, resident: bool, lists: bool) -> int:
    """The tile body's shared memory, counted apart from the plan: 1,024
    bytes of alignment slack, the resident query rows (a tile's rows x d, in
    128-byte k-boxes), a ring of 16 KB token k-boxes (with the query k-box
    beside each when streamed), a [32, rows + 1] f32 table of row maxima,
    two 8-byte barriers per slot and two for the query tile, and the
    [32, k] lists of (f32, int32) when they live in shared memory."""
    rows = ROWS[dtype]
    k_boxes = -(-d * (2 if dtype == torch.bfloat16 else 4) // 128)
    q = rows * 128 * k_boxes if resident else 0
    ring = stages * (16384 + (0 if resident else rows * 128))
    return 1024 + q + ring + 32 * (rows + 1) * 4 + 8 * (2 * stages + 2) + (32 * k * 8 if lists else 0)


def _walked(lens, n: int) -> int:
    """Tokens walked, counted apart from the plan: per group of 32 documents
    its chunks of 16 (round_up(len, 16) / 16 a document) in product tiles of
    8 chunks, 128 tokens a tile."""
    chunks = [sum(-(-int(x) // 16) for x in lens[g : g + 32]) for g in range(0, n, 32)]
    return sum(-(-c // 8) * 128 for c in chunks)


def _check(plan, lens, n, td, d, k, dtype, sms, bps, mask="lens"):
    b = lens.size
    k_eff = min(k, n)
    rows = ROWS[dtype]
    assert plan.rows == rows and plan.mask == mask
    # the rows the kernel computes: a query's own, one for a length-0 query
    # under the pins' policies
    valid, lens = lens, (lens if mask == "lens" else np.maximum(lens, 1))
    blk = plan.table[: 4 * plan.blocks].reshape(plan.blocks, 4).astype(np.int64)
    qrow = plan.table[4 * plan.blocks :].reshape(b, 2).astype(np.int64)
    assert plan.table.size == 4 * plan.blocks + 2 * b
    # blocks: whole queries, in order, contiguous, at most 32 a tile
    first, count, tiles, row0 = blk.T
    assert first[0] == 0 and (first[1:] == first[:-1] + count[:-1]).all()
    assert first[-1] + count[-1] == b and (count >= 1).all() and (count <= 32).all()
    assert (row0 == np.concatenate([[0], np.cumsum(tiles)[:-1]]) * rows).all()
    assert plan.q_rows == int(tiles.sum()) * rows
    assert plan.rows_valid == int(valid.sum())
    if mask != "lens":  # every document walked over all Td tokens
        assert plan.tokens_walked == _walked(np.full(n, td), n)
        assert plan.tokens_walked >= n * (-(-td // 16) * 16)
    owner = np.repeat(np.arange(plan.blocks), count)
    for i in range(plan.blocks):
        q_lens = lens[first[i] : first[i] + count[i]]
        if tiles[i] > 1:  # a long query alone in its block, on its own tiles
            assert count[i] == 1 and q_lens[0] > rows and tiles[i] == -(-q_lens[0] // rows)
        else:
            assert q_lens.sum() <= rows
    # every valid row in exactly one tile, inside its block's tiles
    assert (qrow[:, 1] == lens).all()
    cover = np.zeros(plan.q_rows, dtype=np.int64)
    for q in range(b):
        start, length = qrow[q]
        lo, hi = row0[owner[q]], row0[owner[q]] + rows * tiles[owner[q]]
        assert lo <= start and start + length <= hi
        cover[start : start + length] += 1
    assert cover.max(initial=0) <= 1 and cover.sum() == lens.sum()
    # the packed rows' sources decode back to each query's rows
    tq = max(int(lens.max(initial=0)), 1)
    src = tm._query_gather(plan, b, tq)
    assert src.shape == (plan.q_rows,)
    live = src < b * tq
    assert live.sum() == lens.sum() and (cover[live] == 1).all() and (cover[~live] == 0).all()
    qs, ts = src[live] // tq, src[live] % tq
    assert (ts < lens[qs]).all() and (np.flatnonzero(live) == qrow[qs, 0] + ts).all()
    # parts cover N exactly, none empty, whole groups of 32 documents
    assert plan.part_docs % 32 == 0
    assert (plan.parts - 1) * plan.part_docs < n <= plan.parts * plan.part_docs
    assert plan.items == plan.blocks * plan.parts
    assert plan.slots == sms * bps and plan.grid == min(plan.items, plan.slots)
    assert plan.waves == -(-plan.items // plan.slots)
    if k > 0 and plan.parts > 1:
        assert plan.part_docs >= 4 * k_eff  # parts never grow with k
    # the items fill the waves at least as well as one part a row block
    fill = plan.items / (plan.waves * plan.slots)
    assert fill >= plan.blocks / (-(-plan.blocks // plan.slots) * plan.slots) - 1e-12
    # shared memory: an independent count, within a block's limit
    shared = plan.lists == "shared"
    assert (plan.lists is None) == (k == 0) and plan.lists in (None, "shared", "global")
    assert plan.resident == (_layout(d, 0, dtype, 3, True, False) <= SMEM_MAX)
    if k > 0:
        assert shared == (_layout(d, k_eff, dtype, 3, plan.resident, True) <= SMEM_MAX)
    assert plan.smem_bytes == _layout(d, k_eff, dtype, plan.stages, plan.resident, shared)
    assert plan.smem_bytes <= SMEM_MAX and 3 <= plan.stages <= 6
    if plan.stages < 6:  # the ring takes as many slots as fit
        assert _layout(d, k_eff, dtype, plan.stages + 1, plan.resident, shared) > SMEM_MAX


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b", BS)
@pytest.mark.parametrize("mix", MIXES)
def test_plan_invariants(mix, b, dtype):
    lens = _lens(mix, b, seed=b)
    for td in TDS:
        n = 3 * td + 5
        for d in DS:
            for sms, bps in CARDS:
                for k in (0,) + KS:
                    plan = tm.maxsim_plan(lens, n, td, d, k, dtype, sms, bps)
                    _check(plan, lens, n, td, d, k, dtype, sms, bps)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b", BS)
@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("mask", ["bias", "lane"])
def test_pin_plan_invariants(mask, mix, b, dtype):
    # the pins' plans over the same length mixes (zeros among them) and
    # cards; fused only, so k >= 1; "lane" at the augmented widths d' too
    lens = _lens(mix, b, seed=b)
    for td in TDS:
        n = 3 * td + 5
        for d in DS + ((136,) if mask == "lane" else ()):
            for sms, bps in CARDS:
                for k in KS:
                    plan = tm.maxsim_plan(lens, n, td, d, k, dtype, sms, bps, mask=mask)
                    _check(plan, lens, n, td, d, k, dtype, sms, bps, mask=mask)


@pytest.mark.parametrize("n", [1, 31, 33, 50_000])
def test_plan_invariants_across_corpus_sizes(n):
    lens = _lens("uniform", 128, seed=n)
    for dtype in DTYPES:
        for sms, bps in CARDS:
            for k in (0, 1, 10, 100):
                _check(tm.maxsim_plan(lens, n, 128, 128, k, dtype, sms, bps), lens, n, 128, 128,
                       k, dtype, sms, bps)


def test_wide_rows_stream_the_queries():
    # f32 rows past 320 lanes (bf16 past 256, at 256 rows a tile) no longer
    # fit beside the ring: each slot carries the query k-box beside the tokens'
    lens = np.array([5, 40, 7])
    for dtype, d, resident in ((torch.float32, 320, True), (torch.float32, 328, False),
                               (torch.bfloat16, 256, True), (torch.bfloat16, 264, False)):
        plan = tm.maxsim_plan(lens, 100, 16, d, 10, dtype, 132, 1)
        assert plan.resident == resident
        _check(plan, lens, 100, 16, d, 10, dtype, 132, 1)


def test_main_path_plan():
    # the MaxSim main path on an H100's 132 SMs at one block an SM: 128
    # queries of 8-32 tokens, text (50,000 docs of 64-128 tokens, f32, row
    # tiles of 128) and pages (10,000 of 512-1,024, bf16, row tiles of 256),
    # d = 128
    rng = np.random.default_rng(0)
    lens = rng.integers(8, 33, size=128)
    text_lens = rng.integers(64, 129, size=50_000)
    page_lens = rng.integers(512, 1025, size=10_000)
    text = tm.maxsim_plan(lens, 50_000, 128, 128, 10, torch.float32, 132, 1, doc_lens=text_lens)
    page = tm.maxsim_plan(lens, 10_000, 1024, 128, 0, torch.bfloat16, 132, 1, doc_lens=page_lens)
    print(f"text k=10: {text.note()}\npage k'+1=65 (scores): {page.note()}")
    assert text == tm.MaxSimPlan(
        rows=128, k_boxes=4, stages=6, resident=True, lists="shared", smem_bytes=184_048, blocks=23,
        q_rows=2944, parts=17, part_docs=2944, items=391, grid=132, slots=132, waves=3,
        rows_valid=int(lens.sum()), tokens_walked=text.tokens_walked,
        tokens_valid=int(text_lens.sum()),
    )
    assert (page.k_boxes, page.stages, page.resident, page.lists, page.smem_bytes) == (
        2, 6, True, None, 197_872)
    assert (page.blocks, page.parts, page.part_docs, page.items, page.waves) == (
        11, 12, 864, 132, 1)
    # rows computed / valid within 1.15 (1.5-1.6 with Tq-padded queries);
    # tokens walked / valid within 1.2 at text (chunks of 16, product tiles
    # of 8 chunks a group of 32 documents)
    assert text.q_rows / text.rows_valid <= 1.15 and page.q_rows / page.rows_valid <= 1.15
    assert text.tokens_walked / text.tokens_valid <= 1.2
    assert page.tokens_walked / page.tokens_valid <= 1.05
    # the fused k = 100 and k'+1 = 65 lists fit shared memory beside a full ring
    assert tm.maxsim_plan(lens, 50_000, 128, 128, 100, torch.float32, 132, 1).lists == "shared"
    assert tm.maxsim_plan(lens, 10_000, 1024, 128, 65, torch.bfloat16, 132, 1).lists == "shared"


def test_pin_plans_walk_all_tokens():
    # "bias" and "lane" read no lengths: every document's Td tokens in
    # chunks of 16, whatever doc_lens says; "lens" walks round_up(len, 16)
    rng = np.random.default_rng(7)
    q_lens = rng.integers(1, 33, size=40)
    for n, td in ((64, 128), (1000, 37), (33, 16), (7, 1)):
        doc_lens = rng.integers(0, td + 1, size=n)
        lens_plan = tm.maxsim_plan(q_lens, n, td, 128, 10, torch.float32, 132, 1,
                                   doc_lens=doc_lens)
        assert lens_plan.tokens_walked == _walked(doc_lens, n)
        for mask in ("bias", "lane"):
            plan = tm.maxsim_plan(q_lens, n, td, 136 if mask == "lane" else 128, 10,
                                  torch.float32, 132, 1, doc_lens=doc_lens, mask=mask)
            assert plan.tokens_walked == _walked(np.full(n, td), n)
            assert plan.tokens_valid == int(doc_lens.sum())
            if n % 32 == 0:  # whole groups: exactly N x round_up(Td, 16)
                assert plan.tokens_walked == n * (-(-td // 16) * 16)
            # without doc_lens the walk is still known, the valid tokens not
            bare = tm.maxsim_plan(q_lens, n, td, 128, 10, torch.float32, 132, 1, mask=mask)
            assert bare.tokens_walked == plan.tokens_walked and bare.tokens_valid is None
            assert "tokens walked" in bare.note() and f"{mask} policy" in bare.note()


def test_pin_plans_keep_one_row_for_an_empty_query():
    # a query of length 0 keeps one row under the pins' policies (its sums
    # then put an empty document below a full one, as the TPU kernels' pad
    # rows do) and none under "lens", where the kernel knows empty documents
    # by their lengths; the row's source is the query's row 0
    q_lens = np.array([0, 5, 0, 0, 3])
    for mask, rows in (("lens", [0, 5, 0, 0, 3]), ("bias", [1, 5, 1, 1, 3]),
                       ("lane", [1, 5, 1, 1, 3])):
        plan = tm.maxsim_plan(q_lens, 100, 16, 136, 10, torch.float32, 132, 1, mask=mask)
        qrow = plan.table[4 * plan.blocks :].reshape(5, 2)
        assert qrow[:, 1].tolist() == rows and plan.rows_valid == 8
        src = tm._query_gather(plan, 5, 6)
        for q, (start, r) in enumerate(qrow):
            assert src[start : start + r].tolist() == [q * 6 + t for t in range(r)]
        assert (np.delete(src, np.concatenate([np.arange(s, s + r) for s, r in qrow])) == 30).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_lane_plan_sizes_k_boxes_from_the_augmented_width(dtype):
    # d = 128 + the bias lane -> d' = 136: a fifth f32 k-box of 32 lanes (a
    # third bf16 one of 64), 8 of them live; in bf16 the third resident
    # query k-box (256 rows x 128 bytes) costs the ring its sixth slot
    lens = np.full(128, 20)
    lane = tm.maxsim_plan(lens, 50_000, 128, 136, 10, dtype, 132, 1, mask="lane")
    bias = tm.maxsim_plan(lens, 50_000, 128, 128, 10, dtype, 132, 1, mask="bias")
    f32 = dtype == torch.float32
    assert (lane.k_boxes, bias.k_boxes) == ((5, 4) if f32 else (3, 2))
    assert lane.resident and lane.smem_bytes == _layout(136, 10, dtype, lane.stages, True, True)
    assert lane.stages == (6 if f32 else 5) and bias.stages == 6
    _check(lane, lens, 50_000, 128, 136, 10, dtype, 132, 1, mask="lane")


def test_pin_main_path_plans():
    # the pinned text search on an H100's 132 SMs (one block an SM): the
    # pins compute each query's own rows, as #9 does, and walk every token:
    # about 1.33 tokens walked per valid token at Td = 128 (lengths 64-128)
    # and 1,024 (512-1,024), against #9's 1.10 and 1.01
    rng = np.random.default_rng(0)
    lens = rng.integers(8, 33, size=128)
    text_lens = rng.integers(64, 129, size=50_000)
    page_lens = rng.integers(512, 1025, size=10_000)
    for mask, d in (("bias", 128), ("lane", 136)):
        text = tm.maxsim_plan(lens, 50_000, 128, d, 10, torch.float32, 132, 1,
                              doc_lens=text_lens, mask=mask)
        page = tm.maxsim_plan(lens, 10_000, 1024, d, 10, torch.bfloat16, 132, 1,
                              doc_lens=page_lens, mask=mask)
        print(f"{mask} text: {text.note()}\n{mask} page: {page.note()}")
        v2 = tm.maxsim_plan(lens, 50_000, 128, 128, 10, torch.float32, 132, 1)
        assert (text.blocks, text.q_rows, text.parts) == (v2.blocks, v2.q_rows, v2.parts)
        assert text.tokens_walked == 50_000 * 128 and page.tokens_walked == 10_000 * 1024
        assert 1.3 < text.tokens_walked / text.tokens_valid < 1.37
        assert 1.3 < page.tokens_walked / page.tokens_valid < 1.37
        assert text.q_rows / text.rows_valid <= 1.15 and page.q_rows / page.rows_valid <= 1.15


@pytest.mark.parametrize("bad", [dict(q_lens=[]), dict(n=0), dict(td=0), dict(d=0), dict(d=12),
                                 dict(k=-1), dict(sms=0), dict(blocks_per_sm=0),
                                 dict(q_lens=[3, -1]), dict(n=2**21, td=1024),
                                 dict(mask="none"), dict(mask="bias", k=0),
                                 dict(mask="lane", k=0), dict(mask="lane", d=130)])
def test_plan_refusals(bad):
    args = dict(q_lens=[4, 9], n=100, td=16, d=16, k=5, dtype=torch.float32, sms=132,
                blocks_per_sm=1)
    args.update(bad)
    with pytest.raises(ValueError):
        tm.maxsim_plan(**args)
