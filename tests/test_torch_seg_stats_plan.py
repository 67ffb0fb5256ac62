"""The work plan of the seg-stats kernel (``ops/dense.py::seg_stats_plan``).

``csrc/seg_stats.cu`` runs only on the card; its plan is host code, a pure
function of (Q, rows, d, SMs, blocks per SM, clusters of two the card holds
at once), so its invariants are checked
here against a model of the kernel's walk: cluster ``c`` of ``grid /
cluster`` takes items ``c, c + clusters, ...``; item ``it`` is query group
``it % q_groups`` and corpus tile ``it // q_groups``; block ``rank`` of the
cluster takes query tile ``group * cluster + rank``, and a corpus tile of 256
rows holds segments ``2 t`` and ``2 t + 1``. The walk covers every (query
tile, segment) exactly once and no query tile past Q; shared memory stays
within a block's 227 KB and equals the layout counted apart; the grid is one
wave of the card's resident blocks, or of its resident clusters where these
are fewer than half the blocks. The kernel's launcher refuses a plan whose
shared memory differs from its own layout's, so the CUDA tests in
``test_torch_kernels_cuda.py`` hold the two byte counts equal on the card.
"""

import numpy as np
import pytest

from autorag_research_tpu_torch.ops import dense as td

QS = (1, 63, 64, 128, 129, 200, 256, 1_000, 1_024, 10_000)
NS = (1, 127, 128, 129, 256, 257, 5_183, 501_760, 10_000_000)
DS = (8, 16, 104, 768)
# (SMs, blocks an SM, clusters of two held at once): an H100 SXM (66, measured
# by the occupancy calculator), cards whose GPCs leave SMs without a partner,
# and a card of one SM
CARDS = ((132, 1, 66), (132, 1, 60), (114, 1, 57), (114, 1, 51), (1, 1, 0))


def _layout_bytes() -> int:
    """The kernel's shared-memory layout, counted apart from the plan: 1,024
    bytes of alignment slack, a ring of 4 slots each holding a TMA box of 128
    query rows and one of 256 corpus rows, 64 bf16 (128 bytes) a row, and a
    full and an empty 8-byte barrier per slot."""
    return 1024 + 4 * (128 * 128 + 256 * 128) + 4 * 2 * 8


def _walk(plan) -> tuple[np.ndarray, np.ndarray]:
    """(query tile, segment) of every output the kernel's walk writes, as the
    blocks of each cluster step through their items."""
    clusters = plan.grid // plan.cluster
    # cluster c walks it = c + j * clusters for j < cluster_items: every item
    # once, none past the plan's count
    c, j = np.meshgrid(np.arange(clusters), np.arange(plan.cluster_items), indexing="ij")
    it = (c + j * clusters).ravel()
    it = it[it < plan.items]
    assert np.array_equal(np.sort(it), np.arange(plan.items))
    tiles, segs = [], []
    for rank in range(plan.cluster):
        qt = (it % plan.q_groups) * plan.cluster + rank
        ct = it // plan.q_groups
        for half in range(2):
            tiles.append(qt)
            segs.append(2 * ct + half)
    return np.concatenate(tiles), np.concatenate(segs)


def _check(plan, q, n, d, sms, bps, held):
    q_tiles, s_cnt = -(-q // 128), -(-n // 128)
    assert (plan.bq, plan.bn, plan.bk, plan.stages) == (128, 256, 64, 4)
    assert plan.k_slices == -(-d // 64)
    assert (plan.q_tiles, plan.c_tiles) == (q_tiles, -(-n // 256))
    # clusters of two exactly when the query tiles pair up (no tile past Q)
    # and the card holds a cluster
    assert plan.cluster == (2 if q_tiles % 2 == 0 and held >= 1 else 1)
    assert plan.q_groups * plan.cluster == q_tiles
    assert plan.items == plan.q_groups * plan.c_tiles
    # shared memory: within a block's 227 KB and equal to the layout's count
    assert plan.smem_bytes == _layout_bytes() <= td.SMEM_BLOCK_MAX
    # one wave: no more clusters than the card holds at once (its blocks, or
    # its clusters of two), all of them or one an item
    assert plan.slots == sms * bps
    resident = held if plan.cluster == 2 else sms * bps
    clusters = plan.grid // plan.cluster
    assert plan.resident == resident and plan.grid % plan.cluster == 0
    assert clusters == min(resident, plan.items) and plan.grid <= plan.slots and plan.waves == 1
    assert plan.cluster_items == -(-plan.items // clusters)
    return q_tiles, s_cnt


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_plan_invariants(n, d):
    for q in QS:
        for card in CARDS:
            _check(td.seg_stats_plan(q, n, d, *card), q, n, d, *card)


@pytest.mark.parametrize("n", NS)
def test_walk_covers_every_output_once(n):
    for q in QS:
        for card in CARDS:
            plan = td.seg_stats_plan(q, n, 768, *card)
            q_tiles, s_cnt = _check(plan, q, n, 768, *card)
            tiles, segs = _walk(plan)
            assert tiles.max() < q_tiles  # no block computes a query tile past Q
            keep = segs < s_cnt  # a last corpus tile of one segment writes one
            assert int((~keep).sum()) == (plan.c_tiles * 2 - s_cnt) * q_tiles
            hits = np.bincount(tiles[keep] * s_cnt + segs[keep], minlength=q_tiles * s_cnt)
            assert hits.shape == (q_tiles * s_cnt,) and bool((hits == 1).all())


def test_main_path_plan():
    # the dense verified main path's prescreen: 1,024 queries x 501,760 rows x
    # 768 on an H100's 132 SMs at one block an SM, 66 clusters of two at once:
    # 8 query tiles in 4 pairs x 1,960 corpus tiles = 7,840 items over 66
    # clusters, 119 at most each
    plan = td.seg_stats_plan(1024, 501_760, 768, 132, 1, 66)
    assert plan == td.SegStatsPlan(
        bq=128, bn=256, bk=64, stages=4, k_slices=12, q_tiles=8, c_tiles=1960, cluster=2,
        q_groups=4, items=7840, grid=132, cluster_items=119, smem_bytes=197_696, slots=132,
        resident=66, waves=1,
    )
    # a card that holds 60 clusters launches 60, each walking more items
    fewer = td.seg_stats_plan(1024, 501_760, 768, 132, 1, 60)
    assert (fewer.grid, fewer.cluster_items, fewer.waves) == (120, 131, 1)
    # d = 100 (stored 104): two k-slices; 300 queries (SciFact): three query
    # tiles do not pair, so single blocks, one an item
    assert td.seg_stats_plan(1024, 501_760, 104, 132, 1, 66).k_slices == 2
    small = td.seg_stats_plan(300, 5_183, 768, 132, 1, 66)
    assert (small.cluster, small.items, small.grid, small.resident) == (1, 63, 63, 132)


@pytest.mark.parametrize("bad", [dict(q=0), dict(n=0), dict(d=0), dict(d=12), dict(sms=0),
                                 dict(blocks_per_sm=0), dict(resident_clusters=-1),
                                 dict(resident_clusters=67)])
def test_plan_refuses_empty_shapes(bad):
    args = dict(q=4, n=100, d=16, sms=132, blocks_per_sm=1, resident_clusters=66)
    args.update(bad)
    with pytest.raises(ValueError):
        td.seg_stats_plan(**args)
