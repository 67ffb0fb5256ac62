"""Corpus-sharded retrieval: per-shard top-k, then one deterministic merge.

The port's copy of the JAX package's ``parallel/sharded.py``. Each engine
searches every shard of a corpus split over a mesh's ``"corpus"`` axis with
the port's own single-device op (its normal routing, so CUDA shards launch
the ported kernels: #1 for dense verified, #2 for dense exact past
``FULL_MATERIALIZE_BUDGET``, #3 for BM25, #9 / #10 for MaxSim), turns the
local row numbers into global doc rows, masks pads and sentinels to
``(NEG_INF, INT_MAX)``, moves each shard's ``[Q, k_sel]`` lists to the first
device of the row, stacks them to ``[Q, P, k_sel]`` and merges by the global
``(-score, doc_id)`` order (``ops/topk.py::merge_topk``). The merge does not
depend on how the corpus was split, so sharded rankings equal the
single-device ones, ties included.

JAX runs the shards in one program (``shard_map`` + ``all_gather``); here
one process drives them: the shards of one device run in turn, those of
distinct devices in one thread a device, so distinct cards overlap although
the ops read a count back to the host (the verified proofs, tie checks).
When ``torch.distributed`` joins several processes and the searched row
holds shards of other processes, each process searches its own shards and
the merge first all-gathers the local lists over the process group.

Corpora are placed as :class:`ShardedRows`, shard ``p`` on corpus device
``p``. Across processes every process holds the same number of shards of the
searched row (the all-gather takes equal shapes).
"""

from __future__ import annotations

import concurrent.futures
from collections import defaultdict
from typing import Callable

import numpy as np
import torch

from autorag_research_tpu_torch.ops.topk import INT_MAX, NEG_INF, merge_topk, pad_to_k
from autorag_research_tpu_torch.parallel.mesh import CORPUS_AXIS, DeviceMesh


class ShardedRows:
    """A row-padded array split over a mesh's corpus axis: ``shards[p]``
    holds rows ``[p * shard_rows, (p + 1) * shard_rows)`` on corpus device
    ``p``, or is None where another process holds them."""

    def __init__(self, shards: list, shard_rows: int, shape: tuple):
        self.shards = shards
        self.shard_rows = shard_rows
        self.shape = tuple(shape)  # the padded whole: (P * shard_rows, ...)

    @property
    def dtype(self) -> torch.dtype:
        return next(t for t in self.shards if t is not None).dtype

    def nbytes(self) -> int:
        """Bytes of the shards this process holds."""
        return sum(t.numel() * t.element_size() for t in self.shards if t is not None)


def place_rows(array, mesh: DeviceMesh, shard_rows: int | None = None, pad_value=0,
               row_multiple: int = 1) -> ShardedRows:
    """Split ``array`` (numpy or a tensor) by rows over the mesh's corpus
    axis, padded with ``pad_value`` to ``P * shard_rows`` (default: the rows
    over P rounded up to ``row_multiple``); each local shard goes to its
    device. Only the shards' own rows are copied."""
    n_shards = mesh.shape[CORPUS_AXIS]
    t = array if isinstance(array, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(array))
    n = t.shape[0]
    if shard_rows is None:
        shard_rows = -(-max(1, -(-n // n_shards)) // row_multiple) * row_multiple
    shards = []
    for p, (dev, mine) in enumerate(zip(mesh.corpus_devices(), mesh.local_shards())):
        if not mine:
            shards.append(None)
            continue
        part = t[p * shard_rows : (p + 1) * shard_rows]
        pad = shard_rows - part.shape[0]
        if pad:
            part = torch.cat([part, part.new_full((pad, *t.shape[1:]), pad_value)])
        shards.append(part.contiguous().to(dev))
    return ShardedRows(shards, shard_rows, (shard_rows * n_shards, *t.shape[1:]))


# ----------------------------------------------------------------- engine core
def _run_shards(mesh: DeviceMesh, search: Callable[[int, torch.device], tuple]) -> dict[int, tuple]:
    """``search(p, device)`` for every local shard p: in turn on one device,
    one thread a device across distinct devices (each under its CUDA device
    context). Returns {p: result}."""
    groups: dict[torch.device, list[int]] = defaultdict(list)
    for p, (dev, mine) in enumerate(zip(mesh.corpus_devices(), mesh.local_shards())):
        if mine:
            groups[dev].append(p)

    def run(dev: torch.device, ps: list[int]) -> dict[int, tuple]:
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return {p: search(p, dev) for p in ps}
        return {p: search(p, dev) for p in ps}

    if len(groups) <= 1:
        return {p: r for dev, ps in groups.items() for p, r in run(dev, ps).items()}
    out: dict[int, tuple] = {}
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(groups)) as pool:
        futures = [pool.submit(run, dev, ps) for dev, ps in groups.items()]
        for fut in futures:
            out.update(fut.result())
    return out


def _to_global(scores, local_ids, offset: int, shard_rows: int, n_total: int):
    """Local rows -> global doc rows; pads, sentinels and rows past
    ``n_total`` become ``(NEG_INF, INT_MAX)``. The local id is validated
    before the offset is added: ``INT_MAX + offset`` would wrap."""
    local = local_ids.to(torch.int64)
    valid = (local >= 0) & (local < shard_rows)
    gids = torch.where(valid, local + offset, INT_MAX)
    valid &= gids < n_total
    return (
        torch.where(valid, scores.float(), NEG_INF),
        torch.where(valid, gids, INT_MAX).to(torch.int32),
    )


def _merge(mesh: DeviceMesh, lists: dict[int, tuple], q: int, k_sel: int, k_eff: int, k: int):
    """Stack every shard's ``[Q, k_sel]`` lists on the row's first local
    device (sentinel lists for shards with no valid rows), all-gather them
    over the process group when other processes hold shards, and merge to
    ``[Q, k]`` by ``(-score, doc_id)``."""
    local = mesh.local_shards()
    dev = mesh.merge_device()
    ps = [p for p, mine in enumerate(local) if mine]
    s_parts, i_parts = [], []
    for p in ps:
        if p in lists:
            s, i = lists[p]
            s_parts.append(s.to(dev))
            i_parts.append(i.to(dev))
        else:
            s_parts.append(torch.full((q, k_sel), NEG_INF, dtype=torch.float32, device=dev))
            i_parts.append(torch.full((q, k_sel), INT_MAX, dtype=torch.int32, device=dev))
    all_s = torch.stack(s_parts, dim=1)  # [Q, P_local, k_sel]
    all_i = torch.stack(i_parts, dim=1)
    if not all(local):
        all_s, all_i = _all_gather_lists(all_s, all_i)
    scores, ids = merge_topk(all_s, all_i, k_eff)
    return pad_to_k(scores, ids, k, k_eff)


def _all_gather_lists(all_s: torch.Tensor, all_i: torch.Tensor):
    """Every process's ``[Q, P_local, k_sel]`` lists, concatenated on the
    shard axis in rank order (gloo moves them through host memory)."""
    import torch.distributed as dist

    dev = all_s.device
    on_host = dist.get_backend() != "nccl"
    s, i = (all_s.cpu(), all_i.cpu()) if on_host else (all_s, all_i)
    n = dist.get_world_size()
    gs = [torch.empty_like(s) for _ in range(n)]
    gi = [torch.empty_like(i) for _ in range(n)]
    dist.all_gather(gs, s.contiguous())
    dist.all_gather(gi, i.contiguous())
    return torch.cat(gs, dim=1).to(dev), torch.cat(gi, dim=1).to(dev)


def _engine(mesh: DeviceMesh, q: int, shard_rows: int, n_total: int, k: int, k_sel: int,
            search: Callable[[int, torch.device], tuple]):
    """Run ``search(p, device) -> (scores, local ids)``, each ``[Q, k_sel]``,
    on every local shard holding valid rows, mask, merge. Returns (scores
    [Q, k], ids [Q, k])."""
    k_eff = min(k, n_total)

    def one(p: int, dev: torch.device):
        offset = p * shard_rows
        if offset >= n_total:  # a pad-only shard adds nothing
            return None
        return _to_global(*search(p, dev), offset, shard_rows, n_total)

    lists = {p: r for p, r in _run_shards(mesh, one).items() if r is not None}
    return _merge(mesh, lists, q, k_sel, k_eff, k)


def mesh_max(value: float, mesh: DeviceMesh) -> float:
    """The largest of every process's ``value`` when other processes hold
    shards of the searched row, else ``value``."""
    if all(mesh.local_shards()):
        return value
    import torch.distributed as dist

    values: list = [None] * dist.get_world_size()
    dist.all_gather_object(values, value)
    return max(values)


def _on(x: torch.Tensor, dev: torch.device, cache: dict) -> torch.Tensor:
    """``x`` on ``dev``, copied once a device per call."""
    if dev not in cache:
        cache[dev] = x.to(dev)
    return cache[dev]


def _n_valid(p: int, shard_rows: int, n_total: int) -> int:
    return int(np.clip(n_total - p * shard_rows, 0, shard_rows))


# ------------------------------------------------------------------ dense exact
def shard_corpus(corpus, mesh: DeviceMesh) -> ShardedRows:
    """Place an [N, d] corpus row-sharded over the mesh's corpus axis,
    zero-padded to a multiple of the axis size."""
    return place_rows(corpus, mesh)


def sharded_dense_topk(
    queries: torch.Tensor, corpus: ShardedRows, k: int, n_total: int, mesh: DeviceMesh,
    method: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global exact top-k over a corpus sharded on the corpus axis (each
    shard through ``ops/dense.py::dense_topk``). Returns (scores [Q, k],
    doc rows [Q, k]) on the row's first device.

    Zero pad rows score exactly 0 and would displace negative-scoring real
    documents from a shard's local top-k, so each shard fetches
    ``k_eff + n_pad`` (the global pad count, < P) before the mask."""
    from autorag_research_tpu_torch.ops.dense import dense_topk

    shard_rows = corpus.shard_rows
    n_pad = corpus.shape[0] - n_total
    k_sel = min(min(k, n_total) + n_pad, shard_rows)
    qs: dict = {}
    return _engine(mesh, queries.shape[0], shard_rows, n_total, k, k_sel,
                   lambda p, dev: dense_topk(_on(queries, dev, qs), corpus.shards[p], k_sel,
                                             method=method))


# ------------------------------------------------------------------- dense int8
def shard_corpus_int8(corpus_q, corpus_scale, mesh: DeviceMesh,
                      row_multiple: int = 1) -> tuple[ShardedRows, ShardedRows]:
    """Place an int8-quantized corpus and its per-row scales row-sharded
    over the corpus axis (zero rows of scale 0; ``row_multiple`` rounds a
    shard's rows up, e.g. to the 16 that ``int8_matmul`` takes in place)."""
    q_sh = place_rows(corpus_q, mesh, row_multiple=row_multiple)
    return q_sh, place_rows(corpus_scale, mesh, shard_rows=q_sh.shard_rows)


def sharded_dense_topk_int8(
    queries: torch.Tensor, corpus_q: ShardedRows, corpus_scale: ShardedRows, k: int,
    n_total: int, mesh: DeviceMesh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sharded ``ops/dense.py::dense_topk_int8``: per-shard quantized scan
    and the same merge. Queries quantize the same way on every shard, so the
    shards' scores are globally comparable. Each shard masks its rows past
    its valid count (``n_valid``), so pad rows never surface and no
    overfetch is needed. APPROXIMATE like the single-device int8 path."""
    from autorag_research_tpu_torch.ops.dense import dense_topk_int8

    shard_rows = corpus_q.shard_rows
    k_sel = min(k, n_total, shard_rows)
    qs: dict = {}
    return _engine(
        mesh, queries.shape[0], shard_rows, n_total, k, k_sel,
        lambda p, dev: dense_topk_int8(
            _on(queries, dev, qs), corpus_q.shards[p], corpus_scale.shards[p], k_sel,
            n_valid=_n_valid(p, shard_rows, n_total),
        ),
    )


# --------------------------------------------------------------- dense verified
def shard_corpus_verified(
    corpus, sidecar: dict, mesh: DeviceMesh, block: int = 2048
) -> tuple[ShardedRows, ShardedRows]:
    """Shard the f32 corpus and its bf16 prescreen sidecar for
    :func:`sharded_dense_topk_verified`: rows pad to a multiple of
    ``P * block``, so each shard is whole sidecar blocks. Returns
    (corpus_sh, corpus_lo_sh)."""
    if sidecar.get("corpus_scale") is not None:
        raise ValueError("sharded verified retrieval supports the bf16 sidecar only")
    n_shards = mesh.shape[CORPUS_AXIS]
    n = corpus.shape[0]
    shard_rows = -(-max(n, 1) // (n_shards * block)) * block
    lo = sidecar["corpus_lo"][:n]
    return (
        place_rows(corpus, mesh, shard_rows=shard_rows),
        place_rows(lo, mesh, shard_rows=shard_rows),
    )


def sharded_dense_topk_verified(
    queries: torch.Tensor, corpus: ShardedRows, corpus_lo: ShardedRows, nd_max: float,
    r_max: float, k: int, n_total: int, mesh: DeviceMesh, m: int = 64, j: int = 2,
    seg: int = 128, return_stats: bool = False,
):
    """Sharded verified-exact dense top-k: each shard runs the verified path
    (``ops/dense.py::_dense_topk_verified``: #1 on a card) over its rows with
    its own valid count ``clip(n_total - offset, 0, shard_rows)``, so pads
    never enter its statistics, candidates or fallbacks; the shards' exact
    lists merge by ``(-score, doc_id)``. Results equal
    :func:`sharded_dense_topk`. With ``return_stats`` also (n_fail summed
    over the shards, covered on every shard)."""
    from autorag_research_tpu_torch.ops.dense import _dense_topk_verified, _require_exact_f32

    _require_exact_f32()
    shard_rows = corpus.shard_rows
    k_sel = min(k, n_total, shard_rows)
    stats: dict[int, tuple[int, bool]] = {}
    qs: dict = {}

    def search(p: int, dev: torch.device):
        s, i, n_fail, covered = _dense_topk_verified(
            _on(queries, dev, qs), corpus.shards[p], corpus_lo.shards[p], None, nd_max, r_max,
            k_sel, m, j, seg, 0, n_valid=_n_valid(p, shard_rows, n_total),
        )
        stats[p] = (n_fail, covered)
        return s, i

    scores, ids = _engine(mesh, queries.shape[0], shard_rows, n_total, k, k_sel, search)
    if return_stats:
        return scores, ids, sum(f for f, _ in stats.values()), all(c for _, c in stats.values())
    return scores, ids


# ------------------------------------------------------------------------ BM25
def sharded_bm25_topk(
    q_ids: torch.Tensor, q_weights: torch.Tensor, doc_ids: ShardedRows, doc_weights: ShardedRows,
    k: int, n_total: int, mesh: DeviceMesh, method: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global BM25 top-k over a corpus-sharded flat slot layout (pad rows
    ``DOC_PAD``, which score 0), each shard through
    ``ops/sparse.py::bm25_topk`` (#3 on a card)."""
    from autorag_research_tpu_torch.ops.sparse import bm25_topk

    shard_rows = doc_ids.shard_rows
    k_sel = min(k, n_total)
    qi: dict = {}
    qw: dict = {}
    return _engine(
        mesh, q_ids.shape[0], shard_rows, n_total, k, k_sel,
        lambda p, dev: bm25_topk(_on(q_ids, dev, qi), _on(q_weights, dev, qw),
                                 doc_ids.shards[p], doc_weights.shards[p], k_sel, method=method),
    )


# ------------------------------------------------------------------------- IVF
def sharded_ivf_topk(
    queries: torch.Tensor, corpus_sh: ShardedRows, centroids_sh: ShardedRows,
    members_sh: ShardedRows, k: int, nprobe: int, shard_rows: int, n_total: int,
    mesh: DeviceMesh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global IVF top-k over per-shard sub-indexes (``[1, Ns + 1, d]``
    corpus, ``[1, C, d]`` centroids, ``[1, C, cell_pad]`` members a shard):
    each shard probes ``nprobe`` of its own cells and ranks its candidates
    exactly (``index/ivf.py::_ivf_search``), then the lists merge by
    ``(-score, doc row)``; P x nprobe cells are probed in all."""
    from autorag_research_tpu_torch.index.ivf import _ivf_search

    k_eff = min(k, n_total)
    qs: dict = {}
    return _engine(
        mesh, queries.shape[0], shard_rows, n_total, k, k_eff,
        lambda p, dev: _ivf_search(_on(queries, dev, qs), corpus_sh.shards[p][0],
                                   centroids_sh.shards[p][0], members_sh.shards[p][0], k_eff,
                                   nprobe),
    )


# ---------------------------------------------------------------------- MaxSim
def sharded_maxsim_topk(
    queries: torch.Tensor, query_lens: torch.Tensor, docs: ShardedRows, doc_lens: ShardedRows,
    k: int, n_total: int, mesh: DeviceMesh, method: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global MaxSim top-k over a corpus-sharded multi-vector index, each
    shard through ``ops/maxsim.py::maxsim_topk`` (#9 for k <= 16 on a card,
    else #10 and ``sort_topk``). Pad documents carry ``doc_lens == 0``.
    ``query_lens`` stays where the caller keeps it (the launch plans read
    the host's)."""
    from autorag_research_tpu_torch.ops.maxsim import maxsim_topk

    k_eff = min(k, n_total)
    qs: dict = {}
    return _engine(
        mesh, queries.shape[0], docs.shard_rows, n_total, k, k_eff,
        lambda p, dev: maxsim_topk(_on(queries, dev, qs), query_lens, docs.shards[p],
                                   doc_lens.shards[p], k_eff, method=method),
    )


def sharded_maxsim_topk_int8(
    queries: torch.Tensor, query_lens: torch.Tensor, docs_q: ShardedRows, doc_scales: ShardedRows,
    doc_lens: ShardedRows, k: int, n_total: int, mesh: DeviceMesh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Global int8 MaxSim top-k over a corpus-sharded quantized index
    (``ops/maxsim.py::maxsim_topk_int8`` a shard). Queries quantize the same
    way on every shard, so the merge stays shard-count invariant.
    APPROXIMATE like the local path."""
    from autorag_research_tpu_torch.ops.maxsim import maxsim_topk_int8

    k_eff = min(k, n_total)
    qs: dict = {}
    return _engine(
        mesh, queries.shape[0], docs_q.shard_rows, n_total, k, k_eff,
        lambda p, dev: maxsim_topk_int8(_on(queries, dev, qs), query_lens, docs_q.shards[p],
                                        doc_scales.shards[p], doc_lens.shards[p], k_eff),
    )


def sharded_maxsim_topk_verified(
    queries: torch.Tensor, query_lens: torch.Tensor, docs: ShardedRows, doc_lens: ShardedRows,
    docs_lo: ShardedRows, nd_max: float, r_max: float, k: int, n_total: int, mesh: DeviceMesh,
    kprime: int = 64, return_stats: bool = False,
):
    """Sharded verified-exact MaxSim top-k: each shard runs the verified
    path (``ops/maxsim.py::_maxsim_topk_verified``: #10 prescreen on a card,
    exact rerank, proof) with the whole corpus's bounds ``nd_max`` /
    ``r_max``, then the shards' exact lists merge. ``kprime`` is clamped to
    ``max(kprime, k)``. With ``return_stats`` also (n_fail summed, covered
    on every shard)."""
    from autorag_research_tpu_torch.ops.maxsim import _maxsim_topk_verified
    from autorag_research_tpu_torch.ops.dense import _require_exact_f32

    _require_exact_f32()
    kprime = max(kprime, k)
    k_eff = min(k, n_total)
    stats: dict[int, tuple[int, bool]] = {}
    qs: dict = {}

    def search(p: int, dev: torch.device):
        s, i, n_fail, covered = _maxsim_topk_verified(
            _on(queries, dev, qs), query_lens, docs.shards[p], doc_lens.shards[p],
            docs_lo.shards[p], nd_max, r_max, k_eff, kprime, 0,
        )
        stats[p] = (n_fail, covered)
        return s, i

    scores, ids = _engine(mesh, queries.shape[0], docs.shard_rows, n_total, k, k_eff, search)
    if return_stats:
        return scores, ids, sum(f for f, _ in stats.values()), all(c for _, c in stats.values())
    return scores, ids
