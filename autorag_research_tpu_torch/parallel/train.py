"""Training over a ``(dp, tp)`` mesh: sharded parameters and train steps.

The port's counterpart of the JAX package's sharded training. There the
trainers jit ``contrastive_train_step`` / the LM step with the parameters
placed by ``param_specs`` (``models/encoder.py``, ``models/decoder.py``) and
the batch rows by ``P("dp", None)``, and GSPMD partitions the program. Here
the partition is written out, and the sharded step computes the unsharded
step's function: the same loss, the same updated weights and optimizer state,
within f32 reordering.

- :class:`ShardedParams`: grid entry ``(i, j)`` of the mesh holds, on its
  device, the ``j``-th contiguous slice of every tensor split over ``"tp"``
  (in the spec's dimension, so the shard shapes equal the JAX shards') and a
  whole copy of every replicated tensor, as ``NamedSharding`` places them.
  :func:`shard_tree` builds it, :func:`gather_tree` turns it back into one
  flat tree (the names of ``encoder_params_to_jax``).
- The forward of one dp row runs over its tp group. The embedding tables are
  split over the hidden dimension: each entry looks up its columns and the
  row gathers them, since every layer norm reduces over the whole hidden
  dimension. ``qkv``'s contiguous column slices cross the q / k / v
  boundary, so each entry's product is gathered into the whole ``[B, T,
  3h]``; entry ``j`` then runs the attention heads that its ``attn_out`` rows
  cover and multiplies by them, and the row sums the partial outputs.
  ``mlp_in`` / ``mlp_bias`` / ``mlp_out`` are a column / row pair: GELU stays
  on the entry and one partial sum follows. The replicated tensors (layer
  norms, ``out_proj``) are read from the row's first entry.
- The batch rows split in contiguous blocks over ``dp``. InfoNCE takes its
  negatives from the whole global batch, so the rows' embeddings are
  gathered before the one global loss; the gradient of every copy of a
  tensor is summed over the rows (and, for a replicated tensor, over its
  copies) and the same update is applied to every copy.
- Across processes (``parallel/distributed.py``: gloo on the CPU, NCCL on
  cards) each process holds whole dp rows: the embeddings are all-gathered
  with autograd (``_AllGatherRows``, whose backward all-reduces the
  gradient) and the summed gradients all-reduced. A tp group that spans processes is refused:
  JAX's GSPMD would place it, the port keeps each tp group in one process.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from autorag_research_tpu_torch.parallel.distributed import world_size
from autorag_research_tpu_torch.parallel.mesh import DP_AXIS, TP_AXIS, DeviceMesh, process_rank


def flatten_specs(specs, prefix: str = "") -> dict[str, tuple]:
    """``{"blocks.0.qkv": (None, "tp"), ...}`` from a nested spec tree (the
    flat names of a module's ``state_dict`` and of the JAX ``.npz``)."""
    if isinstance(specs, dict):
        return {k: v for key, sub in specs.items() for k, v in flatten_specs(sub, f"{prefix}{key}.").items()}
    if isinstance(specs, list):
        return {k: v for i, sub in enumerate(specs) for k, v in flatten_specs(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tuple(specs)}


def _tp_dim(spec: tuple) -> int | None:
    """The dimension split over ``"tp"``, None for a replicated tensor."""
    for ax in spec:
        if ax not in (None, TP_AXIS):
            raise ValueError(f"a parameter spec names only {TP_AXIS!r}, not {spec}")
    return spec.index(TP_AXIS) if TP_AXIS in spec else None


def check_train_mesh(mesh: DeviceMesh) -> None:
    """Refuse a mesh that is not ``(dp, tp)``, or whose tp group spans
    processes."""
    if mesh.axis_names != (DP_AXIS, TP_AXIS):
        raise ValueError(f"training needs a ({DP_AXIS}, {TP_AXIS}) mesh, not {mesh.axis_names}")
    for i, ranks in enumerate(mesh.ranks):
        if len(set(ranks)) > 1:
            raise ValueError(
                f"the tp group of dp row {i} spans processes {sorted(set(ranks))}: each "
                "process must hold whole dp rows (JAX's GSPMD would place it; the port "
                "keeps a tp group in one process)"
            )


class ShardedParams:
    """A model's parameters over a ``(dp, tp)`` mesh: ``shards[i][j]`` is the
    flat dict that grid entry ``(i, j)`` holds on ``mesh.grid[i][j]``, or
    None where another process holds the entry."""

    def __init__(self, config, mesh: DeviceMesh, specs: dict[str, tuple], shards: list[list]):
        check_train_mesh(mesh)
        self.config, self.mesh, self.specs, self.shards = config, mesh, specs, shards
        self.dp, self.tp = mesh.shape[DP_AXIS], mesh.shape[TP_AXIS]
        rank = process_rank()
        self.rows = [i for i in range(self.dp) if mesh.ranks[i][0] == rank]
        if not self.rows:
            raise ValueError(f"process {rank} holds no dp row of this mesh")
        # every process's rows, rank-ordered, must be contiguous blocks of one
        # size, so that gathering the processes' rows in rank order gives the
        # global batch's order
        by_rank = [mesh.ranks[i][0] for i in range(self.dp)]
        per = by_rank.count(by_rank[0])
        if by_rank != sorted(by_rank) or any(by_rank.count(r) != per for r in set(by_rank)):
            raise ValueError(f"each process must hold an equal contiguous block of dp rows: {by_rank}")

    def entries(self):
        """(i, j, name, tensor) of every entry this process holds."""
        for i in self.rows:
            for j in range(self.tp):
                for name, t in self.shards[i][j].items():
                    yield i, j, name, t

    def tensors(self) -> list[torch.Tensor]:
        return [t for *_, t in self.entries()]

    def entry_bytes(self, i: int, j: int) -> int:
        """Parameter bytes that grid entry ``(i, j)`` holds."""
        return sum(t.numel() * t.element_size() for t in self.shards[i][j].values())


def tp_slice(t: torch.Tensor, spec: tuple, j: int, tp: int, name: str = "") -> torch.Tensor:
    """Entry ``j``'s contiguous slice of ``t`` in the dimension that
    ``spec`` splits over ``"tp"`` (``t`` itself when it is replicated)."""
    dim = _tp_dim(spec)
    if dim is None:
        return t
    if t.shape[dim] % tp:
        raise ValueError(f"{name} {tuple(t.shape)}: dimension {dim} is not divisible by tp={tp}")
    size = t.shape[dim] // tp
    return t.narrow(dim, j * size, size)


def place(t: torch.Tensor, dev) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``dev`` that shares no storage."""
    return t.to(dev).clone(memory_format=torch.contiguous_format)


def shard_tree(params, specs, mesh: DeviceMesh, config=None) -> ShardedParams:
    """Place ``params`` (a module, or a flat dict of tensors or arrays) on
    ``mesh`` by ``specs`` (nested, as ``param_specs`` gives them): each entry
    gets its own copy of its slice. A dimension that its axis size does not
    divide is refused, as ``NamedSharding`` refuses it."""
    check_train_mesh(mesh)
    flat = params.state_dict() if isinstance(params, nn.Module) else params
    specs = flatten_specs(specs)
    if set(flat) != set(specs):
        raise KeyError(f"parameters and specs differ: {sorted(set(flat) ^ set(specs))}")
    tp = mesh.shape[TP_AXIS]
    rank = process_rank()
    shards: list[list] = [[None] * len(row) for row in mesh.grid]
    for i, row in enumerate(mesh.grid):
        for j, dev in enumerate(row):
            if mesh.ranks[i][j] != rank:
                continue
            entry = {}
            for name, spec in specs.items():
                t = torch.as_tensor(np.asarray(flat[name])) if not isinstance(flat[name], torch.Tensor) \
                    else flat[name].detach()
                entry[name] = place(tp_slice(t, spec, j, tp, name), dev).requires_grad_(True)
            shards[i][j] = entry
    return ShardedParams(config, mesh, specs, shards)


def gather_tree(sp: ShardedParams, pick=None, device="cpu") -> dict[str, torch.Tensor]:
    """One flat tree from the first local dp row's entries: the tp slices
    concatenated in their spec's dimension. ``pick(tensor)`` maps each
    entry's tensor first (an optimizer state of it, say)."""
    pick = pick or (lambda t: t)
    i = sp.rows[0]
    out = {}
    for name, spec in sp.specs.items():
        parts = [pick(sp.shards[i][j][name]).detach().to(device) for j in range(sp.tp)]
        dim = _tp_dim(spec)
        out[name] = parts[0].clone() if dim is None else torch.cat(parts, dim=dim)
    return out


# ------------------------------------------------------------------ forward
class _Row:
    """The tp group of one dp row: its entries' parameters and devices. The
    row's activations live on its first device (``lead``)."""

    def __init__(self, sp: ShardedParams, i: int):
        self.parts = sp.shards[i]
        self.devs = sp.mesh.grid[i]
        self.lead = self.devs[0]
        self.cfg = sp.config

    def rep(self, name: str) -> torch.Tensor:
        return self.parts[0][name]

    def gather(self, xs: list[torch.Tensor]) -> torch.Tensor:
        return torch.cat([x.to(self.lead) for x in xs], dim=-1)

    def reduce(self, xs: list[torch.Tensor]) -> torch.Tensor:
        out = xs[0].to(self.lead)
        for x in xs[1:]:
            out = out + x.to(self.lead)
        return out

    def ln(self, x: torch.Tensor, name: str) -> torch.Tensor:
        from autorag_research_tpu_torch.models.encoder import _layer_norm

        return _layer_norm(x, self.rep(f"{name}.scale"), self.rep(f"{name}.bias"))

    def embed(self, ids: torch.Tensor, pos_ids: torch.Tensor) -> torch.Tensor:
        """The hidden-split embedding lookups, gathered: [B, T, h]."""
        return self.gather([p["embed"][ids.to(d)] + p["pos"][pos_ids.to(d)]
                            for p, d in zip(self.parts, self.devs)]).to(self.cfg.dtype)

    def blocks(self, x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        from autorag_research_tpu_torch.models.encoder import masked_attention

        cfg = self.cfg
        b, t, h = x.shape
        hd, tp = cfg.head_dim, len(self.parts)
        for layer in range(cfg.layers):
            pre = f"blocks.{layer}."
            y = self.ln(x, pre + "ln1")
            qkv = self.gather([y.to(d) @ p[pre + "qkv"] for p, d in zip(self.parts, self.devs)])
            q, k, v = (a.reshape(b, t, cfg.heads, hd).transpose(1, 2)
                       for a in torch.split(qkv, h, dim=-1))
            outs = []
            for j, (p, d) in enumerate(zip(self.parts, self.devs)):
                lo, hi = j * h // tp, (j + 1) * h // tp  # this entry's attn_out rows
                h0, h1 = lo // hd, -(-hi // hd)  # the heads that cover them
                ctx = masked_attention(q[:, h0:h1].to(d), k[:, h0:h1].to(d), v[:, h0:h1].to(d),
                                       keep.to(d))
                ctx = ctx.transpose(1, 2).reshape(b, t, (h1 - h0) * hd)[..., lo - h0 * hd: hi - h0 * hd]
                outs.append(ctx @ p[pre + "attn_out"])
            x = x + self.reduce(outs)
            y = self.ln(x, pre + "ln2")
            x = x + self.reduce([
                nn.functional.gelu(y.to(d) @ p[pre + "mlp_in"] + p[pre + "mlp_bias"],
                                   approximate="tanh") @ p[pre + "mlp_out"]
                for p, d in zip(self.parts, self.devs)
            ])
        return self.ln(x, "final_ln")

    def encode(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``RetrievalEncoder.forward`` over the tp group."""
        from autorag_research_tpu_torch.models.encoder import pool_tokens

        ids, mask = ids.to(self.lead), mask.to(self.lead)
        pos_ids = torch.arange(ids.shape[1], device=self.lead)
        x = self.blocks(self.embed(ids, pos_ids), mask[:, None, None, :])
        return pool_tokens(x @ self.rep("out_proj"), mask, self.cfg.multi_vector)

    def decode(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``CausalDecoder.forward``'s logits over the tp group: the tied
        output product is a row-parallel sum over the hidden slices."""
        ids, mask = ids.to(self.lead), mask.to(self.lead, torch.bool)
        t = ids.shape[1]
        pos_ids = torch.clamp(torch.cumsum(mask.to(torch.int32), dim=1) - 1, min=0)
        causal = torch.ones((t, t), dtype=torch.bool, device=self.lead).tril()
        x = self.blocks(self.embed(ids, pos_ids), (causal[None] & mask[:, None, :])[:, None])
        w = x.shape[-1] // len(self.parts)
        return self.reduce([x[..., j * w:(j + 1) * w].to(d) @ p["embed"].T
                            for j, (p, d) in enumerate(zip(self.parts, self.devs))])


def _row_block(sp: ShardedParams, n: int) -> int:
    if n % sp.dp:
        raise ValueError(f"a batch of {n} rows does not split over dp={sp.dp}")
    return n // sp.dp


class _AllGatherRows(torch.autograd.Function):
    """Every process's [b, ...] rows, rank order, with autograd: the
    backward all-reduces the whole (contiguous) gradient and keeps this
    process's rows, so each rank's gradient is summed over the processes.
    ``torch.distributed.nn.functional.all_gather`` has the same backward but
    sends each rank's slice of the gradient as it is, and over gloo a
    non-contiguous slice (the MaxSim loss gives one) arrives wrong."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        ctx.rank, ctx.rows = dist.get_rank(), x.shape[0]
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


def _gather_processes(x: torch.Tensor) -> torch.Tensor:
    """This process's rows followed by every other process's, rank order,
    with autograd (the backward sums each rank's gradient)."""
    return x if world_size() <= 1 else _AllGatherRows.apply(x)


def sharded_contrastive_loss(sp: ShardedParams, batch: dict, temperature: float = 0.05):
    """The bi-encoder's InfoNCE (MaxSim in multi-vector mode) over the whole
    global batch, each dp row encoded by its tp group. Returns (the loss to
    differentiate in this process, the global loss)."""
    from autorag_research_tpu_torch.models.encoder import info_nce_loss, maxsim_info_nce_loss

    b = _row_block(sp, batch["q_ids"].shape[0])
    qs, ds = [], []
    for i in sp.rows:
        row, rows = _Row(sp, i), slice(i * b, (i + 1) * b)
        qs.append(row.encode(batch["q_ids"][rows], batch["q_mask"][rows]))
        ds.append(row.encode(batch["d_ids"][rows], batch["d_mask"][rows]))
    home = sp.mesh.grid[sp.rows[0]][0]
    q = _gather_processes(torch.cat([x.to(home) for x in qs]))
    d = _gather_processes(torch.cat([x.to(home) for x in ds]))
    if sp.config.multi_vector:
        loss = maxsim_info_nce_loss(q, d, batch["q_mask"].to(home), batch["d_mask"].to(home),
                                    temperature)
    else:
        loss = info_nce_loss(q, d, temperature)
    # every process computes the same global loss; the all-gather's backward
    # sums the processes' gradients, so each differentiates a 1/W share
    return loss / world_size(), loss


def sharded_lm_loss(sp: ShardedParams, batch: dict):
    """The decoder's next-token loss over the global batch: over the SFT
    targets (``loss_mask & mask``, ``_sft_loss``) when the batch has a
    ``loss_mask``, else every real position but the last column
    (``lm_train_step``). Returns (this process's share of the loss, the
    global loss)."""
    import torch.distributed as dist

    from autorag_research_tpu_torch.models.decoder import token_nll

    mask = batch["mask"].to(torch.bool)
    if "loss_mask" in batch:
        valid = batch["loss_mask"].to(torch.bool) & mask
    else:
        valid = mask & torch.roll(mask, -1, dims=1)
        valid[:, -1] = False
    b = _row_block(sp, mask.shape[0])
    home = sp.mesh.grid[sp.rows[0]][0]
    den = torch.clamp(valid.sum(), min=1).to(home)
    total = None
    for i in sp.rows:
        row, rows = _Row(sp, i), slice(i * b, (i + 1) * b)
        logits = row.decode(batch["ids"][rows], mask[rows])
        part = (token_nll(logits, batch["ids"][rows].to(row.lead)) * valid[rows].to(row.lead)).sum()
        total = part.to(home) if total is None else total + part.to(home)
    local = total / den
    if world_size() <= 1:
        return local, local
    whole = local.detach().clone()
    dist.all_reduce(whole)
    return local, whole


def sharded_step(sp: ShardedParams, loss_fn, lr: float = 1e-3, optimizer=None) -> torch.Tensor:
    """One step over the mesh: ``loss_fn()`` gives (the loss to
    differentiate here, the global loss); each tensor's gradient is summed
    over the local dp rows (and a replicated tensor's over its copies), then
    over the processes, and every copy takes the same update: ``p - lr * g``,
    or ``optimizer`` (built over ``sp.tensors()``) from ``.grad``. TF32
    stays off, as in the unsharded steps. Returns the global loss
    (detached)."""
    import torch.distributed as dist

    from autorag_research_tpu_torch.ops.dense import _require_exact_f32

    _require_exact_f32()
    entries = list(sp.entries())
    with torch.enable_grad():
        diff, loss = loss_fn()
        grads = torch.autograd.grad(diff, [t for *_, t in entries], allow_unused=True)
    totals: dict[tuple, torch.Tensor] = {}
    for (i, j, name, t), g in zip(entries, grads):
        if g is None:
            continue
        key = (name, None if _tp_dim(sp.specs[name]) is None else j)
        home = sp.mesh.grid[sp.rows[0]][0 if key[1] is None else j]
        totals[key] = g.to(home) if key not in totals else totals[key] + g.to(home)
    if world_size() > 1:
        for g in totals.values():
            dist.all_reduce(g)
    with torch.no_grad():
        for i, j, name, t in entries:
            key = (name, None if _tp_dim(sp.specs[name]) is None else j)
            g = totals.get(key, torch.zeros_like(t))
            if optimizer is None:
                t.sub_(lr * g.to(t.device))
            else:  # each copy's own gradient tensor
                t.grad = g.to(t.device, copy=True)
    if optimizer is not None:
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
    return loss.detach()


def sharded_contrastive_train_step(sp: ShardedParams, batch: dict, lr: float = 1e-3,
                                   temperature: float = 0.05, optimizer=None) -> torch.Tensor:
    """``contrastive_train_step`` over the mesh, in place on ``sp``."""
    return sharded_step(sp, lambda: sharded_contrastive_loss(sp, batch, temperature), lr, optimizer)


def sharded_lm_train_step(sp: ShardedParams, batch: dict, lr: float = 1e-3,
                          optimizer=None) -> torch.Tensor:
    """``lm_train_step`` (no ``loss_mask``) or the SFT step (``_sft_loss``,
    with one) over the mesh, in place on ``sp``."""
    return sharded_step(sp, lambda: sharded_lm_loss(sp, batch), lr, optimizer)


def adamw(sp: ShardedParams, lr: float, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over every local entry (b1 0.9, b2 0.999, eps 1e-8, the
    unsharded trainers' settings): its state is sharded like the
    parameters, and every copy of a tensor takes the same update."""
    return torch.optim.AdamW(sp.tensors(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)

