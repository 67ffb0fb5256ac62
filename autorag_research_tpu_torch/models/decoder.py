"""PyTorch causal decoder LM: the framework's local generation model.

Counterpart of ``autorag_research_tpu/models/decoder.py``: a byte-level
causal transformer with KV-cache greedy / temperature decoding.

- prompts are LEFT-padded to a prompt bucket so that every row decodes at the
  same cache slot; real positions come from ``cumsum(mask) - 1`` so position
  embeddings stay right for short prompts;
- the KV cache is allocated per call ([B, H, max_len, D] a layer), filled by
  the batched prefill and written one slot a step, so concurrent calls from
  the server's batch threads share nothing but the weights;
- the decode loop has a static length, as the JAX ``lax.scan`` has: finished
  rows emit PAD and their flag stays on the device, with no host sync inside
  the loop;
- weights are tied (logits = x @ embed.T);
- ``lm_train_step`` is one next-token cross-entropy SGD step by autograd (the
  JAX step is ``jax.value_and_grad`` over plain XLA);
- ``param_specs`` is the JAX spec tree, ``shard_params`` / ``gather_params``
  place the weights on a ``(dp, tp)`` mesh and back (``parallel/train.py``).

The numerics follow the JAX model: layer norm with eps 1e-6 over the biased
variance (the encoder's ``_layer_norm``), a -1e30 attention mask under a
plain softmax, tanh-approximated GELU, true f32 products (TF32 stays off).
``dtype`` rounds only the embedding sum, as ``x.astype(cfg.dtype)`` does in
the JAX model: the first layer norm runs on those values and its f32 scale
promotes everything after it, so a bf16 setting still gives f32 logits and an
f32 KV cache.

The parameters keep the JAX layout (``[in, out]`` used as ``x @ W``) and
their ``state_dict`` keys are the JAX package's flattened names (``embed``,
``pos``, ``final_ln.scale``, ``blocks.0.qkv``, ...), the keys of the ``.npz``
that ``JaxLM.save`` writes: :func:`decoder_params_from_jax` and
:func:`decoder_params_to_jax` carry weights between the packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from autorag_research_tpu_torch.models.encoder import (
    _Block,
    _layer_norm,
    _LayerNorm,
    encoder_params_to_jax,
    from_jax_params,
    masked_attention,
    sgd_step,
)
from autorag_research_tpu_torch.ops.dense import _require_exact_f32

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_BYTE_OFFSET = 3


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 259  # 256 bytes + pad/bos/eos
    hidden: int = 256
    layers: int = 4
    heads: int = 4
    mlp_ratio: int = 4
    max_len: int = 512  # prompt + generation budget
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def param_specs(config: DecoderConfig) -> dict:
    """Spec tree over ("dp", "tp"), the JAX ``param_specs`` with each
    ``PartitionSpec`` as a tuple: the encoder's, less ``out_proj`` (the
    output product is tied to ``embed``)."""
    block = {
        "ln1": {"scale": (None,), "bias": (None,)},
        "qkv": (None, "tp"),
        "attn_out": ("tp", None),
        "ln2": {"scale": (None,), "bias": (None,)},
        "mlp_in": (None, "tp"),
        "mlp_bias": ("tp",),
        "mlp_out": ("tp", None),
    }
    return {
        "embed": (None, "tp"),
        "pos": (None, "tp"),
        "final_ln": {"scale": (None,), "bias": (None,)},
        "blocks": [block for _ in range(config.layers)],
    }


def shard_params(params, config: DecoderConfig, mesh):
    """``params`` (a ``CausalDecoder`` or its flat state dict) placed on a
    ``(dp, tp)`` mesh by :func:`param_specs` (``parallel/train.py``)."""
    from autorag_research_tpu_torch.parallel.train import shard_tree

    return shard_tree(params, param_specs(config), mesh, config)


def gather_params(sharded) -> dict[str, torch.Tensor]:
    """The flat CPU state dict of a sharded tree (the ``.npz`` keys of
    ``JaxLM.save``)."""
    from autorag_research_tpu_torch.parallel.train import gather_tree

    return gather_tree(sharded)


class CausalDecoder(nn.Module):
    """Causal transformer; ``forward(token_ids, mask)`` with [B, T] inputs
    returns logits [B, T, V]. Random init draws N(0, 0.02) from a
    ``torch.Generator`` seeded with ``seed`` (JAX's ``PRNGKey`` stream
    differs, so parity goes through :func:`decoder_params_from_jax`)."""

    def __init__(self, config: DecoderConfig, device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        if config.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"decoder dtype must be float32 or bfloat16, not {config.dtype}")
        self.config = config
        h, m = config.hidden, config.hidden * config.mlp_ratio
        self.embed = nn.Parameter(torch.empty(config.vocab_size, h))
        self.pos = nn.Parameter(torch.empty(config.max_len, h))
        self.final_ln = _LayerNorm(h)
        self.blocks = nn.ModuleList(_Block(h, m) for _ in range(config.layers))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if not name.endswith(("scale", "bias")):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        self.requires_grad_(False)
        self.to(torch.device(device))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _heads(self, a: torch.Tensor, b: int, t: int) -> torch.Tensor:
        cfg = self.config
        return a.reshape(b, t, cfg.heads, cfg.head_dim).transpose(1, 2)

    def _mlp(self, x: torch.Tensor, blk) -> torch.Tensor:
        y = blk.ln2(x)
        y = nn.functional.gelu(y @ blk.mlp_in + blk.mlp_bias, approximate="tanh")
        return x + y @ blk.mlp_out

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = _layer_norm(x, self.final_ln.scale, self.final_ln.bias)
        return x @ self.embed.T

    # ---------------------------------------------------------------- prefill
    def forward(self, token_ids: torch.Tensor, mask: torch.Tensor, return_cache: bool = False):
        """Batched causal forward. token_ids / mask: [B, T] on the module's
        device. Returns logits [B, T, V]; with ``return_cache=True`` also the
        per-layer (k, v) cache, [B, H, max_len, D] each, its first T slots
        filled, for decode extension."""
        _require_exact_f32()
        cfg = self.config
        b, t = token_ids.shape
        mask = mask.to(torch.bool)
        # real positions for left-padded rows: pads get 0, tokens 0..len-1
        pos_ids = torch.clamp(torch.cumsum(mask.to(torch.int32), dim=1) - 1, min=0)
        x = (self.embed[token_ids] + self.pos[pos_ids]).to(cfg.dtype)
        causal = torch.ones((t, t), dtype=torch.bool, device=token_ids.device).tril()
        keep = (causal[None] & mask[:, None, :])[:, None]  # [B, 1, Tq, Tk]
        cache = []
        for blk in self.blocks:
            y = blk.ln1(x)
            q, k, v = (self._heads(a, b, t) for a in torch.split(y @ blk.qkv, cfg.hidden, dim=-1))
            ctx = masked_attention(q, k, v, keep).transpose(1, 2).reshape(b, t, cfg.hidden)
            x = x + ctx @ blk.attn_out
            x = self._mlp(x, blk)
            if return_cache:
                ck = k.new_zeros((b, cfg.heads, cfg.max_len, cfg.head_dim))
                cv = torch.zeros_like(ck)
                ck[:, :, :t] = k
                cv[:, :, :t] = v
                cache.append((ck, cv))
        logits = self._logits(x)
        return (logits, cache) if return_cache else logits

    # ------------------------------------------------------------ decode step
    def _step(self, cache, token, pos_id, slot: int, kv_mask):
        """One token a row against the cache: token / pos_id [B] on the
        device, ``slot`` the cache index written (the same for every row),
        kv_mask [B, max_len] the valid slots after this write. Writes the
        cache in place and returns logits [B, V]."""
        cfg = self.config
        b = token.shape[0]
        x = (self.embed[token] + self.pos[pos_id]).to(cfg.dtype)[:, None, :]  # [B, 1, H]
        keep = kv_mask[:, None, None, :]
        for blk, (ck, cv) in zip(self.blocks, cache):
            y = blk.ln1(x)
            q, k, v = (self._heads(a, b, 1) for a in torch.split(y @ blk.qkv, cfg.hidden, dim=-1))
            ck[:, :, slot] = k[:, :, 0]
            cv[:, :, slot] = v[:, :, 0]
            ctx = masked_attention(q, ck, cv, keep).transpose(1, 2).reshape(b, 1, cfg.hidden)
            x = x + ctx @ blk.attn_out
            x = self._mlp(x, blk)
        return self._logits(x[:, 0])

    # --------------------------------------------------------------- generate
    @torch.no_grad()
    def generate(
        self,
        token_ids: torch.Tensor,
        mask: torch.Tensor,
        max_new_tokens: int,
        temperature: float = 0.0,
        generator: torch.Generator | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Greedy (or temperature-sampled) decode. token_ids / mask [B, Tp]
        LEFT-padded, on the module's device. Returns (tokens [B,
        max_new_tokens], n_generated [B]) on the device.

        Sampling draws Gumbel noise from ``generator`` (a generator on the
        module's device), so a seeded generator repeats a call; it cannot
        repeat ``jax.random.categorical``'s draws."""
        cfg = self.config
        b, tp = token_ids.shape
        if tp + max_new_tokens > cfg.max_len:
            raise ValueError(
                f"prompt {tp} + max_new_tokens {max_new_tokens} exceeds max_len {cfg.max_len}"
            )
        mask = mask.to(torch.bool)
        logits, cache = self(token_ids, mask, return_cache=True)
        last = logits[:, -1]  # left-padded: the last slot is the real tail
        prompt_len = mask.sum(dim=1, dtype=torch.int64)
        kv_mask = torch.zeros((b, cfg.max_len), dtype=torch.bool, device=token_ids.device)
        kv_mask[:, :tp] = mask
        done = torch.zeros(b, dtype=torch.bool, device=token_ids.device)
        tokens = torch.empty((b, max_new_tokens), dtype=torch.int64, device=token_ids.device)
        pad = torch.full_like(done, PAD_ID, dtype=torch.int64)
        for i in range(max_new_tokens):
            if temperature > 0.0:
                u = torch.rand(last.shape, generator=generator, device=last.device)
                token = torch.argmax(last / temperature - torch.log(-torch.log(u)), dim=-1)
            else:
                token = torch.argmax(last, dim=-1)
            token = torch.where(done, pad, token)
            done = done | (token == EOS_ID)
            tokens[:, i] = token
            kv_mask[:, tp + i] = True
            last = self._step(cache, token, prompt_len + i, tp + i, kv_mask)
        produced = (tokens != PAD_ID) & (tokens != EOS_ID)
        return tokens, produced.sum(dim=1)


def next_token_nll(logits: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of [B, T, V] logits over the positions
    where ``valid`` [B, T] holds; position p predicts ``ids[:, p + 1]``
    (``roll(ids, -1)``, as the JAX losses take it)."""
    nll = token_nll(logits, ids)
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1)


def token_nll(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[B, T] cross-entropy of each position's logits against the next
    token (``roll(ids, -1)`` along the row)."""
    targets = torch.roll(ids.long(), -1, dims=1)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None])[..., 0]


def lm_loss(decoder: CausalDecoder, batch: dict) -> torch.Tensor:
    """Next-token loss over every real position but the last column: valid =
    mask & roll(mask, -1), last column off, as the JAX ``lm_train_step``."""
    mask = batch["mask"].to(torch.bool)
    valid = mask & torch.roll(mask, -1, dims=1)
    valid[:, -1] = False
    return next_token_nll(decoder(batch["ids"], mask), batch["ids"], valid)


def lm_train_step(decoder: CausalDecoder, batch: dict, lr: float = 1e-3) -> torch.Tensor:
    """One next-token cross-entropy SGD step on ``decoder``'s parameters, in
    place. batch: ids / mask [B, T] on the module's device. Returns the loss
    (a 0-d tensor on the device); the JAX step returns ``(new_params,
    loss)``."""
    return sgd_step(decoder, lambda: lm_loss(decoder, batch), lr)


# A ``CausalDecoder`` state dict from the JAX package's flattened parameters
# (the keys of the ``.npz`` that ``JaxLM.save`` writes), and back: the layouts
# and names agree, so the encoder's mappings serve.
decoder_params_from_jax = from_jax_params
decoder_params_to_jax = encoder_params_to_jax


# ------------------------------------------------------------- tokenization
def byte_tokenize(texts: list[str], max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Reversible byte-level tokenizer: LEFT-padded [B, max_len] ids + mask.
    BOS + utf-8 bytes (+3 offset), tail-truncated to keep the most recent
    context (prompts carry the question at the end)."""
    ids = np.full((len(texts), max_len), PAD_ID, dtype=np.int32)
    mask = np.zeros((len(texts), max_len), dtype=np.bool_)
    for i, text in enumerate(texts):
        raw = [BOS_ID] + [b + _BYTE_OFFSET for b in text.encode("utf-8")]
        raw = raw[-max_len:]
        ids[i, max_len - len(raw):] = raw
        mask[i, max_len - len(raw):] = True
    return ids, mask


def byte_detokenize(tokens) -> list[str]:
    """Inverse of :func:`byte_tokenize` for generated token rows."""
    out = []
    for row in np.asarray(tokens):
        data = bytes(int(t) - _BYTE_OFFSET for t in row if int(t) >= _BYTE_OFFSET)
        out.append(data.decode("utf-8", errors="replace"))
    return out
