"""Entry points: the embed-and-retrieve step and the multi-device dry run.

The port's counterpart of the JAX package's ``__graft_entry__.py``:

- :func:`entry` gives the flagship step, the encoder's query embedding
  followed by the exact dense top-k, and its inputs, at the JAX entry's
  shapes;
- :func:`dryrun_multichip` runs one step of everything that shards: the
  contrastive train step on a ``(dp, tp)`` mesh, the dense exact, int8 and
  verified retrieval on a ``(dp, corpus)`` mesh of the same devices with a
  corpus of ``64 n - 3`` rows (the pads exercise the overfetch-then-mask
  merge; the verified search takes the JAX run's segments of 16 on the CPU,
  the seg-stats kernel's 128 on a card), the BM25, MaxSim (exact, verified,
  int8) and IVF index wrappers over that mesh, and the LM SFT step on the
  ``(dp, tp)`` mesh, with the JAX dry run's asserts, and prints its line.
  The data come from the JAX dry run's ``default_rng(0)`` stream, drawn in
  the same order, so the retrieval ids it prints are the JAX dry run's; the
  weights are the port's seeded init, so the losses differ from the JAX
  run's.

The devices are ``n`` cards when there are that many, else the visible cards
round-robin (one card repeated ``n`` times), or the CPU repeated with
``device="cpu"``. Run it as ``python -m autorag_research_tpu_torch.entry
--dryrun N [--device cpu]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def entry(device: str | torch.device = "cuda"):
    """(embed_and_retrieve, (encoder, token_ids, mask, corpus)): a seeded
    encoder (hidden 256, 4 layers, 4 heads, max_len 64, out 128), 16 query
    rows of 64 random tokens and a [4096, 128] corpus, on ``device``."""
    from autorag_research_tpu_torch.models.encoder import EncoderConfig, RetrievalEncoder
    from autorag_research_tpu_torch.ops.dense import dense_topk

    device = torch.device(device)
    config = EncoderConfig(hidden=256, layers=4, heads=4, max_len=64, out_dim=128)
    encoder = RetrievalEncoder(config, device=device, seed=0)
    rng = np.random.default_rng(0)
    corpus = torch.from_numpy(rng.normal(size=(4096, 128)).astype(np.float32)).to(device)
    token_ids = torch.from_numpy(
        rng.integers(1, config.vocab_size, size=(16, 64), dtype=np.int32)).to(device, torch.int64)
    mask = torch.ones((16, 64), dtype=torch.bool, device=device)

    @torch.inference_mode()
    def embed_and_retrieve(encoder, token_ids, mask, corpus):
        return dense_topk(encoder(token_ids, mask), corpus, 10)

    return embed_and_retrieve, (encoder, token_ids, mask, corpus)


def dryrun_devices(n_devices: int, device: str | torch.device = "cuda") -> list[torch.device]:
    """``n_devices`` grid entries: the CPU repeated, or the visible cards
    round-robin (a card repeated when there are fewer than ``n_devices``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_devices
    from autorag_research_tpu_torch.parallel.mesh import visible_devices

    cards = visible_devices() if device.index is None else [device]
    return [cards[i % len(cards)] for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> str:
    """One step of the sharded training and retrieval paths over
    ``n_devices`` grid entries; asserts as the JAX dry run does, prints its
    line and returns it."""
    from autorag_research_tpu_torch.index.ivf import IVFIndex
    from autorag_research_tpu_torch.index.multi_vector import MultiVectorIndex
    from autorag_research_tpu_torch.index.sparse import SparseIndex
    from autorag_research_tpu_torch.models.decoder import CausalDecoder, DecoderConfig
    from autorag_research_tpu_torch.models.decoder import shard_params as lm_shard_params
    from autorag_research_tpu_torch.models.encoder import EncoderConfig, RetrievalEncoder, shard_params
    from autorag_research_tpu_torch.models.lm_trainer import encode_sft
    from autorag_research_tpu_torch.ops.dense import build_verified_sidecar, quantize_int8
    from autorag_research_tpu_torch.parallel.mesh import corpus_mesh, train_mesh
    from autorag_research_tpu_torch.parallel.sharded import (
        shard_corpus,
        shard_corpus_int8,
        shard_corpus_verified,
        sharded_dense_topk,
        sharded_dense_topk_int8,
        sharded_dense_topk_verified,
    )
    from autorag_research_tpu_torch.parallel.train import (
        sharded_contrastive_train_step,
        sharded_lm_train_step,
    )

    devices = dryrun_devices(n_devices, device)
    home = devices[0]

    # ---- 1. training step on a (dp, tp) mesh --------------------------------
    mesh = train_mesh(devices)
    dp = mesh.shape["dp"]
    config = EncoderConfig(vocab_size=1024, hidden=64, layers=2, heads=2, max_len=16, out_dim=32)
    params = shard_params(RetrievalEncoder(config, device="cpu", seed=0), config, mesh)
    rng = np.random.default_rng(0)
    bsz = max(dp * 2, 4)
    batch = {
        "q_ids": torch.from_numpy(rng.integers(1, 1024, size=(bsz, 16), dtype=np.int32)).long(),
        "q_mask": torch.ones((bsz, 16), dtype=torch.bool),
        "d_ids": torch.from_numpy(rng.integers(1, 1024, size=(bsz, 16), dtype=np.int32)).long(),
        "d_mask": torch.ones((bsz, 16), dtype=torch.bool),
    }
    loss = float(sharded_contrastive_train_step(params, batch, lr=1e-3))
    assert np.isfinite(loss), f"train step produced non-finite loss {loss}"

    # ---- 2. sharded retrieval step on a (dp, corpus) mesh -------------------
    rmesh = corpus_mesh(n_corpus=n_devices, devices=devices)
    # NON-divisible corpus size on purpose: the pad rows exercise the
    # overfetch-then-mask path of the sharded merge
    n_total = 64 * n_devices - 3
    corpus_h = rng.normal(size=(n_total, 32)).astype(np.float32)
    corpus = shard_corpus(corpus_h, rmesh)
    queries = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32)).to(home)
    scores, ids = sharded_dense_topk(queries, corpus, 5, n_total, rmesh)
    ids = ids.cpu().numpy()
    assert ids.shape == (4, 5)
    assert int(ids.max()) < n_total  # pads never surface

    # ---- 2b. int8 serving-mode sharded retrieval -----------------------------
    # the JAX dry run quantizes a device array: the port's tensor path is
    # the one that computes what XLA compiles
    cq, cs = quantize_int8(torch.from_numpy(corpus_h))
    s8, i8 = sharded_dense_topk_int8(queries, *shard_corpus_int8(cq, cs, rmesh), 5, n_total, rmesh)
    i8 = i8.cpu().numpy()
    assert i8.shape == (4, 5) and int(i8.max()) < n_total

    # ---- 2b2. verified-exact sharded retrieval --------------------------------
    # the JAX dry run's segments of 16 in sidecar blocks of 64 on the CPU; the
    # card's seg-stats kernel (#1) takes segments of 128 only
    seg = 16 if home.type == "cpu" else 128
    vside = build_verified_sidecar(corpus_h, rep="bf16")
    vc, vlo = shard_corpus_verified(corpus_h, vside, rmesh, block=4 * seg)
    sv, iv = sharded_dense_topk_verified(queries, vc, vlo, vside["nd_max"], vside["r_max"], 5,
                                         n_total, rmesh, m=16, j=2, seg=seg)
    assert np.array_equal(iv.cpu().numpy(), ids), "verified != exact"

    # ---- 2c. the other three sharded engines: BM25, MaxSim, IVF --------------
    vocab = [f"term{i}" for i in range(24)]
    docs_txt = [
        " ".join(rng.choice(vocab, size=int(rng.integers(3, 9))))
        for _ in range(6 * n_devices + 1)
    ]
    sp = SparseIndex([f"s{i}" for i in range(len(docs_txt))], docs_txt, device=home)
    sp.to_device(rmesh)
    bm25_hits = sp.search([" ".join(vocab[:3])], 3)
    assert len(bm25_hits[0]) <= 3

    mv_docs = [
        rng.normal(size=(int(rng.integers(2, 5)), 16)).astype(np.float32)
        for _ in range(5 * n_devices - 1)
    ]
    mv_ids = [f"m{i}" for i in range(len(mv_docs))]
    mv = MultiVectorIndex(mv_ids, mv_docs, device=home).to_device(rmesh)
    mv_q = [rng.normal(size=(3, 16)).astype(np.float32)]
    mv_hits = mv.search(mv_q, 3)
    assert len(mv_hits[0]) == 3
    # verified-exact sharded MaxSim must reproduce the exact sharded ranking
    mvv_hits = MultiVectorIndex(mv_ids, mv_docs, mode="verified", device=home).to_device(
        rmesh).search(mv_q, 3)
    assert [h.doc_id for h in mvv_hits[0]] == [h.doc_id for h in mv_hits[0]], (
        "sharded verified maxsim != exact"
    )
    # int8 serving-mode sharded MaxSim (approximate; per-token quantized)
    mv8_hits = MultiVectorIndex(mv_ids, mv_docs, mode="int8", device=home).to_device(
        rmesh).search(mv_q, 3)
    assert len(mv8_hits[0]) == 3

    ivf_emb = rng.normal(size=(16 * n_devices - 5, 16)).astype(np.float32)
    ivf = IVFIndex([f"v{i}" for i in range(ivf_emb.shape[0])], ivf_emb, n_cells=8, device=home)
    ivf.to_device(rmesh)
    ivf_hits = ivf.search(ivf_emb[:2], 3)
    assert ivf_hits[0][0].doc_id == "v0"  # self-match survives the shard merge

    # ---- 3. LM SFT step sharded over the (dp, tp) mesh ----------------------
    lm_cfg = DecoderConfig(hidden=64, layers=2, heads=2, max_len=64)
    lm_params = lm_shard_params(CausalDecoder(lm_cfg, device="cpu", seed=0), lm_cfg, mesh)
    data = encode_sft([("q: a?", "b")] * bsz, seq_len=32)
    lm_batch = {k: torch.from_numpy(v) for k, v in data.items()}
    lm_batch["ids"] = lm_batch["ids"].long()
    lm_loss = float(sharded_lm_train_step(lm_params, lm_batch, lr=1e-3))
    assert np.isfinite(lm_loss), f"LM step produced non-finite loss {lm_loss}"

    line = (
        f"dryrun_multichip ok: {n_devices} devices, train loss {loss:.4f}, "
        f"lm loss {lm_loss:.4f}, "
        f"sharded dense ids {ids[0].tolist()}, "
        f"int8 ids {i8[0].tolist()}, "
        f"bm25 ids {[h.doc_id for h in bm25_hits[0]]}, "
        f"maxsim ids {[h.doc_id for h in mv_hits[0]]}, "
        f"ivf ids {[h.doc_id for h in ivf_hits[0]]}"
    )
    print(line)
    return line


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dryrun", type=int, required=True, metavar="N",
                        help="grid entries of the dry run")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA GPU found (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    dryrun_multichip(args.dryrun, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
