#!/usr/bin/env python3
"""Check training over a ``(dp, tp)`` mesh (``parallel/train.py``) across the cards of one machine.

    python3 probe_mesh_cards.py [--cpu]

Needs 4 NVIDIA GPUs (``--cpu``: a small rehearsal on 4 CPU entries and
gloo). Builds the kernels, then, against the unsharded step on one card
(the same seeded weights and batch, SGD at lr 1e-3), with the ms a step of
each:

1. one process over the 4 cards: ``entry.dryrun_multichip(4)`` (its line
   printed), then ``contrastive_train_step`` at ``chip_smoke.ENCODER``
   (hidden 512, 6 layers, 8 heads, seq 128, out 768), B = 32, and the SFT
   step at ``chip_smoke.GEN_LM`` (hidden 512, 8 layers), B = 16, seq 256,
   over ``train_mesh()`` (dp 2, tp 2: each tp group on two cards) and over
   dp 4, tp 1;
2. 4 processes of one card each, joined by NCCL
   (``initialize_distributed``, ``global_train_mesh(tp=1)``: dp across the
   processes, the embeddings all-gathered and the gradients all-reduced):
   the same two steps; rank 0's loss and gathered weights against one
   card's.

Losses within 1e-5 relative, weights within 1e-5. Prints one JSON object a
part, then ``ok``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_CARDS, B, LM_B, LM_SEQ, LR = 4, 32, 16, 256, 1e-3
LOSS_TOL, W_TOL = 1e-5, 1e-5


def widths(cpu: bool) -> tuple[dict, dict]:
    import chip_smoke as cs

    if cpu:
        return (dict(hidden=64, layers=2, heads=4, max_len=32, out_dim=48, vocab_size=2048),
                dict(hidden=64, layers=2, heads=4, max_len=128))
    return cs.ENCODER, cs.GEN_LM


def batches(enc: dict, cpu: bool) -> tuple[dict, dict]:
    """The seeded contrastive and SFT batches as numpy arrays."""
    import chip_smoke as cs
    from autorag_research_tpu_torch.models.encoder import hash_tokenize
    from autorag_research_tpu_torch.models.lm_trainer import encode_sft

    rng = np.random.default_rng(23)
    words = [f"w{i}" for i in range(20000)]
    texts = cs.make_texts(rng, words, 2 * B, 8, 121)
    q_ids, q_mask = hash_tokenize(texts[:B], enc["vocab_size"], enc["max_len"])
    d_ids, d_mask = hash_tokenize(texts[B:], enc["vocab_size"], enc["max_len"])
    seq = 64 if cpu else LM_SEQ
    examples = [(" ".join(rng.choice(words, size=int(rng.integers(20, 60)))),
                 " ".join(rng.choice(words, size=int(rng.integers(1, 6))))) for _ in range(LM_B)]
    return ({"q_ids": q_ids.astype(np.int64), "q_mask": q_mask, "d_ids": d_ids.astype(np.int64),
             "d_mask": d_mask}, {k: v.astype(np.int64) if k == "ids" else v
                                 for k, v in encode_sft(examples, seq).items()})


def on(arrays: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def sync(cpu: bool) -> None:
    if not cpu:
        torch.cuda.synchronize()


def ms(fn, cpu: bool, reps: int = 3) -> float:
    fn()
    sync(cpu)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(cpu)
    return (time.perf_counter() - t0) * 1e3 / reps


def models(enc: dict, dec: dict, dev):
    from autorag_research_tpu_torch.models.decoder import CausalDecoder, DecoderConfig
    from autorag_research_tpu_torch.models.encoder import EncoderConfig, RetrievalEncoder

    return (RetrievalEncoder(EncoderConfig(**enc), device=dev, seed=0),
            CausalDecoder(DecoderConfig(**dec), device=dev, seed=0))


def sharded_steps(mesh, enc: dict, dec: dict, c_arrays: dict, lm_arrays: dict, home, cpu: bool):
    """One sharded step of each model on ``mesh``: {name: (loss, gathered
    weights, ms a step)}."""
    from autorag_research_tpu_torch.models import decoder as tdec
    from autorag_research_tpu_torch.models import encoder as tenc
    from autorag_research_tpu_torch.parallel import train as pt

    e, d = models(enc, dec, "cpu")
    out = {}
    for name, mod, step, arrays in (
        ("contrastive", tenc, pt.sharded_contrastive_train_step, c_arrays),
        ("sft", tdec, pt.sharded_lm_train_step, lm_arrays),
    ):
        model = e if name == "contrastive" else d
        sp = mod.shard_params(model, model.config, mesh)
        batch = on(arrays, home)
        loss = float(step(sp, batch, lr=LR))
        weights = pt.gather_tree(sp)
        out[name] = (loss, weights, ms(lambda: step(sp, batch, lr=LR), cpu))
        del sp
    return out


def unsharded_steps(enc: dict, dec: dict, c_arrays: dict, lm_arrays: dict, dev, cpu: bool):
    from autorag_research_tpu_torch.models.encoder import contrastive_train_step, sgd_step
    from autorag_research_tpu_torch.models.lm_trainer import _sft_loss

    e, d = models(enc, dec, dev)
    cb, lb = on(c_arrays, dev), on(lm_arrays, dev)
    out = {"contrastive": float(contrastive_train_step(e, cb, lr=LR)),
           "sft": float(sgd_step(d, lambda: _sft_loss(d, lb), LR))}
    weights = {"contrastive": {k: v.cpu() for k, v in e.state_dict().items()},
               "sft": {k: v.cpu() for k, v in d.state_dict().items()}}
    e2, d2 = models(enc, dec, dev)
    times = {"contrastive": ms(lambda: contrastive_train_step(e2, cb, lr=LR), cpu),
             "sft": ms(lambda: sgd_step(d2, lambda: _sft_loss(d2, lb), LR), cpu)}
    return out, weights, times


def compare(got: dict, ref_loss: dict, ref_w: dict) -> dict:
    res = {}
    for name, (loss, weights, step_ms) in got.items():
        err = max(float((weights[k] - ref_w[name][k]).abs().max()) for k in ref_w[name])
        res[name] = {"loss": loss, "ref_loss": ref_loss[name], "max_abs_d_weight": err,
                     "ms": step_ms,
                     "ok": abs(loss - ref_loss[name]) <= LOSS_TOL * abs(ref_loss[name])
                     and err <= W_TOL}
    return res


def worker(rank: int, port: int, data: str, out: str, cpu: bool) -> None:
    """One process of the NCCL (gloo with ``--cpu``) group: one dp row each."""
    from autorag_research_tpu_torch.parallel.distributed import (
        global_train_mesh,
        initialize_distributed,
    )

    if cpu:
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)  # NCCL binds the current card
        dev = torch.device("cuda", rank)
    if not initialize_distributed(f"tcp://127.0.0.1:{port}", N_CARDS, rank,
                                  backend="gloo" if cpu else None):
        raise SystemExit("no process group")
    mesh = global_train_mesh(tp=1, local_devices=[dev])
    d = np.load(data)
    enc, dec = widths(cpu)
    c_arrays = {k[2:]: d[k] for k in d.files if k.startswith("c_")}
    lm_arrays = {k[3:]: d[k] for k in d.files if k.startswith("lm_")}
    got = sharded_steps(mesh, enc, dec, c_arrays, lm_arrays, dev, cpu)
    if rank == 0:
        torch.save({"ranks": mesh.ranks, **{n: (v[0], v[1], v[2]) for n, v in got.items()}}, out)
    import torch.distributed as dist

    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU at small widths")
    ap.add_argument("--worker", nargs=4, metavar=("RANK", "PORT", "DATA", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        rank, port, data, out = args.worker
        worker(int(rank), int(port), data, out, args.cpu)
        return 0

    from autorag_research_tpu_torch.entry import dryrun_multichip
    from autorag_research_tpu_torch.parallel.mesh import train_mesh

    cpu = args.cpu
    if not cpu:
        if torch.cuda.device_count() < N_CARDS:
            print(f"FAIL: needs {N_CARDS} CUDA devices", file=sys.stderr)
            return 1
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
        print(card.replace("\n", "; "), flush=True)
        from autorag_research_tpu_torch import native
        from autorag_research_tpu_torch.ops import cuda_build

        native.build()
        print("build", json.dumps(cuda_build.build_all(("seg_stats", "dense_topk_stream", "bm25_v2",
                                                         "maxsim_v2"))), flush=True)
    devices = ([torch.device("cpu")] * N_CARDS if cpu
               else [torch.device("cuda", i) for i in range(N_CARDS)])
    dev0 = devices[0]
    enc, dec = widths(cpu)
    c_arrays, lm_arrays = batches(enc, cpu)

    # ---- 1. one process over the 4 cards -------------------------------------
    t0 = time.perf_counter()
    line = dryrun_multichip(N_CARDS, "cpu" if cpu else "cuda")
    report: dict = {"dryrun_s": time.perf_counter() - t0, "dryrun_ok": line.startswith(
        f"dryrun_multichip ok: {N_CARDS} devices")}
    ref_loss, ref_w, ref_ms = unsharded_steps(enc, dec, c_arrays, lm_arrays, dev0, cpu)
    report["one_card_ms"] = ref_ms
    for tp in (2, 1):
        mesh = train_mesh(devices, tp=tp)
        got = sharded_steps(mesh, enc, dec, c_arrays, lm_arrays, dev0, cpu)
        report[f"dp{N_CARDS // tp}_tp{tp}"] = compare(got, ref_loss, ref_w)
    print(json.dumps(report), flush=True)

    # ---- 2. one process a card, NCCL ---------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "data.npz"), os.path.join(tmp, "rank0.pt")
        np.savez(data, **{f"c_{k}": v for k, v in c_arrays.items()},
                 **{f"lm_{k}": v for k, v in lm_arrays.items()})
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cmd = [sys.executable, os.path.abspath(__file__), *(["--cpu"] if cpu else []), "--worker"]
        procs = [subprocess.Popen([*cmd, str(r), str(port), data, out], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(N_CARDS)]
        try:
            for p in procs:
                log, _ = p.communicate(timeout=300)
                if p.returncode:
                    print(log[-3000:], file=sys.stderr)
                    return 1
        finally:
            for p in procs:
                p.kill()
        res = torch.load(out, weights_only=False)
    across = compare({n: res[n] for n in ("contrastive", "sft")}, ref_loss, ref_w)
    print(json.dumps({"ranks": res["ranks"], "processes": across}), flush=True)
    ok_all = report["dryrun_ok"] and all(
        r["ok"] for part in (report["dp2_tp2"], report["dp4_tp1"], across) for r in part.values())
    print("ok" if ok_all else "FAIL: sharded steps differ from one card's", flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
