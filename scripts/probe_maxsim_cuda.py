#!/usr/bin/env python3
"""Time the port's MaxSim kernels at the main path's shapes on one NVIDIA GPU.

    python3 scripts/probe_maxsim_cuda.py [--seed 0] [--reps 5] [--no-pins]

Draws on the card, from the seed, the corpora of ``chip_smoke.py``'s MaxSim
phases: text scale (50,000 documents of 64-128 unit-norm tokens, f32) and
page scale (10,000 documents of 512-1,024 tokens, bf16), d = 128, and 128
queries of 8-32 unit-norm tokens. For #9 (``maxsim_topk_v2``) at k = 10 and
#10 (``maxsim_scores_v2``, the routes' k = 100 and k'+1 = 65) at both scales
it prints the launch plan (``v2_plan_on_card``: rows computed / valid,
tokens walked / valid), the kernel's mean CUDA-event time, the least time
the card could take for the valid tokens' work, and the largest score
difference from the plain version (f32 text: every id equal but within the
proof's rounding term); with pins, at both scales #11 (``maxsim_topk_v1``,
the tile body's bias policy, on its bias built once) and #12
(``maxsim_topk_v3``, the lane policy, on its augmented operands built once)
in turns with #9 at k = 10, each with its plan and its largest score
difference from its plain version. The card's name and power limit come
first, the SM clock and power sampled over the timings last. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PEAK = {"f32": 67e12, "bf16": 989e12}  # H100 SXM data sheet, dense


def corpus(gen, n: int, td: int, d: int, dtype, dev):
    import torch

    lens = torch.randint(td // 2, td + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    docs = torch.empty((n, td, d), dtype=dtype, device=dev)
    for lo in range(0, n, 2048):
        x = torch.randn((min(2048, n - lo), td, d), generator=gen, device=dev)
        x = x / torch.linalg.vector_norm(x, dim=2, keepdim=True)
        live = torch.arange(td, device=dev)[None, :] < lens[lo : lo + 2048, None]
        docs[lo : lo + 2048] = (x * live[:, :, None]).to(dtype)
    return docs, lens


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-pins", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from autorag_research_tpu_torch.ops import maxsim as tm
    from autorag_research_tpu_torch.ops.dense import _require_exact_f32

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    _require_exact_f32()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    b, tq, d = 128, 32, 128
    ql_np = np.random.default_rng(args.seed).integers(8, tq + 1, size=b)
    q = torch.randn((b, tq, d), generator=gen, device=dev)
    q = q / torch.linalg.vector_norm(q, dim=2, keepdim=True)
    q = q * (torch.arange(tq, device=dev)[None, :] < torch.from_numpy(ql_np).to(dev)[:, None])[..., None]
    ql = torch.from_numpy(ql_np)  # host lengths, as MultiVectorIndex passes them

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "200"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    for scale, n, td, dt in (("text", 50_000, 128, torch.float32),
                             ("page", 10_000, 1024, torch.bfloat16)):
        docs, dl = corpus(gen, n, td, d, dt, dev)
        qq = q.to(dt)
        kind = "bf16" if dt == torch.bfloat16 else "f32"
        flops = 2.0 * float(ql_np.sum()) * float(dl.sum()) * d
        bound = flops / PEAK[kind] * 1e3
        for name, k in (("maxsim_topk_v2", 10), ("maxsim_scores_v2", 100 if scale == "text" else 65)):
            fused = name == "maxsim_topk_v2"
            plan = tm.v2_plan_on_card(ql_np, n, td, d, k if fused else 0, dt, dev,
                                      doc_lens=dl.cpu().numpy())
            if fused:
                def call():
                    return tm.maxsim_topk_v2(qq, ql, docs, dl, k)
                s, i = call()
                rs, ri = tm.maxsim_topk_v2_plain(qq, ql, docs, dl, k)
                err = float((s - rs).abs().max())
                mism = int((i != ri).sum())
            else:
                def call():
                    return tm.maxsim_scores_v2(qq, ql, docs, dl)
                err = float((call() - tm.maxsim_scores_v2_plain(qq, ql, docs, dl)).abs().max())
                mism = 0
            ms = timed(call)
            print(f"{name} {kind} {scale} k={k}: {ms:.3f} ms, bound {bound:.3f} ms "
                  f"({bound / ms:.1%}), max|d score| vs plain {err:.3e}, id mismatches {mism}; "
                  f"plan: {plan.note()}", flush=True)
        if not args.no_pins:
            qm, bias = tm._masked_queries(qq, ql), tm.v1_bias(dl, n, td, dev)
            qa, da = tm.maxsim_v3_operands(qq, ql, docs, dl)

            def v2_call():
                return tm.maxsim_topk_v2(qq, ql, docs, dl, 10)
            pins = {
                "maxsim_topk_v1": ("bias", d, lambda: tm._tile_topk("maxsim_topk_v1", qm, ql, docs,
                                                                    bias, 10)),
                "maxsim_topk_v3": ("lane", qa.shape[2], lambda: tm._v3_topk(qa, ql, da, dl, 10)),
            }
            for name, (mask, width, call) in pins.items():
                plan = tm.v2_plan_on_card(ql_np, n, td, width, 10, dt, dev,
                                          doc_lens=dl.cpu().numpy(), mask=mask)
                s, i = call()
                rs, ri = getattr(tm, f"{name}_plain")(qq, ql, docs, dl, 10)
                err = float((s - rs).abs().max())
                pin_ms = [timed(f) for f in (call, v2_call, v2_call, call)]
                print(f"{name} {kind} {scale} k=10: {pin_ms[0]:.3f} / {pin_ms[3]:.3f} ms, #9 "
                      f"beside it {pin_ms[1]:.3f} / {pin_ms[2]:.3f} ms, bound {bound:.3f} ms "
                      f"({bound / pin_ms[0]:.1%}), max|d score| vs plain {err:.3e}, id "
                      f"mismatches {int((i != ri).sum())}; plan: {plan.note()}", flush=True)
        del docs, dl
        torch.cuda.empty_cache()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines() if "," in line]
    mhz = [float(r[0]) for r in rows]
    watts = [float(r[1]) for r in rows]
    if rows:
        print(f"SM clock {min(mhz):.0f}-{max(mhz):.0f} MHz, power {min(watts):.1f}-"
              f"{max(watts):.1f} W over {len(rows)} samples")
    return 0


if __name__ == "__main__":
    sys.exit(main())
