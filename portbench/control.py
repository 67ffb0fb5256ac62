"""The control of a cell's check: the reference in the program's place, one precision down.

    python3 portbench/control.py --workload <cell> --seeds <s1,s2,...>

For each seed it draws the cell's inputs as a run does, picks as many queries
as a run checks, answers them with the reference computed from operands
rounded to TF32 (the precision below the configurations' f32 with TF32 off),
and judges those answers as a run judges the program's. Each seed prints one
JSON line with the three numbers beside the limits; the control must fail
them. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import compare, inputs  # noqa: E402
from portbench.harness import load_cell  # noqa: E402


def control_readings(cell_name: str, seed: int, device: torch.device, overrides: dict | None = None) -> dict:
    """The control's three numbers for one seed, and the limits."""
    _, _, cfg, traffic = load_cell(cell_name, overrides)
    kind = importlib.import_module(f"portbench.kinds.{cfg['kind']}")
    reference = importlib.import_module(f"portbench.reference.{cfg['kind']}")
    corpus = kind.make_corpus(cfg, seed, device)
    pool = kind.make_pool(cfg, traffic, seed, corpus)
    del corpus
    q, k, n = int(traffic["queries_per_call"]), int(traffic["k"]), int(cfg["n_docs"])
    pages = inputs.sample_rng(seed).integers(0, len(pool), size=max(1, math.ceil(int(traffic["check_queries"]) / q)))
    queries = [x for p in pages for x in pool[p]]
    ref = reference.evaluate(cfg, seed, device, queries, k, {}, control=True)
    k_eff = min(k, n)
    readings = compare.judge(ref["control_i"], ref["control_s"].astype(np.float64),
                             np.full(len(queries), k_eff), ref["top_s"], ref["control_at"], n, k_eff)
    readings["checked"] = len(queries)
    return {"readings": readings, "limits": cfg["check"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_readings(args.workload, seed, dev)
        fails = not compare.within(out["readings"], out["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed, "control_fails": fails,
                          "seconds": time.perf_counter() - t0, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
