#!/usr/bin/env python3
"""Split the time of the port's streaming dense kernel on one NVIDIA GPU.

    python3 scripts/probe_dense_stream_cuda.py [--q 2048] [--n 500000] [--d 768] [--k 10]

``ncu`` is not at hand where the card is, so this script takes the kernel
apart by building variants of ``autorag_research_tpu_torch/csrc/
dense_topk_stream.cu`` through text substitution in a temporary directory
(one ``nvcc`` each, all started together):

- ``base``: the source as it is;
- ``no_epilogue``: the epilogue compiled out (the accumulators go to a sink),
  so its time is the mainloop's and the staging's;
- ``half_loads``: the f32 fragments loaded on every other k-quad only (the
  sums are wrong; the time is that of half the shared loads);
- ``flush_<m>``: a list in shared memory merges its buffer at m candidates.

Each f32 launch runs at the plan the wrapper takes (``dense_stream_plan`` on
this card)
on seeded unit-norm data and is timed by CUDA events; the variants that
keep the arithmetic have their ids held against the plain version. Prints
the card's name and power limit first. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

EPILOGUE = "    // ---- epilogue: threshold test in registers, buffered bulk merges\n"
SINK = """    {
      float sink = 0.f;
      for (int i = 0; i < 64; ++i) sink += acc[i];
      if (sink == 1234.5f) out_s[tid] = sink;
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      continue;
    }
"""
LOADS = """      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(As + 16 * i * BK32 + ca);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(Bs + 16 * j * BK32 + cb);
"""
KQ_LOOP = """#pragma unroll
    for (int kq = 0; kq < BK32 / 4; ++kq) {
"""
FLUSH = "constexpr int FLUSH_SHARED = 8,"


def variants(src: str) -> dict[str, str]:
    for anchor in (EPILOGUE, LOADS, KQ_LOOP, FLUSH):
        if anchor not in src:
            raise SystemExit(f"the kernel source no longer holds the anchor {anchor!r}")
    half = src.replace(LOADS, "      if (!(kq & 1)) {\n" + LOADS.replace("      float4 a[8], b[8];\n", "")
                       + "      }\n").replace(KQ_LOOP, "    float4 a[8], b[8];\n" + KQ_LOOP)
    out = {"base": src, "no_epilogue": src.replace(EPILOGUE, SINK + EPILOGUE), "half_loads": half}
    for m in (1, 4, 16):
        out[f"flush_{m}"] = src.replace(FLUSH, f"constexpr int FLUSH_SHARED = {m},")
    return out


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--q", type=int, default=2048)
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: this probe measures the GPU kernel", file=sys.stderr)
        return 1
    from autorag_research_tpu_torch.ops import cuda_build
    from autorag_research_tpu_torch.ops import dense as td

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    src = (cuda_build.CSRC_DIR / "dense_topk_stream.cu").read_text()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for header in cuda_build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, tmp)
        procs = {}
        for name, text in variants(src).items():
            (Path(tmp) / f"{name}.cu").write_text(text)
            procs[name] = subprocess.Popen(
                [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", f"{tmp}/{name}.so",
                 f"{tmp}/{name}.cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"FAIL: nvcc of variant {name}:\n{log}", file=sys.stderr)
                return 1
            libs[name] = ctypes.CDLL(f"{tmp}/{name}.so")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    c = torch.randn((args.n, args.d), device=dev, generator=gen)
    c /= torch.linalg.vector_norm(c, dim=1, keepdim=True)
    q = torch.randn((args.q, args.d), device=dev, generator=gen)
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    td._require_exact_f32()
    q, c = td._kernel_operands(q, c, ("queries", "corpus"), (torch.float32,))
    d8, k = q.shape[1], min(args.k, args.n)
    plan = td._stream_plan_on_card(args.q, args.n, d8, k, torch.float32, dev)
    print(f"plan: {plan}", flush=True)
    ref_s, ref_i = td.dense_topk_plain(q, c, k)
    out_s = torch.empty((args.q, plan.parts, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((args.q, plan.parts, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flops = 2.0 * args.q * args.n * args.d
    for name, lib in libs.items():
        fn = lib.dense_topk_stream_f32_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call():
            rc = fn(q.data_ptr(), c.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), args.q,
                    args.n, d8, k, plan.part_rows, plan.parts, int(plan.lists == "shared"),
                    plan.smem_bytes, stream)
            cuda_build.check_launch(rc, f"dense_topk_stream ({name})")

        ms = cuda_ms(torch, call, args.reps)
        check = ""
        if name == "base" or name.startswith("flush_"):
            s, i = td.merge_topk(out_s, out_i, k)
            check = f", ids mismatches {int((i != ref_i).sum())}/{i.numel()}"
        print(f"{name}: {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s){check}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
