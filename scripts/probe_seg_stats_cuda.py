#!/usr/bin/env python3
"""Check and time the seg-stats kernel (#1, ``csrc/seg_stats.cu``) on one NVIDIA GPU.

    python3 scripts/probe_seg_stats_cuda.py [--seed 0] [--reps 20] [--parent DIR] [--variants]

Builds ``seg_stats.cu`` (and logs what ``nvcc -Xptxas -v`` says of its
registers and spills), then:

1. holds the kernel bitwise against its plain version
   (``ops/dense.py::_seg_stats_plain``) on dyadic data (multiples of 1/8,
   where every order of sums is exact) at small shapes: Q not a multiple of
   64, whole segments past n, exact ties across two quads' columns and
   across the two segments of one item, d = 8, 104 and 768, with the plan's
   clusters of two and with single blocks;
2. draws the dense verified main path's prescreen on the card from the seed
   (1,024 unit-norm bf16 queries x 501,760 unit-norm bf16 rows x 768, n =
   500,000) and checks the kernel against the plain version within the f32
   reduction-order bound (loc1 apart only at near-ties);
3. times, by CUDA events over ``--reps`` launches each, in turns: the kernel
   as planned (clusters of two sharing each corpus slice by TMA multicast),
   the same kernel in single blocks, and ``torch.mm(q, c.T, out_dtype=f32)``
   alone, at d = 768 and at d = 104 (the first 100 dimensions, zero-padded);
   with ``--parent DIR`` (a checkout of an earlier tree) also that tree's
   ``seg_stats.cu``, built beside this one, called with its own arguments;
4. with ``--variants``, the opcode counts of each kernel's machine code
   (``cuobjdump -sass``) and the times of source variants built by text
   substitution in a temporary directory (one ``nvcc`` each, all started
   together): ``no_epilogue`` (the accumulators summed into a sink, no
   reduction, no stores), ``no_mma`` (staging and epilogue, no ``wgmma``), ``hold_one`` (each slot
   released as soon as its own ``wgmma`` group completes, not one slice
   later) and ``bk32_s<n>`` (slices of 32 k-columns, 64-byte rows under the
   64-byte swizzle, substituted in the build's copies of ``tma.cuh`` and
   ``wgmma.cuh``, in a ring of n slots), each timed as planned and in
   single blocks at d = 768 and 104 and, where it keeps the arithmetic, held
   bitwise against the base on the main path's data.

Each time is printed beside the least time the card could take (bf16
operations at 989 TFLOP/s or bytes at 3.35 TB/s, the larger) and the card's
name and power limit; the SM clock and power are sampled over the timings.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PEAK_BF16, PEAK_HBM = 989e12, 3.35e12  # H100 SXM data sheet, dense
Q, ROWS, N_VALID, DIM, ODD_DIM = 1024, 501_760, 500_000, 768, 100


def bound_ms(q: int, rows: int, d: int) -> float:
    s = -(-rows // 128)
    return max(2.0 * q * rows * d / PEAK_BF16, ((q + rows) * d * 2 + 3 * q * s * 4) / PEAK_HBM) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", default=None, help="a checkout whose seg_stats.cu is timed too")
    ap.add_argument("--variants", action="store_true", help="time source variants and read SASS")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from autorag_research_tpu_torch.ops import cuda_build
    from autorag_research_tpu_torch.ops import dense as td

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp()
    ptxas = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{tmp}/ptxas.so",
         str(cuda_build.CSRC_DIR / "seg_stats.cu")], capture_output=True, text=True)
    if ptxas.returncode:
        print(f"FAIL: nvcc -Xptxas -v:\n{ptxas.stdout}{ptxas.stderr}", file=sys.stderr)
        return 1
    for line in (ptxas.stdout + ptxas.stderr).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    lib = cuda_build.load("seg_stats")
    launch = lib.seg_stats_bf16_launch
    launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    plan = td._seg_plan_on_card(Q, ROWS, DIM, dev)
    print(f"plan @ Q={Q} x rows={ROWS} x d={DIM}: {plan}", flush=True)

    def run(q, c, n, cluster=None):
        """(max1, loc1, max2) of one launch: the plan's, or single blocks."""
        rows, d = c.shape
        p = td._seg_plan_on_card(q.shape[0], rows, d, dev)
        cl, grid = (p.cluster, p.grid) if cluster is None else (1, min(p.slots, p.q_tiles * p.c_tiles))
        s = -(-rows // 128)
        out = (torch.empty((q.shape[0], s), device=dev), torch.empty((q.shape[0], s), dtype=torch.int32, device=dev),
               torch.empty((q.shape[0], s), device=dev))
        rc = launch(q.data_ptr(), c.data_ptr(), *(t.data_ptr() for t in out), q.shape[0], rows, d, n,
                    s, cl, grid, p.smem_bytes, torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(rc, "seg_stats_bf16")
        return out

    # ---- 1. bitwise on dyadic data
    rng = np.random.default_rng(args.seed)
    cases = [(200, 3000, 2950, 96), (256, 2048, 1500, 96), (77, 1000, 700, 8), (256, 777, 777, 104),
             (130, 5000, 4000, 768), (64, 300, 0, 16)]
    for qn, rows, n, d in cases:
        qv = torch.from_numpy((rng.integers(-8, 9, size=(qn, d)) / 8.0).astype(np.float32))
        cv = torch.from_numpy((rng.integers(-8, 9, size=(rows, d)) / 8.0).astype(np.float32))
        cv[40:44] = cv[7]  # ties inside a segment and across quads' columns
        cv[min(rows - 1, 200)] = cv[10]  # ties across the two segments of one item
        q16, c16 = qv.to(dev, torch.bfloat16), cv.to(dev, torch.bfloat16)
        ref = td._seg_stats_plain((q16, None), c16, None, n, 128)
        for cl in (None, 1):
            out = run(q16, c16, n, cl)
            torch.cuda.synchronize()
            same = all(bool(torch.equal(g, r)) for g, r in zip(out, ref))
            print(f"dyadic Q={qn} rows={rows} n={n} d={d} {'plan' if cl is None else 'single blocks'}: "
                  f"bitwise {same}", flush=True)
            if not same:
                print("FAIL: the kernel differs from its plain version on dyadic data", file=sys.stderr)
                return 1

    # ---- 2. the main path's shapes
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    c = torch.empty((ROWS, DIM), dtype=torch.bfloat16, device=dev)
    for lo in range(0, ROWS, 65536):
        x = torch.randn((min(65536, ROWS - lo), DIM), generator=gen, device=dev)
        c[lo : lo + 65536] = (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(torch.bfloat16)
    c[N_VALID:] = 0
    x = torch.randn((Q, DIM), generator=gen, device=dev)
    q = (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(torch.bfloat16)
    got = td.seg_stats_bf16(q, c, N_VALID)
    ref = td._seg_stats_plain((q, None), c, None, N_VALID, 128)
    tol = DIM * 2.0**-23 * torch.linalg.vector_norm(q.float(), dim=1, keepdim=True) * \
        torch.linalg.vector_norm(c.float(), dim=1).max()
    err = max(float((got[0] - ref[0]).abs().max()), float((got[2] - ref[2]).abs().max()))
    within = bool(((got[0] - ref[0]).abs() <= tol).all() and ((got[2] - ref[2]).abs() <= tol).all())
    loc_bad = int(((got[1] != ref[1]) & ((ref[0] - ref[2]) > 2 * tol)).sum())
    print(f"main shape vs plain: max|d max1,max2| {err:.3e} (within the bound: {within}), loc1 "
          f"mismatches {int((got[1] != ref[1]).sum())}, not near-ties {loc_bad}", flush=True)
    if not within or loc_bad:
        print("FAIL: the kernel disagrees with its plain version", file=sys.stderr)
        return 1
    del got, ref

    # ---- 3. times, in turns
    parent = None
    if args.parent:
        src = Path(args.parent) / "autorag_research_tpu_torch" / "csrc" / "seg_stats.cu"
        out = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", f"{tmp}/parent.so",
                              str(src)], capture_output=True, text=True)
        if out.returncode:
            print(f"FAIL: nvcc of the parent's seg_stats.cu:\n{out.stdout}{out.stderr}", file=sys.stderr)
            return 1
        parent = ctypes.CDLL(f"{tmp}/parent.so").seg_stats_bf16_launch
        parent.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        parent.restype = ctypes.c_int

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

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    for d in (DIM, ODD_DIM):
        qd = q if d == DIM else td.pad_width(q[:, :d], 104).contiguous()
        cd = c if d == DIM else td.pad_width(c[:, :d], 104).contiguous()
        s = -(-ROWS // 128)
        outs = [torch.empty((Q, s), device=dev), torch.empty((Q, s), dtype=torch.int32, device=dev),
                torch.empty((Q, s), device=dev)]
        fns = {
            "kernel (plan)": lambda: run(qd, cd, N_VALID),
            "kernel (single blocks)": lambda: run(qd, cd, N_VALID, 1),
            "mm(q, c.T, out_dtype=f32)": lambda: torch.mm(qd, cd.T, out_dtype=torch.float32),
        }
        if parent is not None:
            fns["parent kernel"] = lambda: cuda_build.check_launch(parent(
                qd.data_ptr(), cd.data_ptr(), *(t.data_ptr() for t in outs), Q, ROWS, cd.shape[1],
                N_VALID, s, torch.cuda.current_stream().cuda_stream), "parent")
        times: dict = {name: [] for name in fns}
        order = list(fns) + list(reversed(fns))
        for name in order:
            times[name].append(timed(fns[name]))
        b = bound_ms(Q, ROWS, cd.shape[1])
        print(f"d={d} (stored {cd.shape[1]}), Q={Q} x rows={ROWS}, bound {b:.3f} ms (operations): " +
              "; ".join(f"{name} {' / '.join(f'{t:.3f}' for t in ts)} ms ({b / min(ts):.1%} of the bound)"
                        for name, ts in times.items()), flush=True)
    smi.terminate()
    rows = [tuple(float(v) for v in line.split(",")[:2]) for line in smi.communicate()[0].splitlines()
            if line.count(",") >= 1 and "N/A" not in line]
    if rows:
        print(f"over the timings: SM clock {min(r[0] for r in rows):.0f}-{max(r[0] for r in rows):.0f} MHz, "
              f"power {min(r[1] for r in rows):.1f}-{max(r[1] for r in rows):.1f} W ({len(rows)} samples)")
    if args.variants:
        variants(args, tmp, cuda_build, td, q, c, dev, timed)
    print(card)
    return 0


EPILOGUE = """    Top2 res[4];
    if (c0 + BN <= a.n) {
      reduce<false>(acc, a, c0, t, res);
    } else {
      reduce<true>(acc, a, c0, t, res);
    }
    store(a, res, q0 + r0, c0 / SEG, t);
"""
SINK = """    {
      float sink = 0.f;
      for (int i = 0; i < 128; ++i) sink += acc[i];
      if (sink == 1234.5f) a.max1[0] = sink;
    }
"""
ACC = "  float acc[128];\n"
MMA = """        wgmma_m64n256k16(acc, sw128_desc(As + kk * 32), sw128_desc(Bs + kk * 32),
                         kb > 0 || kk > 0);
"""
RING = "constexpr int BK = 64;"
STAGES = "constexpr int STAGES = 4;"
HOLD = """      if (prev >= 0) {
        // the previous slice's group has completed: its slot is free
        asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
        release(prev);
      }
"""


# the 128-byte swizzle of the shared headers, and its 64-byte form for slices of 32
SWIZZLE_64 = {
    "tma.cuh": ("CU_TENSOR_MAP_SWIZZLE_128B", "CU_TENSOR_MAP_SWIZZLE_64B"),
    "wgmma.cuh": ("((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62)",
                  "((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62)"),
}


def ring(src: str, bk: int, stages: int) -> str:
    """Slices of bk k-columns (rows of 2 bk bytes) in a ring of ``stages``; for
    bk = 32 the build's copies of the headers swizzle 64 bytes (SWIZZLE_64)."""
    return src.replace(RING, f"constexpr int BK = {bk};").replace(STAGES, f"constexpr int STAGES = {stages};")


def hold_one(src: str) -> str:
    """Each slot released as soon as its own wgmma group completes."""
    src = src.replace(HOLD, '      asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");\n'
                            "      release(slot);\n")
    return src.replace("      prev = slot;\n", "").replace("\n    release(prev);\n", "\n")


def variants(args, tmp, cuda_build, td, q, c, dev, timed) -> None:
    """Build the source variants in parallel, log the base kernel's opcode
    counts, and time every variant as planned and in single blocks."""
    import collections
    import os
    import shutil

    import torch

    src = (cuda_build.CSRC_DIR / "seg_stats.cu").read_text()
    for marker in (EPILOGUE, MMA, ACC, RING, STAGES, HOLD, "\n    release(prev);\n"):
        assert marker in src, marker
    no_mma = src.replace(MMA, "").replace(ACC, "  float acc[128] = {};\n")
    texts = {  # name: seg_stats.cu
        "base": src,
        "no_epilogue": src.replace(EPILOGUE, SINK),
        "no_mma": no_mma,
        "hold_one": hold_one(src),
        "bk32_s8": ring(src, 32, 8),
        "bk32_s9": ring(src, 32, 9),
        "bk32_s9_no_mma": ring(no_mma, 32, 9),
        "bk32_s9_hold_one": ring(hold_one(src), 32, 9),
    }
    procs = {}
    for name, text in texts.items():
        d = Path(tmp) / name
        d.mkdir()
        for h in cuda_build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(h, d / h.name)
            if name.startswith("bk32") and h.name in SWIZZLE_64:
                before, after = SWIZZLE_64[h.name]
                header = h.read_text()
                assert before in header, (h.name, before)
                (d / h.name).write_text(header.replace(before, after))
        (d / "seg_stats.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "seg_stats.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"variant {name} failed to build:\n{log}", flush=True)
            continue
        lib = ctypes.CDLL(str(Path(tmp) / name / "lib.so"))
        fn = lib.seg_stats_bf16_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.seg_stats_smem_bytes.argtypes = []
        lib.seg_stats_smem_bytes.restype = ctypes.c_int
        libs[name] = (fn, lib.seg_stats_smem_bytes())
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    if os.path.exists(tool):
        sass = subprocess.run([tool, "-sass", str(Path(tmp) / "base" / "lib.so")],
                              capture_output=True, text=True).stdout
        fn_name, counts = None, {}
        for line in sass.splitlines():
            if "Function :" in line:
                fn_name = "cluster" if "ILi2E" in line else "single" if "ILi1E" in line else None
                if fn_name:
                    counts[fn_name] = collections.Counter()
            elif fn_name and "/*" in line and ";" in line:
                op = line.split("*/", 1)[-1].strip().split(" ")[0].split(".")[0]
                if op.startswith("@"):
                    op = line.split("*/", 1)[-1].strip().split(" ")[1].split(".")[0]
                counts[fn_name][op] += 1
        for fn_name, cnt in counts.items():
            print(f"SASS {fn_name}: {sum(cnt.values())} instructions; " +
                  ", ".join(f"{op} {n}" for op, n in cnt.most_common(18)), flush=True)
    for d in (768, 100):
        qd = q if d == 768 else td.pad_width(q[:, :d], 104).contiguous()
        cd = c if d == 768 else td.pad_width(c[:, :d], 104).contiguous()
        rows, dd = cd.shape
        s_cnt = -(-rows // 128)
        p = td._seg_plan_on_card(qd.shape[0], rows, dd, dev)
        outs = [torch.empty((qd.shape[0], s_cnt), device=dev) for _ in range(3)]
        line, ref = [], None
        for name, (fn, smem) in libs.items():
            for cl, grid in ((p.cluster, p.grid), (1, min(p.slots, p.q_tiles * p.c_tiles))):
                def go(fn=fn, cl=cl, grid=grid, smem=smem):
                    cuda_build.check_launch(fn(
                        qd.data_ptr(), cd.data_ptr(), *(t.data_ptr() for t in outs), qd.shape[0],
                        rows, dd, 500_000, s_cnt, cl, grid, smem,
                        torch.cuda.current_stream().cuda_stream), name)
                same = ""
                if "no_" not in name:
                    for t in outs:
                        t.zero_()
                    go()
                    if ref is None:
                        ref = [t.clone() for t in outs]
                    same = f", bitwise the base: {all(torch.equal(a, b) for a, b in zip(outs, ref))}"
                line.append(f"{name} cluster {cl}: {timed(go):.3f} / {timed(go):.3f} ms{same}")
        print(f"variants d={d}: " + "; ".join(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
