"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launcher and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, which is
loaded with ``ctypes``. Libraries land in ``_build/`` beside the package,
named by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one is reused. Nothing is built at import time: the first call of
a kernel builds it, and :func:`build_all` builds every kernel at once with
one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNEL_SOURCES = (
    "seg_stats", "dense_topk_stream", "maxsim_v2", "maxsim_v1", "maxsim_v3", "bm25_v2",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str | None:
    """Wait for one nvcc; returns its error report, or None once the library
    is in place."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}"
    os.replace(tmp, out)
    return None


def _build(names) -> dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    started = {n: _start_build(n) for n in names if not _lib_path(n).exists()}
    secs = {n: 0.0 for n in names}
    errors = []
    for n, (proc, tmp, out) in started.items():  # wait for every nvcc started
        err = _finish_build(n, proc, tmp, out)
        secs[n] = time.perf_counter() - t0
        if err:
            errors.append(err)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def build_all(names: tuple[str, ...] = KERNEL_SOURCES) -> dict[str, float]:
    """Compile every kernel not yet built, all ``nvcc`` processes in
    parallel. Returns the seconds each build took (0.0 when cached)."""
    with _LOCK:
        return _build(names)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


def check_launch(rc: int, name: str) -> None:
    """Raise on a launch the runtime refused (the C launcher returns
    ``cudaGetLastError()``)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
