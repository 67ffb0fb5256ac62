"""ctypes bindings for the native (C++) BM25 index builders.

Counterpart of ``autorag_research_tpu/native.py`` over the port's own copy of
the source, ``csrc/bm25_native.cpp``: the sparse build (tokenization, document
frequencies, lengths and the slot-padded BM25 weights) and the pruned
search's host aux builders (term -> tile lists, Bloom tile filters).

The library is compiled on first use with ``g++ -O3 -std=c++17 -fPIC
-shared`` into ``_build/`` beside the package, named by a hash of the source
and the flags (as ``ops/cuda_build.py`` names the kernels), and loaded with
``ctypes``; nothing is built at import time. There is no fallback: a missing
compiler, a failed build or a failed load raises ``RuntimeError`` with the
compiler's message. Which corpora take the native sparse build is the index's
rule (``index/sparse.py``), a rule about results, not about availability.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent
SOURCE = PKG_DIR / "csrc" / "bm25_native.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
BUILD_TIMEOUT_S = 300

_LOCK = threading.Lock()
_lib: ctypes.CDLL | None = None


def compiler_path() -> str:
    """The C++ compiler: ``$CXX``, else ``g++`` on the PATH."""
    name = os.environ.get("CXX", "g++")
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"native BM25 builder: C++ compiler {name!r} not found")
    return path


def lib_path() -> Path:
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"bm25_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source's build exists; returns its
    path. Raises ``RuntimeError`` naming the compiler's output on failure."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler_path(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native BM25 builder: {' '.join(cmd)} failed: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native BM25 builder: {' '.join(cmd)} exited {proc.returncode}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.bm25_create.restype = vp
    lib.bm25_create.argtypes = [ctypes.c_double, ctypes.c_double]
    lib.bm25_add_docs.argtypes = [vp, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i64), i64]
    lib.bm25_finalize.argtypes = [vp]
    for name, restype in (("bm25_n_docs", i64), ("bm25_n_terms", i64), ("bm25_slots", i32),
                          ("bm25_vocab_blob_size", i64), ("bm25_avgdl", ctypes.c_double)):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [vp]
    for name in ("bm25_copy_slot_ids", "bm25_copy_slot_weights", "bm25_copy_doc_freq",
                 "bm25_copy_doc_lengths", "bm25_copy_vocab_blob"):
        getattr(lib, name).argtypes = [vp, vp]
    lib.bm25_destroy.argtypes = [vp]
    lib.aux_mark_term_tiles.argtypes = [vp, i64, i32, i32, i64, vp]
    lib.aux_term_tiles_indptr.argtypes = [vp, i64, i64, vp]
    lib.aux_term_tiles_extract.argtypes = [vp, i64, i64, vp, vp]
    lib.aux_bloom_bitmaps.argtypes = [vp, i64, i32, i32, i64, vp]
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _LOCK:
        if _lib is None:
            path = build()
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except (OSError, AttributeError) as exc:
                raise RuntimeError(f"native BM25 builder: loading {path} failed: {exc}") from exc
        return _lib


def build_sparse_native(texts: list[str], k1: float, b: float) -> dict:
    """Tokenize and build the slot-padded BM25 layout natively.

    Returns ``slot_ids`` [N, L] int32 (-1 pads), ``slot_weights`` [N, L] f32,
    ``doc_freq`` and ``doc_lengths`` int64, ``avgdl`` and ``vocab`` {term: id}
    (ids in first-seen order). A document's slots are in the C++ hash table's
    iteration order, as in the JAX package's native build."""
    lib = load()
    handle = lib.bm25_create(ctypes.c_double(k1), ctypes.c_double(b))
    try:
        encoded = [t.encode("utf-8") if t else b"" for t in texts]
        arr = (ctypes.c_char_p * len(encoded))(*encoded)
        lengths = np.array([len(e) for e in encoded], dtype=np.int64)
        lib.bm25_add_docs(
            handle, arr, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(encoded)
        )
        lib.bm25_finalize(handle)
        n = lib.bm25_n_docs(handle)
        slot_ids = np.empty((n, lib.bm25_slots(handle)), dtype=np.int32)
        slot_weights = np.empty(slot_ids.shape, dtype=np.float32)
        doc_freq = np.empty(lib.bm25_n_terms(handle), dtype=np.int64)
        doc_lengths = np.empty(n, dtype=np.int64)
        lib.bm25_copy_slot_ids(handle, slot_ids.ctypes.data)
        lib.bm25_copy_slot_weights(handle, slot_weights.ctypes.data)
        lib.bm25_copy_doc_freq(handle, doc_freq.ctypes.data)
        lib.bm25_copy_doc_lengths(handle, doc_lengths.ctypes.data)
        blob_size = lib.bm25_vocab_blob_size(handle)
        blob = ctypes.create_string_buffer(blob_size)
        lib.bm25_copy_vocab_blob(handle, blob)
        terms = blob.raw[:blob_size].decode("utf-8").split("\n")[:-1]
        return {
            "slot_ids": slot_ids,
            "slot_weights": slot_weights,
            "doc_freq": doc_freq,
            "doc_lengths": doc_lengths,
            "avgdl": float(lib.bm25_avgdl(handle)),
            "vocab": {t: i for i, t in enumerate(terms)},
        }
    finally:
        lib.bm25_destroy(handle)


def build_term_tile_lists_native(doc_ids: np.ndarray, block_n: int) -> tuple[np.ndarray, np.ndarray]:
    """Term -> tile CSR (indptr int64 [V + 1], tiles int32): (term, tile)
    presence bits marked into a per-term bitmap, then popcount / ctz
    extraction. Bitwise equal to ``ops.sparse.build_term_tile_lists_plain``."""
    lib = load()
    doc_ids = np.ascontiguousarray(doc_ids, dtype=np.int32)
    n, slots = doc_ids.shape
    n_tiles = max(1, -(-n // block_n))
    vocab = max(int(doc_ids.max()) + 1 if doc_ids.size else 1, 1)
    words_per_term = (n_tiles + 63) // 64
    bitmap = np.zeros(vocab * words_per_term, dtype=np.uint64)
    lib.aux_mark_term_tiles(doc_ids.ctypes.data, n, slots, block_n, words_per_term, bitmap.ctypes.data)
    indptr = np.empty(vocab + 1, dtype=np.int64)
    lib.aux_term_tiles_indptr(bitmap.ctypes.data, vocab, words_per_term, indptr.ctypes.data)
    tiles = np.empty(int(indptr[-1]), dtype=np.int32)
    lib.aux_term_tiles_extract(bitmap.ctypes.data, vocab, words_per_term, indptr.ctypes.data,
                               tiles.ctypes.data)
    return indptr, tiles


def build_tile_bitmaps_native(doc_ids: np.ndarray, block_n: int, n_words: int) -> np.ndarray:
    """Per-tile 4-probe Bloom filters, int32 [n_tiles, n_words], probe bits
    OR-ed directly. Bitwise equal to ``ops.sparse.build_tile_bitmaps_plain``."""
    lib = load()
    doc_ids = np.ascontiguousarray(doc_ids, dtype=np.int32)
    n, slots = doc_ids.shape
    n_tiles = max(1, -(-n // block_n))
    out = np.zeros(n_tiles * n_words, dtype=np.uint32)
    lib.aux_bloom_bitmaps(doc_ids.ctypes.data, n, slots, block_n, n_words, out.ctypes.data)
    return out.view(np.int32).reshape(n_tiles, n_words)
