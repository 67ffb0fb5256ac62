"""The benchmark's inputs, drawn from the seed: corpora on the device, queries on the host.

Both the kinds (which hand the inputs to the program) and the references
(which draw the corpus again after the window) use these functions, so both
sides see the same numbers. A corpus is drawn in slabs of fixed size from one
device generator: the same seed, shapes and device give the same slabs, which
is what lets a reference draw the corpus anew instead of keeping a copy.
The laws are named by the configuration and traffic files (``"law"`` keys).
"""

from __future__ import annotations

import numpy as np
import torch

# elements a slab of corpus draws at once on the device (512 MB of f32)
SLAB_ELEMS = 1 << 27

# independent streams of one seed
_CORPUS, _LENS, _QUERIES, _SAMPLE = 1, 2, 3, 4


def _mix(seed: int, tag: int) -> int:
    return (int(seed) % (1 << 58)) * 32 + tag


def device_generator(seed: int, tag: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix(seed, tag))
    return gen


def host_rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), tag])


def sample_rng(seed: int) -> np.random.Generator:
    """The stream that picks which answers of a run are checked."""
    return host_rng(seed, _SAMPLE)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows of unit L2 norm along the last axis; a zero row stays zero."""
    norms = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(norms > 0, x / torch.where(norms == 0, 1.0, norms), 0.0)


# ------------------------------------------------------------------ dense rows
def dense_slabs(law: dict, seed: int, n: int, d: int, device: torch.device):
    """Yield ``(first_row, rows [m, d] f32 on device)`` covering ``n`` rows.

    ``{"law": "gaussian"}``: i.i.d. N(0, 1) coordinates (``bench.py``'s
    corpus before normalization)."""
    if law.get("law") != "gaussian":
        raise ValueError(f"unknown dense corpus law: {law}")
    gen = device_generator(seed, _CORPUS, device)
    per = max(1, SLAB_ELEMS // d)
    for lo in range(0, n, per):
        yield lo, torch.randn((min(per, n - lo), d), generator=gen, device=device)


def dense_rows_host(law: dict, seed: int, n: int, d: int, device: torch.device) -> np.ndarray:
    """The whole corpus as one host f32 array [n, d], as a catalog hands it."""
    out = np.empty((n, d), dtype=np.float32)
    host = torch.from_numpy(out)
    for lo, rows in dense_slabs(law, seed, n, d, device):
        host[lo : lo + rows.shape[0]].copy_(rows)
    return out


def dense_queries(law: dict, seed: int, count: int, d: int) -> np.ndarray:
    """``count`` query embeddings [count, d] f32 on the host."""
    if law.get("law") != "gaussian":
        raise ValueError(f"unknown dense query law: {law}")
    return host_rng(seed, _QUERIES).standard_normal((count, d), dtype=np.float32)


# ------------------------------------------------------------------ pages
def page_lens(law: dict, seed: int, n: int) -> np.ndarray:
    """Token counts of ``n`` pages, uniform in [min_tokens, max_tokens]."""
    if law.get("law") != "gaussian_tokens":
        raise ValueError(f"unknown page law: {law}")
    return host_rng(seed, _LENS).integers(
        int(law["min_tokens"]), int(law["max_tokens"]) + 1, size=n
    ).astype(np.int64)


def page_slabs(law: dict, seed: int, n: int, d: int, device: torch.device):
    """Yield ``(first_page, tokens [m, max_tokens, d] f32 on device)``: i.i.d.
    N(0, 1) token vectors; a page's tokens past its length are drawn and
    never used."""
    if law.get("law") != "gaussian_tokens":
        raise ValueError(f"unknown page law: {law}")
    gen = device_generator(seed, _CORPUS, device)
    tmax = int(law["max_tokens"])
    per = max(1, SLAB_ELEMS // (tmax * d))
    for lo in range(0, n, per):
        m = min(per, n - lo)
        yield lo, torch.randn((m, tmax, d), generator=gen, device=device)


def pages_host(law: dict, seed: int, n: int, d: int, device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """(tokens [n, max_tokens, d] f32 on the host, lens [n])."""
    out = np.empty((n, int(law["max_tokens"]), d), dtype=np.float32)
    host = torch.from_numpy(out)
    for lo, toks in page_slabs(law, seed, n, d, device):
        host[lo : lo + toks.shape[0]].copy_(toks)
    return out, page_lens(law, seed, n)


def gold_page_queries(law: dict, seed: int, count: int, tokens: np.ndarray, lens: np.ndarray) -> list[np.ndarray]:
    """``count`` query matrices [T, d]: T tokens of one gold page, each its
    page token of unit norm plus ``noise`` times N(0, 1) a dimension
    (``chip_smoke.py``'s config #5 law), handed over unnormalized."""
    if law.get("law") != "gold_page":
        raise ValueError(f"unknown page query law: {law}")
    rng = host_rng(seed, _QUERIES)
    t, noise, d = int(law["tokens"]), float(law["noise"]), tokens.shape[2]
    gold = rng.integers(0, tokens.shape[0], size=count)
    out = []
    for g in gold:
        picked = tokens[g, rng.integers(0, lens[g], size=t)]
        unit = picked / np.linalg.norm(picked, axis=1, keepdims=True)
        out.append((unit + noise * rng.standard_normal((t, d), dtype=np.float32)).astype(np.float32))
    return out
