"""The port's ColPali / BiPali adapters against the JAX package's.

Both packages' ``embeddings/colpali.py`` are torch; the port's differs in its
default device (``"cuda"``, the model registry's device) and its registration
(``colpali``, ``colqwen``, ``bipali`` on the registry's device). A tiny stub
model and processor, seeded and shared, are monkeypatched into both
packages' ``_load_colpali``: the token matrices (queries and page images,
masked by the attention mask) and BiPali's pooled vectors must be equal
(the same module on the same inputs: exact). Without a local checkpoint
both raise ``ModelLoadError`` (``local_files_only``: nothing is fetched).
"""

import importlib
import io

import numpy as np
import pytest
import torch

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class StubModel(torch.nn.Module):
    """input ids -> [B, T, dim] token embeddings (a seeded table + linear)."""

    def __init__(self, dim=8, vocab=97, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.table = torch.nn.Parameter(torch.randn(vocab, 16, generator=g))
        self.proj = torch.nn.Parameter(torch.randn(16, dim, generator=g))

    def forward(self, input_ids, attention_mask=None, pixel_values=None):
        x = self.table[input_ids]
        if pixel_values is not None:
            x = x + pixel_values[..., None]
        return torch.tanh(x @ self.proj)


class StubProcessor:
    """Texts -> byte ids; images -> ids from their pixels, padded with a mask."""

    @staticmethod
    def _batch(seqs, pixels=None):
        t = max(len(s) for s in seqs)
        ids = torch.zeros(len(seqs), t, dtype=torch.long)
        mask = torch.zeros(len(seqs), t, dtype=torch.long)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = torch.tensor(s)
            mask[i, : len(s)] = 1
        out = {"input_ids": ids, "attention_mask": mask}
        if pixels is not None:
            out["pixel_values"] = torch.stack([
                torch.nn.functional.pad(p, (0, t - len(p))) for p in pixels
            ])
        return out

    def process_queries(self, texts):
        return self._batch([[b % 97 for b in t.encode()][:12] or [0] for t in texts])

    def process_images(self, images):
        arrs = [np.asarray(im, dtype=np.float32).reshape(-1)[:20] for im in images]
        return self._batch([[int(v) % 97 for v in a] for a in arrs],
                           [torch.from_numpy(a / 255.0) for a in arrs])


def _png(w, h, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture
def stubbed(monkeypatch):
    pair = (StubModel().eval(), StubProcessor())
    for pkg in PKGS:
        monkeypatch.setattr(_mod(pkg, "embeddings.colpali"), "_load_colpali", lambda c, d: pair)
    return pair


TEXTS = ["where is the revenue table", "x", "compare figure two and three", ""]


@pytest.mark.parametrize("batch_size", [1, 3])
def test_colpali_matrices_equal(stubbed, batch_size):
    images = [_png(3, 2, 0), _png(4, 4, 1), _png(2, 5, 2)]
    out = []
    for pkg in PKGS:
        emb = _mod(pkg, "embeddings.colpali").ColPaliEmbedding(device="cpu", batch_size=batch_size)
        out.append((emb.embed_texts_multi(TEXTS), emb.embed_images_multi(images),
                    emb.embed_query_multi("q"), emb.dim))
    for a, b in zip(out[0][0] + out[0][1] + [out[0][2]], out[1][0] + out[1][1] + [out[1][2]]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(b, a)
    assert out[1][3] == out[0][3] == 8
    # the mask keeps each input's own tokens only
    assert [m.shape[0] for m in out[1][0]] == [12, 1, 12, 1]


def test_bipali_pooled_vectors_equal(stubbed):
    images = [_png(3, 3, 3), _png(5, 2, 4)]
    out = []
    for pkg in PKGS:
        emb = _mod(pkg, "embeddings.colpali").BiPaliEmbedding(device="cpu")
        out.append((emb.embed_texts(TEXTS), emb.embed_images(images), emb.embed_query("q")))
    for a, b in zip(out[0], out[1]):
        np.testing.assert_array_equal(b, a)
    assert out[1][0].shape == (4, 8) and out[1][1].shape == (2, 8)


def test_defaults_and_registry_device():
    cp = _mod(TORCH, "embeddings.colpali")
    assert cp.ColPaliEmbedding().device == "cuda" and cp.BiPaliEmbedding().device == "cuda"
    assert _mod(JAX, "embeddings.colpali").ColPaliEmbedding().device == "cpu"
    reg = _mod(TORCH, "injection").ModelRegistry(device="cpu", health_check=False)
    jreg = _mod(JAX, "injection").ModelRegistry(health_check=False)
    for name, cls in (("colpali", "ColPaliEmbedding"), ("colqwen", "ColPaliEmbedding"),
                      ("bipali", "BiPaliEmbedding")):
        model, jmodel = reg.load_embedding(name), jreg.load_embedding(name)
        assert type(model) is getattr(cp, cls)
        assert (model.checkpoint, model.batch_size, model.dim) == \
            (jmodel.checkpoint, jmodel.batch_size, jmodel.dim)
        assert model.device == "cpu"
        assert name not in _mod(TORCH, "injection").DEFERRED["embedding"]


def test_missing_checkpoint_raises_model_load_error(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    for pkg in PKGS:
        mod = _mod(pkg, "embeddings.colpali")
        mod._load_colpali.cache_clear()
        with pytest.raises(_mod(pkg, "exceptions").ModelLoadError,
                           match="cannot load ColPali checkpoint"):
            mod.ColPaliEmbedding(checkpoint=str(tmp_path / "none"), device="cpu").embed_query_multi("q")
    # through the registry, the health check surfaces the same refusal
    (tmp_path / "embedding").mkdir()
    (tmp_path / "embedding" / "cp.yaml").write_text(f"type: colpali\ncheckpoint: {tmp_path / 'none'}\n")
    reg = _mod(TORCH, "injection").ModelRegistry(tmp_path, device="cpu")
    with pytest.raises(_mod(TORCH, "exceptions").ModelLoadError, match="cannot load ColPali"):
        reg.load_embedding("cp")
