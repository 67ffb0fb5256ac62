"""Port encoder vs the JAX package's ``RetrievalEncoder``.

Both run the same weights: the JAX model's random init, handed over as the
flattened arrays its ``save_params`` writes. Outputs are L2-normalized
embeddings; they agree to ``atol=1e-5`` (f32 matmuls and reductions summed
in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorag_research_tpu.embeddings.jax_encoder import (
    JaxEncoderEmbedding,
    JaxEncoderMultiVectorEmbedding,
    _flatten_params,
    save_params,
)
from autorag_research_tpu.models import encoder as jenc
from autorag_research_tpu_torch.embeddings.torch_encoder import (
    TorchEncoderEmbedding,
    TorchEncoderMultiVectorEmbedding,
)
from autorag_research_tpu_torch.models import encoder as tenc

SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, max_len=16, out_dim=32)


def _texts(seed, n):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(1, 24)))) for _ in range(n)]
    texts[0] = ""  # empty text: mask of one position
    return texts


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_encoder_forward_matches_jax(multi):
    jcfg = jenc.EncoderConfig(multi_vector=multi, **SMALL)
    tcfg = tenc.EncoderConfig(multi_vector=multi, **SMALL)
    params = jenc.RetrievalEncoder(jcfg).init(3)
    model = tenc.RetrievalEncoder(tcfg, device="cpu")
    model.load_state_dict(tenc.from_jax_params(_flatten_params(params)))
    ids, mask = jenc.hash_tokenize(_texts(1, 10), SMALL["vocab_size"], SMALL["max_len"])
    ref = np.asarray(jenc.RetrievalEncoder(jcfg)(params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_from_jax_params_covers_every_weight():
    cfg = tenc.EncoderConfig(**SMALL)
    flat = _flatten_params(jenc.RetrievalEncoder(jenc.EncoderConfig(**SMALL)).init(0))
    state = tenc.RetrievalEncoder(cfg, device="cpu").state_dict()
    assert set(flat) == set(state)
    for name, arr in flat.items():
        assert tuple(state[name].shape) == arr.shape, name


def test_hash_tokenize_identical():
    texts = _texts(2, 30) + ["Upper CASE words", "a " * 40]
    for vocab, max_len in ((512, 16), (32768, 128)):
        jids, jmask = jenc.hash_tokenize(texts, vocab, max_len)
        tids, tmask = tenc.hash_tokenize(texts, vocab, max_len)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tmask, jmask)


def test_embedders_load_jax_npz(tmp_path):
    jcfg = jenc.EncoderConfig(**SMALL)
    path = tmp_path / "params.npz"
    save_params(jenc.RetrievalEncoder(jcfg).init(7), path)
    texts = _texts(4, 9)
    jemb = JaxEncoderEmbedding(jcfg, params_path=path, batch_size=4)
    temb = TorchEncoderEmbedding(
        tenc.EncoderConfig(**SMALL), params_path=path, batch_size=4, device="cpu"
    )
    ref = jemb.embed_texts(texts)
    np.testing.assert_allclose(temb.embed_texts(texts), ref, atol=1e-5)
    dev = temb.embed_texts_device(texts)
    assert isinstance(dev, torch.Tensor) and dev.shape == ref.shape
    np.testing.assert_allclose(dev.numpy(), ref, atol=1e-5)
    # identical weights, not just close outputs
    with np.load(path) as data:
        for name, t in temb.encoder.state_dict().items():
            np.testing.assert_array_equal(t.numpy(), data[name])


def test_multi_vector_embedder_matches_jax(tmp_path):
    jcfg = jenc.EncoderConfig(multi_vector=True, **SMALL)
    path = tmp_path / "mv.npz"
    save_params(jenc.RetrievalEncoder(jcfg).init(8), path)
    texts = _texts(5, 6)
    ref = JaxEncoderMultiVectorEmbedding(jcfg, params_path=path).embed_texts_multi(texts)
    got = TorchEncoderMultiVectorEmbedding(
        tenc.EncoderConfig(multi_vector=True, **SMALL), params_path=path, device="cpu"
    ).embed_texts_multi(texts)
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-5)


def test_seeded_init_is_reproducible():
    cfg = tenc.EncoderConfig(**SMALL)
    a = tenc.RetrievalEncoder(cfg, device="cpu", seed=5).state_dict()
    b = tenc.RetrievalEncoder(cfg, device="cpu", seed=5).state_dict()
    c = tenc.RetrievalEncoder(cfg, device="cpu", seed=6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
