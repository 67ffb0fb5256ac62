"""The port's train steps against the JAX package's, one step on one seeded
batch: ``info_nce_loss``, ``contrastive_train_step`` (single- and
multi-vector), ``pairwise_train_step``, ``lm_train_step`` and the LM
trainer's ``_sft_loss``, and ``torch.optim.AdamW`` against ``optax.adamw``.

Each port module starts from the JAX ``init`` parameters, carried by
``from_jax_params`` (the flat names of the JAX ``save_params`` / ``JaxLM.save``),
and takes the same numpy batch. Tolerances, all f32:

- losses: ``LOSS_TOL`` = 1e-5 relative (the two GEMM and softmax reduction
  orders differ by a few ulps; 2.3e-7 measured);
- parameters after one SGD step at ``LR`` = 0.1: ``PARAM_TOL`` = 5e-6
  absolute, the gradients' f32 reduction-order differences times the
  learning rate (7.7e-7 measured; a step moves the weights by up to 1.3);
- AdamW against optax on the same gradients: after step t, ``t`` ulps of
  the parameter (each package rounds ``p + update`` in its own order) plus
  ``t * ADAM_TOL * lr``, ``ADAM_TOL`` = 1e-5: optax forms the bias
  corrections ``1 - b ** t`` in f32, where ``1 - f32(0.999)`` is 1.3e-5 off
  0.001, and torch in double, so an update differs by up to 6.4e-6 of the
  learning rate.

The JAX multi-vector step's gradient is NaN whenever a batch holds a pad
token (``jnp.linalg.norm``'s gradient at the zero pad vectors is 0 / 0). The
port's forward gives the same values, and its gradient there is finite: the
padded case is held against the JAX step with a norm whose gradient at 0 is
0, and the unpatched JAX step is shown to give NaN on the same batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autorag_research_tpu.embeddings.jax_encoder import _flatten_params
from autorag_research_tpu.models import cross_encoder as jce
from autorag_research_tpu.models import decoder as jd
from autorag_research_tpu.models import encoder as je
from autorag_research_tpu.models import lm_trainer as jlt
from autorag_research_tpu_torch import models as tmodels
from autorag_research_tpu_torch.models import cross_encoder as tce
from autorag_research_tpu_torch.models import decoder as td
from autorag_research_tpu_torch.models import encoder as te
from autorag_research_tpu_torch.models import lm_trainer as tlt

LOSS_TOL, PARAM_TOL, ADAM_TOL, LR = 1e-5, 5e-6, 1e-5, 0.1
ENC = dict(vocab_size=512, hidden=32, layers=2, heads=2, max_len=12, out_dim=16)
DEC = dict(hidden=32, layers=2, heads=2, max_len=24)
B, T = 6, 12


def masks(rng, pads: bool):
    """[B, T] masks: real tokens first, then pads of random length."""
    if not pads:
        return np.ones((B, T), bool)
    lens = rng.integers(3, T + 1, B)
    lens[0] = T
    return np.arange(T)[None] < lens[:, None]


def encoder_pair(seed=3, **kw):
    cfg = {**ENC, **kw}
    jenc = je.RetrievalEncoder(je.EncoderConfig(**cfg))
    params = jenc.init(seed)
    tenc = te.RetrievalEncoder(te.EncoderConfig(**cfg), device="cpu")
    tenc.load_state_dict(te.from_jax_params(_flatten_params(params)))
    return jenc, params, tenc


def contrastive_batch(seed=0, pads=True):
    rng = np.random.default_rng(seed)
    arrays = {
        "q_ids": rng.integers(1, ENC["vocab_size"], (B, T)).astype(np.int32),
        "q_mask": masks(rng, pads),
        "d_ids": rng.integers(1, ENC["vocab_size"], (B, T)).astype(np.int32),
        "d_mask": masks(rng, pads),
    }
    return arrays, to_jax(arrays), to_torch(arrays)


def to_jax(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def to_torch(arrays):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in arrays.items()}


def jit_step(step, model):
    """The JAX step at ``LR`` under one jit (traced anew on every call, so a
    patched ``jnp`` function is picked up)."""
    return jax.jit(lambda p, b: step(model, p, b, lr=LR))


def assert_params_close(jax_params, module, tol=PARAM_TOL):
    ref = _flatten_params(jax_params)
    got = te.encoder_params_to_jax(module)
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=tol, err_msg=name)


def finite_norm(x, axis=None, keepdims=False):
    """``jnp.linalg.norm`` with a 0 gradient at the zero vector (same values)."""
    sq = (x * x).sum(axis=axis, keepdims=keepdims)
    zero = sq == 0
    return jnp.where(zero, 0.0, jnp.sqrt(jnp.where(zero, 1.0, sq)))


@pytest.mark.parametrize("temperature", [0.05, 1.0])
def test_info_nce_loss_matches_jax(temperature):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    d = rng.standard_normal((8, 16)).astype(np.float32)
    ref = float(je.info_nce_loss(jnp.asarray(q), jnp.asarray(d), temperature))
    got = float(te.info_nce_loss(torch.from_numpy(q), torch.from_numpy(d), temperature))
    assert got == pytest.approx(ref, rel=LOSS_TOL)


@pytest.mark.parametrize("pads", [False, True], ids=["full", "padded"])
def test_contrastive_step_single_vector_matches_jax(pads):
    jenc, params, tenc = encoder_pair()
    _, jb, tb = contrastive_batch(pads=pads)
    new_params, ref_loss = jit_step(je.contrastive_train_step, jenc)(params, jb)
    loss = tmodels.contrastive_train_step(tenc, tb, lr=LR)
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_TOL)
    assert_params_close(new_params, tenc)


def test_contrastive_step_multi_vector_matches_jax():
    jenc, params, tenc = encoder_pair(multi_vector=True)
    _, jb, tb = contrastive_batch(pads=False)
    new_params, ref_loss = jit_step(je.contrastive_train_step, jenc)(params, jb)
    loss = te.contrastive_train_step(tenc, tb, lr=LR)
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_TOL)
    assert_params_close(new_params, tenc)


def test_contrastive_step_multi_vector_pads_finite(monkeypatch):
    """With pads the JAX step's loss is the port's, its new parameters NaN;
    the port's (torch's norm has a 0 gradient at a zero vector) equal the
    JAX step's under a norm patched to do the same."""
    jenc, params, tenc = encoder_pair(multi_vector=True)
    _, jb, tb = contrastive_batch(pads=True)
    nan_params, ref_loss = jit_step(je.contrastive_train_step, jenc)(params, jb)
    assert not all(np.isfinite(v).all() for v in _flatten_params(nan_params).values())
    monkeypatch.setattr(jnp.linalg, "norm", finite_norm)
    new_params, finite_loss = jit_step(je.contrastive_train_step, jenc)(params, jb)
    assert float(finite_loss) == pytest.approx(float(ref_loss), rel=LOSS_TOL)
    loss = te.contrastive_train_step(tenc, tb, lr=LR)
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_TOL)
    assert_params_close(new_params, tenc)


def test_pairwise_step_matches_jax():
    cfg = {**ENC, "max_len": 16}
    jenc = jce.CrossEncoder(je.EncoderConfig(**cfg))
    params = jenc.init(5)
    tenc = tce.CrossEncoder(te.EncoderConfig(**cfg), device="cpu")
    tenc.load_state_dict(tce.cross_params_from_jax(_flatten_params(params)))
    queries = ["capital of france", "what color is the sky", "", "legs on a cat"]
    pos = ["paris is the capital of france", "the sky is blue", "empty query doc", "four legs"]
    neg = ["berlin is in germany", "grass is green", "another doc", "two wings"]
    arrays = {}
    for side, docs in (("pos", pos), ("neg", neg)):
        ids, mask = jce.pair_tokenize(queries, docs, cfg["vocab_size"], cfg["max_len"])
        arrays[f"{side}_ids"], arrays[f"{side}_mask"] = ids, mask
    new_params, ref_loss = jit_step(jce.pairwise_train_step, jenc)(params, to_jax(arrays))
    loss = tce.pairwise_train_step(tenc, to_torch(arrays), lr=LR)
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_TOL)
    assert_params_close(new_params, tenc)


def decoder_pair(seed=2):
    jdec = jd.CausalDecoder(jd.DecoderConfig(**DEC))
    params = jdec.init(seed)
    tdec = td.CausalDecoder(td.DecoderConfig(**DEC), device="cpu")
    tdec.load_state_dict(td.decoder_params_from_jax(_flatten_params(params)))
    return jdec, params, tdec


@pytest.mark.parametrize("padding", ["left", "right"])
def test_lm_train_step_matches_jax(padding):
    """Left-padded prompts (``byte_tokenize``) and right-padded rows (SFT):
    targets ``roll(ids, -1)``, valid = mask & roll(mask, -1), last column off."""
    jdec, params, tdec = decoder_pair()
    texts = ["the capital of france is paris", "x", "", "café ☃ unicode"]
    ids, mask = jd.byte_tokenize(texts, DEC["max_len"])
    if padding == "right":
        enc = jlt.encode_sft([(t, "ok") for t in texts], DEC["max_len"])
        ids, mask = enc["ids"], enc["mask"]
    arrays = {"ids": ids, "mask": mask}
    new_params, ref_loss = jit_step(jd.lm_train_step, jdec)(params, to_jax(arrays))
    was = [p.requires_grad for p in tdec.parameters()]
    loss = td.lm_train_step(tdec, to_torch(arrays), lr=LR)
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_TOL)
    assert_params_close(new_params, tdec)
    # the serving module keeps its gradients off
    assert [p.requires_grad for p in tdec.parameters()] == was == [False] * len(was)


def test_sft_loss_and_gradient_match_jax():
    jdec, params, tdec = decoder_pair()
    examples = [("Q: capital of france? A:", " paris"), ("Q: sky? A:", " blue"),
                ("x" * 40, "truncated prompt"), ("", "no prompt")]
    arrays = jlt.encode_sft(examples, DEC["max_len"])
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlt._sft_loss(jdec, p, b)))(params, to_jax(arrays))
    tdec.requires_grad_(True)
    loss = tlt._sft_loss(tdec, to_torch(arrays))
    loss.backward()
    assert loss.item() == pytest.approx(float(ref_loss), rel=LOSS_TOL)
    ref = _flatten_params(ref_grads)
    for name, p in tdec.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0, atol=PARAM_TOL / LR,
                                   err_msg=name)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_optax(weight_decay):
    """``torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay)``
    is ``optax.adamw(lr, weight_decay=)``: five steps on the same gradients,
    some of them near 0 and exactly 0, where the first step acts as a sign."""
    rng = np.random.default_rng(4)
    lr = 3e-3
    p0 = rng.standard_normal((64, 8)).astype(np.float32)
    grads = [(rng.standard_normal((64, 8)) * 10.0 ** rng.integers(-9, 1, (64, 8))).astype(np.float32)
             for _ in range(5)]
    for g in grads:
        g[:4] = 0.0
    tx = optax.adamw(lr, weight_decay=weight_decay)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.AdamW([tp], lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    for t, g in enumerate(grads, start=1):
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        opt.step()
        ref = np.asarray(jp)
        tol = t * (2.0**-23 * np.abs(ref) + ADAM_TOL * lr)
        assert (np.abs(tp.detach().numpy() - ref) <= tol).all(), t
    assert not np.array_equal(np.asarray(jp), p0)


def test_encoder_params_round_trip_through_both_loaders(tmp_path):
    """The port's ``save_params`` is read by the JAX ``load_params`` and
    the port's own, the JAX file by the port's: the same arrays."""
    from autorag_research_tpu.embeddings import jax_encoder as jax_emb
    from autorag_research_tpu_torch.embeddings import torch_encoder as torch_emb

    jenc, params, tenc = encoder_pair()
    torch_emb.save_params(tenc, tmp_path / "port.npz")
    jax_emb.save_params(params, tmp_path / "jax.npz")
    back = _flatten_params(jax_emb.load_params(params, tmp_path / "port.npz"))
    ref = _flatten_params(params)
    for name in ref:
        np.testing.assert_array_equal(back[name], ref[name])
    for path in ("port.npz", "jax.npz"):
        state = torch_emb.load_params(tmp_path / path)
        for name in ref:
            np.testing.assert_array_equal(state[name].numpy(), ref[name])
