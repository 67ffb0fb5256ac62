"""The port's causal decoder against the JAX package's ``models/decoder.py``.

Both run the same weights: JAX ``init`` params, flattened as ``JaxLM.save``
writes them and carried by ``decoder_params_from_jax``. Tolerances:

- prefill logits and the KV cache in f32: 1e-5 absolute (the two softmax
  and GEMM reduction orders differ by a few f32 ulps; logits are O(1));
- the bf16 setting (only the embedding sum is rounded, then the first layer
  norm runs on bf16 values): 1e-3 absolute, against a largest difference of
  4.6e-4 measured over both configurations below and seeds 0-5 (XLA and
  PyTorch round the bf16 layer norm's intermediates at different places);
- decode-step logits, each package teacher-forced with the JAX ``generate``'s
  own tokens so that one near-tie cannot cascade: 1e-5;
- greedy tokens: equal, except that a row may differ from its first step
  whose top-2 logit margin (in the JAX logits) is below ``NEAR_TIE``.

Temperature sampling cannot repeat ``jax.random.categorical``'s draws, so it
is held to its own contract: a seeded generator repeats a call, ``TorchLM``
advances across calls, and frequencies on fixed logits follow the softmax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autorag_research_tpu.llm.jax_lm import _flatten
from autorag_research_tpu.models import decoder as jd
from autorag_research_tpu_torch.llm import TorchLM
from autorag_research_tpu_torch.models import decoder as td

F32_TOL, BF16_TOL, NEAR_TIE = 1e-5, 1e-3, 1e-5
CONFIGS = [dict(hidden=32, layers=2, heads=2, max_len=64),
           dict(hidden=64, layers=2, heads=4, max_len=64)]
PROMPTS = ["the capital of france", "x", "", "unicode: café ☃ — naïve", "a" * 40,
           "Question: who wrote it?\n\nAnswer:"]


def pair(cfg: dict, seed: int = 0, dtype=None):
    """(JAX decoder, its params, the port's decoder on those weights)."""
    jcfg = jd.DecoderConfig(**cfg, **({"dtype": jnp.bfloat16} if dtype == "bf16" else {}))
    tcfg = td.DecoderConfig(**cfg, **({"dtype": torch.bfloat16} if dtype == "bf16" else {}))
    jdec = jd.CausalDecoder(jcfg)
    params = jdec.init(seed)
    tdec = td.CausalDecoder(tcfg, device="cpu")
    tdec.load_state_dict(td.decoder_params_from_jax(_flatten(params)))
    return jdec, params, tdec


def batch(prompts, max_len):
    ids, mask = jd.byte_tokenize(prompts, max_len)
    return ids, mask, torch.from_numpy(ids).long(), torch.from_numpy(mask)


def jax_step_logits(jdec, params, ids, mask, tokens):
    """The logits each JAX decode step picks from, [B, n, V], with the JAX
    ``_step`` fed ``tokens`` (the loop of ``CausalDecoder.generate``)."""
    cfg = jdec.config
    b, tp = ids.shape
    logits, cache = jdec(params, jnp.asarray(ids), jnp.asarray(mask), return_cache=True)
    out = [np.asarray(logits[:, -1])]
    prompt_len = jnp.asarray(mask.sum(1), jnp.int32)
    kv_prompt = jnp.pad(jnp.asarray(mask), ((0, 0), (0, cfg.max_len - tp)))
    slots = jnp.arange(cfg.max_len)
    for i in range(tokens.shape[1] - 1):
        kv_mask = kv_prompt | ((slots >= tp) & (slots <= tp + i))[None, :]
        lg, cache = jdec._step(params, cache, jnp.asarray(tokens[:, i]), prompt_len + i,
                               tp + i, kv_mask)
        out.append(np.asarray(lg))
    return np.stack(out, axis=1)


def torch_step_logits(tdec, tids, tmask, tokens):
    """The port's counterpart of :func:`jax_step_logits`: its ``_step`` fed
    ``tokens`` after its own prefill, the loop of ``generate``."""
    cfg = tdec.config
    b, tp = tids.shape
    with torch.no_grad():
        logits, cache = tdec(tids, tmask, return_cache=True)
        out = [logits[:, -1]]
        kv_mask = torch.zeros((b, cfg.max_len), dtype=torch.bool)
        kv_mask[:, :tp] = tmask
        prompt_len = tmask.sum(1)
        for i in range(tokens.shape[1] - 1):
            kv_mask[:, tp + i] = True
            out.append(tdec._step(cache, tokens[:, i], prompt_len + i, tp + i, kv_mask))
    return torch.stack(out, dim=1).numpy()


# ------------------------------------------------------------- tokenizer


@pytest.mark.parametrize("max_len", [1, 8, 32, 64])
def test_byte_tokenizer_bitwise(max_len):
    texts = PROMPTS + ["ünïcödé " * 20, "\x00\x01 control", "日本語のテキスト"]
    ids, mask = td.byte_tokenize(texts, max_len)
    jids, jmask = jd.byte_tokenize(texts, max_len)
    assert ids.dtype == jids.dtype and mask.dtype == jmask.dtype
    assert np.array_equal(ids, jids) and np.array_equal(mask, jmask)
    assert td.byte_detokenize(ids) == jd.byte_detokenize(jids)
    rows = np.random.default_rng(max_len).integers(0, 259, size=(5, 17))
    assert td.byte_detokenize(rows) == jd.byte_detokenize(rows)
    assert td.byte_detokenize(torch.from_numpy(rows)) == jd.byte_detokenize(rows)


# ---------------------------------------------------------------- prefill


@pytest.mark.parametrize("cfg", CONFIGS, ids=["h32", "h64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_logits_and_cache_match_jax(cfg, seed):
    jdec, params, tdec = pair(cfg, seed)
    ids, mask, tids, tmask = batch(PROMPTS, 24)
    jl, jcache = jdec(params, jnp.asarray(ids), jnp.asarray(mask), return_cache=True)
    with torch.no_grad():
        tl, tcache = tdec(tids, tmask, return_cache=True)
    assert tl.dtype == torch.float32 and tl.shape == (len(PROMPTS), 24, 259)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=F32_TOL)
    for (ck, cv), layer in zip(tcache, jcache):
        np.testing.assert_allclose(ck.numpy(), np.asarray(layer["k"]), rtol=0, atol=F32_TOL)
        np.testing.assert_allclose(cv.numpy(), np.asarray(layer["v"]), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["h32", "h64"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_setting_promotes_like_jax(cfg, seed):
    """``dtype=bfloat16`` rounds the embedding sum only: logits and cache
    come out f32 in both packages, within ``BF16_TOL``."""
    jdec, params, tdec = pair(cfg, seed, dtype="bf16")
    ids, mask, tids, tmask = batch(PROMPTS, 24)
    jl, jcache = jdec(params, jnp.asarray(ids), jnp.asarray(mask), return_cache=True)
    with torch.no_grad():
        tl, tcache = tdec(tids, tmask, return_cache=True)
    assert jl.dtype == jnp.float32 and tl.dtype == torch.float32
    assert jcache[0]["k"].dtype == jnp.float32 and tcache[0][0].dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=BF16_TOL)
    # the bf16 rounding is really there: the f32 model differs by more
    f32 = pair(cfg, seed)[2]
    with torch.no_grad():
        assert (f32(tids, tmask) - tl).abs().max() > 1e-5


# ------------------------------------------------------------ decode path


@pytest.mark.parametrize("cfg", CONFIGS, ids=["h32", "h64"])
@pytest.mark.parametrize("seed", [0, 3])
def test_teacher_forced_step_logits_match_jax(cfg, seed):
    jdec, params, tdec = pair(cfg, seed)
    ids, mask, tids, tmask = batch(PROMPTS, 24)
    n = 16
    jtok, jn = jdec.generate(params, jnp.asarray(ids), jnp.asarray(mask), n)
    jtok = np.asarray(jtok)
    ref = jax_step_logits(jdec, params, ids, mask, jtok)
    got = torch_step_logits(tdec, tids, tmask, torch.from_numpy(jtok.astype(np.int64)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)
    # generate's tokens, fed back through the same loop, are its greedy
    # picks, and those logits follow the JAX loop where its tokens agree
    tok, tn = tdec.generate(tids, tmask, n)
    picked = torch.from_numpy(torch_step_logits(tdec, tids, tmask, tok))
    greedy = torch.argmax(picked, dim=-1)
    ended = torch.cumsum((tok == td.EOS_ID).long(), dim=1) - (tok == td.EOS_ID).long() > 0
    assert torch.equal(tok, torch.where(ended, td.PAD_ID, greedy))
    for row in range(len(PROMPTS)):
        s = np.flatnonzero(tok[row].numpy() != jtok[row])
        upto = int(s[0]) + 1 if s.size else n
        np.testing.assert_allclose(picked[row, :upto].numpy(), ref[row, :upto], rtol=0,
                                   atol=F32_TOL)
        if not s.size:
            assert tn[row] == np.asarray(jn)[row]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["h32", "h64"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_greedy_tokens_equal_except_near_ties(cfg, seed):
    jdec, params, tdec = pair(cfg, seed)
    ids, mask, tids, tmask = batch(PROMPTS, 24)
    n = 24
    jtok, jn = jdec.generate(params, jnp.asarray(ids), jnp.asarray(mask), n)
    jtok, jn = np.asarray(jtok), np.asarray(jn)
    tok, tn = tdec.generate(tids, tmask, n)
    tok, tn = tok.numpy(), tn.numpy()
    ref = jax_step_logits(jdec, params, ids, mask, jtok)
    for row in range(len(PROMPTS)):
        diff = np.flatnonzero(tok[row] != jtok[row])
        if diff.size == 0:
            assert tn[row] == jn[row]
            continue
        top2 = np.sort(ref[row, diff[0]])[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (row, diff[0], top2)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["h32", "h64"])
def test_kv_cache_decode_matches_full_forward(cfg):
    """Greedy KV-cache decode equals naive decode that re-runs the whole
    causal forward each step (``tests/test_decoder_lm.py``'s check), and each
    step's logits equal the teacher-forced full forward over prompt plus
    generated tokens."""
    _, _, tdec = pair(cfg, 0)
    ids, mask, tids, tmask = batch(["the capital of france", "x", ""], 24)
    n = 8
    tokens = tdec.generate(tids, tmask, n)[0]
    picked = torch_step_logits(tdec, tids, tmask, tokens)
    tokens = tokens.numpy()
    with torch.no_grad():
        for row in range(len(ids)):
            seq = list(ids[row][mask[row]])
            done = False
            for step in range(n):
                logits = tdec(torch.tensor([seq]), torch.ones((1, len(seq)), dtype=torch.bool))
                nxt = PAD if done else int(torch.argmax(logits[0, -1]))
                assert nxt == tokens[row, step], (row, step)
                done = done or nxt == td.EOS_ID
                if not done:
                    seq.append(nxt)
        full_ids = torch.cat([tids, torch.from_numpy(tokens[:, :-1])], dim=1)
        full_mask = torch.cat([tmask, torch.ones((len(ids), n - 1), dtype=torch.bool)], dim=1)
        full = tdec(full_ids, full_mask)[:, ids.shape[1] - 1:]
    np.testing.assert_allclose(picked, full.numpy(), rtol=0, atol=F32_TOL)


PAD = td.PAD_ID


def test_eos_freezes_rows_like_jax():
    """An edit of the tied EOS embedding in both packages makes rows emit EOS
    mid-run; after it they emit PAD, and ``n_generated`` counts neither."""
    cfg = CONFIGS[0]
    jdec, params, _ = pair(cfg, 0)
    ids, mask, tids, tmask = batch(PROMPTS, 24)
    n = 20
    jtok = np.asarray(jdec.generate(params, jnp.asarray(ids), jnp.asarray(mask), n)[0])
    ref = jax_step_logits(jdec, params, ids, mask, jtok)
    # a token first emitted mid-run by some row: EOS takes its embedding,
    # scaled so that EOS wins that step's argmax
    row, step = next((r, s) for r in range(len(PROMPTS)) for s in range(1, n)
                     if jtok[r, s] not in jtok[r, :s])
    x = int(jtok[row, step])
    scale = 1.01 if ref[row, step, x] > 0 else 0.99
    flat = _flatten(params)
    flat["embed"] = np.array(flat["embed"])
    flat["embed"][jd.EOS_ID] = flat["embed"][x] * scale
    params = jax.tree.map(jnp.asarray, _unflatten(params, flat))
    jtok, jn = jdec.generate(params, jnp.asarray(ids), jnp.asarray(mask), n)
    jtok, jn = np.asarray(jtok), np.asarray(jn)
    tdec = td.CausalDecoder(td.DecoderConfig(**cfg), device="cpu")
    tdec.load_state_dict(td.decoder_params_from_jax(flat))
    tok, tn = tdec.generate(tids, tmask, n)
    assert np.array_equal(tok.numpy(), jtok) and np.array_equal(tn.numpy(), jn)
    first = int(np.argmax(jtok[row] == jd.EOS_ID))
    assert jtok[row, first] == jd.EOS_ID and 0 < first <= step
    assert (jtok[row, first + 1:] == PAD).all()
    assert jn[row] == first
    produced = (jtok != PAD) & (jtok != jd.EOS_ID)
    assert np.array_equal(jn, produced.sum(1))


def _unflatten(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}.") for k, v in template.items()}
    if isinstance(template, list):
        return [_unflatten(v, flat, f"{prefix}{i}.") for i, v in enumerate(template)]
    return flat[prefix[:-1]]


def test_budget_guard():
    jdec, params, tdec = pair(CONFIGS[0], 0)
    ids, mask, tids, tmask = batch(["x" * 100], 60)
    with pytest.raises(ValueError, match="exceeds max_len"):
        jdec.generate(params, jnp.asarray(ids), jnp.asarray(mask), 8)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tdec.generate(tids, tmask, 8)
    tdec.generate(tids, tmask, 4)  # exactly at max_len
    with pytest.raises(ValueError, match="exceeds model max_len"):
        TorchLM(td.DecoderConfig(**CONFIGS[0]), max_prompt_len=60, max_new_tokens=8, device="cpu")


def test_dtype_other_than_f32_or_bf16_refused():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        td.CausalDecoder(td.DecoderConfig(**CONFIGS[0], dtype=torch.float16), device="cpu")


# --------------------------------------------------------------- sampling


def test_seeded_sampling_repeats_and_differs_from_greedy():
    _, _, tdec = pair(CONFIGS[0], 0)
    _, _, tids, tmask = batch(PROMPTS, 24)

    def sample(seed):
        return tdec.generate(tids, tmask, 16, temperature=1.5,
                             generator=torch.Generator().manual_seed(seed))[0]

    assert torch.equal(sample(7), sample(7))
    assert not torch.equal(sample(7), sample(8))
    assert not torch.equal(sample(7), tdec.generate(tids, tmask, 16)[0])


def test_torch_lm_sampling_advances_across_calls():
    """Sampled calls advance the model's seed stream (the JAX ``JaxLM``
    regression: a fixed key made every sample identical); a model built
    with the same seed repeats the sequence; temperature 0 stays greedy."""
    cfg = td.DecoderConfig(**CONFIGS[0])

    def texts(temperature, seed=0):
        lm = TorchLM(cfg, max_prompt_len=16, max_new_tokens=12, temperature=temperature,
                     seed=seed, device="cpu")
        return [lm.generate("same prompt").text for _ in range(4)]

    sampled = texts(1.5)
    assert len(set(sampled)) > 1
    assert texts(1.5) == sampled
    assert texts(1.5, seed=1) != sampled
    assert len(set(texts(0.0))) == 1


def test_sampling_frequencies_follow_softmax():
    """With the final layer norm's scale at 0 the logits are the same for
    every input (bias @ embed.T); 40,000 one-token draws at temperature 0.7
    match softmax(logits / 0.7) within 5 standard errors a token."""
    cfg = td.DecoderConfig(hidden=32, layers=1, heads=2, max_len=8)
    tdec = td.CausalDecoder(cfg, device="cpu", seed=5)
    with torch.no_grad():
        tdec.final_ln.scale.zero_()
        tdec.final_ln.bias.copy_(torch.linspace(-30, 30, 32))
        logits = tdec.final_ln.bias @ tdec.embed.T
    n, temp = 40_000, 0.7
    ids = torch.full((n, 1), td.BOS_ID)
    tok = tdec.generate(ids, torch.ones((n, 1), dtype=torch.bool), 1, temperature=temp,
                        generator=torch.Generator().manual_seed(0))[0][:, 0]
    p = torch.softmax(logits.double() / temp, dim=0).numpy()
    freq = np.bincount(tok.numpy(), minlength=cfg.vocab_size) / n
    assert p.max() > 0.05  # a distribution with some peaks, not uniform
    se = np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p) <= 5 * se + 1e-4).all(), np.abs(freq - p).max()
