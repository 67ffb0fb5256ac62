"""The port's LLM layer against the JAX package's: ``MockLLM`` /
``ScriptedLLM`` (``llm/base.py``), ``TorchLM`` against ``JaxLM`` on carried
weights, the ``.npz`` checkpoints in both directions, and the model
registry's LLM kinds.

``TorchLM`` and ``JaxLM`` run the same weights (a ``JaxLM`` checkpoint
loaded into ``TorchLM``): greedy texts and ``token_usage`` are equal, except
that a row may differ from its first step whose top-2 logit margin in the
JAX decoder is below ``NEAR_TIE`` (see ``tests/test_torch_decoder.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_decoder import NEAR_TIE, jax_step_logits

from autorag_research_tpu.llm import JaxLM
from autorag_research_tpu.models import decoder as jd
from autorag_research_tpu_torch.llm import TorchLM
from autorag_research_tpu_torch.models import decoder as td

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)
SMALL = dict(hidden=32, layers=2, heads=2, max_len=64)
PROMPTS = ["What is the capital of France?", "hi", "", "unicode: café ☃",
           "Context:\nParis is the capital of France.\n\nQuestion: capital?\n\nAnswer:"]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def lm_pair(tmp_path, seed=7, prompt=32, new=8):
    jlm = JaxLM(config=jd.DecoderConfig(**SMALL), max_prompt_len=prompt, max_new_tokens=new,
                seed=seed)
    path = str(tmp_path / f"lm{seed}.npz")
    jlm.save(path)
    tlm = TorchLM(td.DecoderConfig(**SMALL), max_prompt_len=prompt, max_new_tokens=new,
                  checkpoint=path, device="cpu")
    return jlm, tlm


def assert_rows_equal_but_near_ties(jlm, tlm, prompts, got, ref, batched=False):
    """``got`` / ``ref``: LLMResult rows for ``prompts``. Equal, or the
    port's tokens first differ from the JAX decoder's at a step whose top-2
    margin in the JAX logits is below ``NEAR_TIE``."""
    port_tokens = tlm._decode(prompts)[0] if batched else None
    for i, (prompt, g, r) in enumerate(zip(prompts, got, ref)):
        assert g.token_usage["prompt_tokens"] == r.token_usage["prompt_tokens"]
        if g.text == r.text and g.token_usage == r.token_usage:
            continue
        ids, mask = jd.byte_tokenize([prompt], jlm.max_prompt_len)
        jtok = np.asarray(jlm.decoder.generate(jlm.params, jnp.asarray(ids), jnp.asarray(mask),
                                               jlm.max_new_tokens)[0])
        tok = port_tokens[i] if batched else tlm._decode([prompt])[0][0]
        step = int(np.flatnonzero(tok != jtok[0])[0])
        top2 = np.sort(jax_step_logits(jlm.decoder, jlm.params, ids, mask, jtok)[0, step])[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, (prompt, step, top2)


# ------------------------------------------------------------ fake LLMs


@pytest.mark.parametrize("prompt", PROMPTS)
def test_mock_llm_matches_jax(prompt):
    out = {pkg: _mod(pkg, "llm").MockLLM().generate(prompt) for pkg in PKGS}
    assert out[TORCH].text == out[JAX].text
    assert out[TORCH].token_usage == out[JAX].token_usage
    assert out[TORCH].logprobs == out[JAX].logprobs
    responder = {pkg: _mod(pkg, "llm").MockLLM(responder=lambda p: p[::-1], logprob_value=-0.5)
                 for pkg in PKGS}
    got = {pkg: r.generate(prompt) for pkg, r in responder.items()}
    assert got[TORCH].text == got[JAX].text == prompt[::-1]
    assert got[TORCH].token_usage == got[JAX].token_usage
    assert got[TORCH].logprobs == got[JAX].logprobs
    assert responder[TORCH].calls == responder[JAX].calls == [prompt]


def test_scripted_llm_matches_jax():
    out = {}
    for pkg in PKGS:
        llm = _mod(pkg, "llm").ScriptedLLM(responses=["first", "second answer"],
                                           rules=[(r"Search:", "rule hit")])
        rows = [llm.generate(p) for p in ("a question", "Search: x", "another question")]
        with pytest.raises(RuntimeError, match="no responses left"):
            llm.generate("one too many")
        out[pkg] = [(r.text, r.token_usage) for r in rows] + [llm.calls]
    assert out[TORCH] == out[JAX]


def test_health_checks_match():
    for pkg in PKGS:
        _mod(pkg, "llm").MockLLM().health_check()
        with pytest.raises(_mod(pkg, "exceptions").HealthCheckError):
            _mod(pkg, "llm").MockLLM(responder=lambda p: "").health_check()


# --------------------------------------------------------------- TorchLM


@pytest.mark.parametrize("seed", [0, 7])
def test_torch_lm_texts_and_usage_match_jax_lm(tmp_path, seed):
    jlm, tlm = lm_pair(tmp_path, seed=seed)
    got = [tlm.generate(p) for p in PROMPTS]
    ref = [jlm.generate(p) for p in PROMPTS]
    assert_rows_equal_but_near_ties(jlm, tlm, PROMPTS, got, ref)
    for g in got:
        usage = g.token_usage
        assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]
        assert usage["completion_tokens"] <= 8
        assert g.metadata == {"model": "torch_lm", "on_device": True}
    assert got[1].token_usage["prompt_tokens"] == len("hi") + 1  # BOS + bytes
    assert tlm.calls == PROMPTS


def test_torch_lm_batch_results_match_single_path(tmp_path):
    jlm, tlm = lm_pair(tmp_path)
    rows = tlm.generate_batch_results(PROMPTS)
    single = [tlm.generate(p) for p in PROMPTS]
    assert len(rows) == len(PROMPTS)
    assert_rows_equal_but_near_ties(jlm, tlm, PROMPTS, rows, single, batched=True)
    assert tlm.generate_batch(PROMPTS) == [r.text for r in rows]
    ref = jlm.generate_batch_results(PROMPTS)
    assert_rows_equal_but_near_ties(jlm, tlm, PROMPTS, rows, ref, batched=True)


def test_jax_checkpoint_loads_into_torch_lm_bitwise(tmp_path):
    jlm, tlm = lm_pair(tmp_path, seed=3)
    with np.load(str(tmp_path / "lm3.npz")) as data:
        flat = {k: data[k] for k in data.files}
    state = tlm.decoder.state_dict()
    assert sorted(state) == sorted(flat)
    for name, arr in flat.items():
        assert np.array_equal(state[name].numpy(), arr), name


def test_torch_lm_checkpoint_loads_into_jax_lm(tmp_path):
    tlm = TorchLM(td.DecoderConfig(**SMALL), max_prompt_len=32, max_new_tokens=8, seed=11,
                  device="cpu")
    path = str(tmp_path / "torch_lm.npz")
    tlm.save(path)
    jlm = JaxLM(config=jd.DecoderConfig(**SMALL), max_prompt_len=32, max_new_tokens=8, seed=0)
    jlm.load(path)
    from autorag_research_tpu.llm.jax_lm import _flatten

    for name, arr in _flatten(jlm.params).items():
        assert np.array_equal(arr, tlm.decoder.state_dict()[name].numpy()), name
    assert_rows_equal_but_near_ties(jlm, tlm, PROMPTS, [tlm.generate(p) for p in PROMPTS],
                                    [jlm.generate(p) for p in PROMPTS])
    # and back: a second TorchLM from the JAX model's save is the same model
    jlm.save(str(tmp_path / "back.npz"))
    again = TorchLM(td.DecoderConfig(**SMALL), max_prompt_len=32, max_new_tokens=8,
                    checkpoint=str(tmp_path / "back.npz"), device="cpu")
    for name, t in again.decoder.state_dict().items():
        assert torch.equal(t, tlm.decoder.state_dict()[name]), name


def test_torch_lm_params_from_jax_dict(tmp_path):
    jlm, tlm = lm_pair(tmp_path, seed=5)
    from autorag_research_tpu.llm.jax_lm import _flatten

    direct = TorchLM(td.DecoderConfig(**SMALL), params=_flatten(jlm.params), max_prompt_len=32,
                     max_new_tokens=8, device="cpu")
    assert [direct.generate(p).text for p in PROMPTS] == [tlm.generate(p).text for p in PROMPTS]


def test_torch_lm_asks_for_cuda_by_default():
    """Construction on the default device raises where there is no GPU; it
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        TorchLM(td.DecoderConfig(**SMALL), max_prompt_len=32, max_new_tokens=8)


# -------------------------------------------------------------- registry


def _registry(tmp_path, pkg=TORCH, **kw):
    reg = _mod(pkg, "injection").ModelRegistry(tmp_path, **kw)
    return reg


def test_registry_torch_lm_on_registry_device_from_yaml(tmp_path):
    (tmp_path / "llm").mkdir()
    spec = {"type": "torch_lm", **SMALL, "max_prompt_len": 32, "max_new_tokens": 8, "seed": 4}
    (tmp_path / "llm" / "small.yaml").write_text(yaml.dump(spec))
    (tmp_path / "llm" / "small_bf16.yaml").write_text(yaml.dump({**spec, "dtype": "bfloat16"}))
    reg = _registry(tmp_path, device="cpu")
    lm = reg.load_llm("small")
    assert isinstance(lm, TorchLM) and lm.device.type == "cpu"
    assert lm.config == td.DecoderConfig(**SMALL) and lm.max_new_tokens == 8
    assert reg.load_llm("small") is lm  # cached
    bf16 = reg.load_llm("small_bf16")
    assert bf16.config.dtype == torch.bfloat16
    # the JAX registry builds jax_lm from the same fields
    (tmp_path / "llm" / "jsmall.yaml").write_text(yaml.dump({**spec, "type": "jax_lm"}))
    jlm = _registry(tmp_path, JAX).load_llm("jsmall")
    assert jlm.config.hidden == lm.config.hidden and jlm.max_new_tokens == lm.max_new_tokens


def test_registry_torch_lm_bad_dtype_refused(tmp_path):
    (tmp_path / "llm").mkdir()
    (tmp_path / "llm" / "half.yaml").write_text(yaml.dump({"type": "torch_lm", "dtype": "float16"}))
    with pytest.raises(_mod(TORCH, "exceptions").ModelLoadError, match="float32, bfloat16"):
        _registry(tmp_path, device="cpu").load_llm("half")


@pytest.mark.parametrize("name", ["mock", "scripted"])
def test_registry_builtin_fake_llms(tmp_path, name):
    reg = _registry(tmp_path, device="cpu", health_check=False)
    jreg = _registry(tmp_path, JAX, health_check=False)
    got, ref = reg.load_llm(name), jreg.load_llm(name)
    assert type(got).__module__ == f"{TORCH}.llm.base"
    assert type(got).__name__ == type(ref).__name__
    if name == "mock":
        assert got.generate("q").text == ref.generate("q").text


def test_registry_jax_lm_names_torch_lm():
    with pytest.raises(_mod(TORCH, "exceptions").ModelLoadError, match="'torch_lm'"):
        _mod(TORCH, "injection").ModelRegistry(device="cpu").load_llm("jax_lm")
