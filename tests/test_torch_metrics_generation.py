"""The port's generation metrics against the JAX package's, entry by entry.

Both packages score the same seeded inputs (numpy draws over a word list
with non-ASCII words, several references, empty and missing fields). The
host metrics (``bleu``, ``rouge`` in every type with and without the
stemmer, ``meteor``, ``exact_match``, ``token_f1``) must be equal bitwise;
``sem_score`` runs each package's ``MockEmbedding``, ``response_relevancy``
its ``MockLLM`` and embedding, also bitwise. The model-backed metrics run
the same tiny random-init checkpoints (``tests/tiny_models.py``) through
both copies of ``model_scorers`` on the CPU: equal within 1e-6 absolute
(the same PyTorch code on the same weights; the bound only allows for a
thread-count-dependent reduction order). Without ``transformers`` or a
checkpoint both raise their package's ``ModelLoadError``. The port's scorers
run on the ``device`` they are given (the Executor's ``BuildContext`` device):
asked for CUDA without a card they raise.
"""

import importlib
import math
import sys
import types

import numpy as np
import pytest

from tiny_models import build_encoder_checkpoint, build_seq2seq_checkpoint, build_seqcls_checkpoint

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)
MODEL_TOL = 1e-6
WORDS = ("the cat sat on a mat paris is capital of france berlin germany dogs run "
         "fast café naïve über straße 東京 rain falls in spain mostly plain").split()


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _gen(pkg):
    return _mod(pkg, "evaluation.metrics.generation")


def _sentence(rng, lo=1, hi=12):
    return " ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))


def _inputs(pkg, seed=0, n=24):
    """Seeded metric inputs, the same for both packages, in ``pkg``'s
    ``MetricInput``; the last rows are edge cases."""
    rng = np.random.default_rng(seed)
    mi_cls = _mod(pkg, "schema").MetricInput
    rows = []
    for _ in range(n):
        gts = [_sentence(rng) for _ in range(int(rng.integers(1, 4)))]
        gen = gts[0] if rng.random() < 0.2 else _sentence(rng)
        rows.append(mi_cls(
            generated_texts=gen, generation_gt=gts, query=_sentence(rng, 3, 8),
            retrieved_contents=[_sentence(rng, 4, 16) for _ in range(2)],
        ))
    rows += [
        mi_cls(generated_texts="The  Quick, Brown Fox!", generation_gt=["quick brown fox"]),
        mi_cls(generated_texts="", generation_gt=[""]),
        mi_cls(generated_texts="an answer", generation_gt=None),
        mi_cls(generated_texts=None, generation_gt=["x"]),
        mi_cls(generated_texts="Paris.", generation_gt=["paris", "London"]),
        mi_cls(),
    ]
    return rows


HOST_CASES = [
    ("exact_match", {}),
    ("token_f1", {}),
    ("bleu", {}),
    ("bleu", {"max_ngram_order": 2}),
    ("rouge", {"rouge_type": "rouge1"}),
    ("rouge", {"rouge_type": "rouge2"}),
    ("rouge", {"rouge_type": "rougeL"}),
    ("rouge", {"rouge_type": "rougeLsum"}),
    ("rouge", {"rouge_type": "rougeL", "use_stemmer": True}),
    ("meteor", {}),
    ("meteor", {"alpha": 0.8, "beta": 2.0, "gamma": 0.4}),
]


@pytest.mark.parametrize("name,kwargs", HOST_CASES, ids=[f"{n}-{k}" for n, k in HOST_CASES])
def test_host_metric_bitwise(name, kwargs):
    out = {pkg: _gen(pkg).GENERATION_METRICS[name](_inputs(pkg), **kwargs) for pkg in PKGS}
    assert out[TORCH] == out[JAX]
    assert any(v is not None and v > 0 for v in out[TORCH])


def test_registry_keys_equal():
    assert list(_gen(TORCH).GENERATION_METRICS) == list(_gen(JAX).GENERATION_METRICS)
    for name, fn in _gen(TORCH).GENERATION_METRICS.items():
        assert fn.__module__ == f"{TORCH}.evaluation.metrics.generation", name


@pytest.mark.parametrize("text", ["The  Quick, Brown Fox!", "An apple a day", "", "Ünïcode  déjà-vu"])
def test_normalize_and_sentence_bleu_equal(text):
    assert _gen(TORCH).normalize_string(text) == _gen(JAX).normalize_string(text)
    refs = ["the quick brown fox", text]
    assert _gen(TORCH).sentence_bleu(text, refs) == _gen(JAX).sentence_bleu(text, refs)


def test_sem_score_with_mock_embedding():
    out = {pkg: _gen(pkg).sem_score(_inputs(pkg), embedding_model=_mod(pkg, "embeddings")
                                    .MockEmbedding(dim=32)) for pkg in PKGS}
    assert out[TORCH] == out[JAX]
    assert out[TORCH][0] is not None


def _relevancy_llm(pkg, broken_every=0):
    calls = {"n": 0}

    def responder(prompt):
        calls["n"] += 1
        if broken_every and calls["n"] % broken_every == 0:
            return "not json"
        word = prompt.split()[-1]
        return f'{{"question": "what is {word}", "noncommittal": {calls["n"] % 5 == 0:d}}}'

    return _mod(pkg, "llm").MockLLM(responder=responder)


@pytest.mark.parametrize("strictness,broken_every", [(1, 0), (3, 0), (3, 2)])
def test_response_relevancy_with_mocks(strictness, broken_every):
    out = {}
    for pkg in PKGS:
        emb = _mod(pkg, "data.synthetic").BagOfTokensEmbedding(dim=32)
        out[pkg] = _gen(pkg).response_relevancy(
            _inputs(pkg)[:8], llm=_relevancy_llm(pkg, broken_every), embedding_model=emb,
            strictness=strictness)
    assert out[TORCH] == out[JAX]
    assert all(v is None or not math.isnan(v) for v in out[TORCH])


def test_huggingface_evaluate_through_a_local_module(monkeypatch):
    """``huggingface_evaluate`` through an ``evaluate`` module that scores
    locally: both packages pick the same best reference."""

    class _Scorer:
        def compute(self, predictions, references, **kw):
            p, r = set(predictions[0].split()), set(references[0].split())
            return {"overlap": len(p & r) / max(len(r), 1), "other": -1.0}

    fake = types.ModuleType("evaluate")
    fake.load = lambda name: _Scorer()
    monkeypatch.setitem(sys.modules, "evaluate", fake)
    out = {pkg: _gen(pkg).huggingface_evaluate(_inputs(pkg), metric_name="overlap")
           for pkg in PKGS}
    assert out[TORCH] == out[JAX]


def test_huggingface_evaluate_without_the_package_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "evaluate", None)
    for pkg in PKGS:
        with pytest.raises(_mod(pkg, "exceptions").ModelLoadError):
            _gen(pkg).huggingface_evaluate(_inputs(pkg)[:2])


# ------------------------------------------------------------ model-backed


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_ckpts_torch")
    return {
        "seq2seq": build_seq2seq_checkpoint(str(root / "bart")),
        "encoder": build_encoder_checkpoint(str(root / "bert")),
        "seqcls": build_seqcls_checkpoint(str(root / "cls")),
    }


MODEL_CASES = [
    ("bert_score", "encoder", {}),
    ("bart_score_faithfulness", "seq2seq", {}),
    ("bart_score_precision", "seq2seq", {}),
    ("bart_score_recall", "seq2seq", {}),
    ("bart_score_f1", "seq2seq", {}),
    ("unieval", "seq2seq", {}),
    ("align_score", "seqcls", {}),
    ("align_score", "seqcls", {"aggregation": "min"}),
    ("mini_check", "seq2seq", {"support_token_id": 4, "unsupported_token_id": 5}),
    ("mini_check", "seq2seq", {"support_token_id": 4, "unsupported_token_id": 5,
                               "context_strategy": "concat"}),
]


@pytest.mark.parametrize("name,ckpt,kwargs", MODEL_CASES,
                         ids=[f"{n}-{'-'.join(k)}" for n, _, k in MODEL_CASES])
def test_model_backed_metric_matches_jax(checkpoints, name, ckpt, kwargs):
    out = {}
    for pkg in PKGS:
        rows = [mi for mi in _inputs(pkg, seed=1, n=4) if mi.generated_texts]
        on = {"device": "cpu"} if pkg == TORCH else {}
        out[pkg] = _gen(pkg).GENERATION_METRICS[name](
            rows, checkpoint=checkpoints[ckpt], **kwargs, **on)
    assert [v is None for v in out[TORCH]] == [v is None for v in out[JAX]]
    got = np.array([np.nan if v is None else v for v in out[TORCH]], dtype=np.float64)
    ref = np.array([np.nan if v is None else v for v in out[JAX]], dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=MODEL_TOL, equal_nan=True)
    assert np.isfinite(got[~np.isnan(ref)]).all()


@pytest.mark.parametrize("name", ["bert_score", "bart_score_faithfulness", "bart_score_f1",
                                  "unieval", "align_score", "mini_check"])
def test_model_backed_metric_without_checkpoint_raises(tmp_path, name):
    for pkg in PKGS:
        with pytest.raises(_mod(pkg, "exceptions").ModelLoadError):
            _gen(pkg).GENERATION_METRICS[name](
                _inputs(pkg, n=2)[:2], checkpoint=str(tmp_path / "missing"))


def test_model_backed_metric_without_transformers_raises(monkeypatch, tmp_path):
    """The card's machine has no ``transformers``: the scorers raise there,
    they do not fall back."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    scorers = _mod(TORCH, "evaluation.metrics.model_scorers")
    scorers._load_encoder.cache_clear()
    with pytest.raises(_mod(TORCH, "exceptions").ModelLoadError):
        _gen(TORCH).bert_score(_inputs(TORCH, n=2)[:2], checkpoint=str(tmp_path / "any"))


@pytest.mark.parametrize("name,ckpt", [("bert_score", "encoder"), ("unieval", "seq2seq"),
                                       ("align_score", "seqcls")])
def test_model_backed_metric_on_cuda_without_a_card_raises(checkpoints, monkeypatch, name, ckpt):
    """The default device is ``cuda``: without a card the scorer raises, it
    does not score on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows = [mi for mi in _inputs(TORCH, seed=1, n=4) if mi.generated_texts]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _gen(TORCH).GENERATION_METRICS[name](rows, checkpoint=checkpoints[ckpt])


def test_metric_config_gives_model_backed_metrics_the_context_device(checkpoints):
    """``BaseMetricConfig.metric_func`` passes the ``BuildContext`` device to
    the model-backed metrics alone; a config's own ``device`` wins."""
    config = _mod(TORCH, "config")
    ctx = config.BuildContext(device="cpu")
    rows = [mi for mi in _inputs(TORCH, seed=1, n=4) if mi.generated_texts]
    want = _gen(TORCH).bert_score(rows, checkpoint=checkpoints["encoder"], device="cpu")
    bert = config.BaseMetricConfig(name="bert_score", metric_type="generation",
                                   kwargs={"checkpoint": checkpoints["encoder"]})
    assert bert.metric_func(ctx)(rows) == want
    assert ctx.metric_extras(bert) == {"device": "cpu"}
    own = config.BaseMetricConfig(name="bert_score", metric_type="generation",
                                  kwargs={"checkpoint": checkpoints["encoder"], "device": "cpu"})
    assert config.BuildContext(device="cuda").metric_extras(own) == {}
    bleu = config.BaseMetricConfig(name="bleu", metric_type="generation")
    assert ctx.metric_extras(bleu) == {}
    assert bleu.metric_func(ctx)(rows) == _gen(TORCH).bleu(rows)
