"""The port's trainers against the JAX package's: the data builders
(``build_pairs``, ``build_lm_examples``, ``encode_sft``: bitwise), the batches
and per-step losses of ``BiEncoderTrainer`` (sgd, adamw),
``CrossEncoderTrainer`` (random, cycle negatives) and ``LMTrainer`` over about
20 steps from the JAX trainers' initial parameters, the bi-encoder's
checkpoints (the counterparts of ``tests/test_trainer_checkpoint.py``), the
full train-then-serve loop through the port's ``Executor`` (the counterpart
of ``tests/test_lm_trainer.py::test_full_loop_trained_lm_beats_no_retrieval``)
and a (2, 2) mesh run. Everything runs on the CPU (``device="cpu"``).

Tolerance: per-step losses within ``LOSS_TOL`` = 1e-4 relative. The packages
reduce in different f32 orders (one step's loss within 2.3e-7, its weights
within 7.7e-7; ``tests/test_torch_train_steps.py``) and AdamW's f32 bias
correction in optax differs from torch's double one by up to 6.4e-6 of the
learning rate a step, so the weights part a little more each step; over
these 20-odd steps the losses stay within 2e-5.
"""

import numpy as np
import pytest
import torch

from autorag_research_tpu.embeddings.jax_encoder import _flatten_params
from autorag_research_tpu.models import cross_encoder as jce
from autorag_research_tpu.models import lm_trainer as jlt
from autorag_research_tpu.models import trainer as jtr
from autorag_research_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from autorag_research_tpu.models.encoder import EncoderConfig as JaxEncoderConfig
from autorag_research_tpu.store.catalog import Catalog as JaxCatalog
from autorag_research_tpu_torch.models import cross_encoder as tce
from autorag_research_tpu_torch.models import lm_trainer as tlt
from autorag_research_tpu_torch.models import trainer as ttr
from autorag_research_tpu_torch.models.decoder import DecoderConfig
from autorag_research_tpu_torch.models.encoder import EncoderConfig, from_jax_params
from autorag_research_tpu_torch.store.catalog import Catalog

LOSS_TOL = 1e-4
ENC = dict(vocab_size=512, hidden=32, layers=2, heads=2, max_len=8, out_dim=16)
DEC = dict(hidden=32, layers=2, heads=2, max_len=96)
QA = [("Q: capital of france? A:", " paris"), ("Q: color of the sky? A:", " blue"),
      ("Q: legs on a cat? A:", " four"), ("Q: two plus two? A:", " four"),
      ("Q: café ☃? A:", " unicode")]


def fill(cat, or_all, n=24):
    """``n`` topic chunks and queries, one gold chunk each; every third query
    has a second gold chunk, the last query none; generation GT on most."""
    cat.add_chunks([{"id": i, "contents": f"topic {chr(97 + i % 26)}{i} document body {i}"}
                    for i in range(n)])
    cat.add_queries([
        {"id": i, "contents": f"find topic {chr(97 + i % 26)}{i}",
         **({"generation_gt": [f"answer {i}"]} if i % 5 else {})}
        for i in range(n + 1)
    ])
    for i in range(n):
        cat.add_retrieval_gt(i, or_all([i, (i + 7) % n]) if i % 3 == 0 else i)
    return cat


@pytest.fixture
def catalogs(tmp_path):
    from autorag_research_tpu.store.gt import or_all as jax_or_all
    from autorag_research_tpu_torch.store.gt import or_all

    jcat = fill(JaxCatalog(tmp_path / "jax.db"), jax_or_all)
    tcat = fill(Catalog(tmp_path / "port.db"), or_all)
    yield jcat, tcat
    jcat.close()
    tcat.close()


def assert_losses_close(got, ref):
    assert len(got) == len(ref) > 0
    np.testing.assert_allclose(got, ref, rtol=LOSS_TOL, atol=0)


# ------------------------------------------------------------- data builders
def test_build_pairs_equal(catalogs):
    jcat, tcat = catalogs
    ref = jtr.build_pairs(jcat)
    assert ttr.build_pairs(tcat) == ref and len(ref) == 32


def test_build_lm_examples_equal(catalogs):
    jcat, tcat = catalogs
    for kw in ({}, {"max_context_chunks": 1}, {"prompt_template": "{query} | {context} ->"}):
        ref = jlt.build_lm_examples(jcat, **kw)
        assert tlt.build_lm_examples(tcat, **kw) == ref and ref
    assert tlt.DEFAULT_LM_PROMPT == jlt.DEFAULT_LM_PROMPT


@pytest.mark.parametrize("seq_len", [4, 16, 48, 96])
def test_encode_sft_bitwise(seq_len):
    """Long prompts head-truncated, answers overflowing, unicode bytes."""
    examples = [*QA, ("x" * 200, "yes"), ("short", "an answer far longer than the budget")]
    ref, got = jlt.encode_sft(examples, seq_len), tlt.encode_sft(examples, seq_len)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key])


# ------------------------------------------------------------------ trainers
def recorder(obj, name, key):
    """Wrap ``obj.name`` so that every call appends ``key(args)``."""
    calls, fn = [], getattr(obj, name)

    def wrapped(*args, **kw):
        calls.append(key(*args, **kw))
        return fn(*args, **kw)

    setattr(obj, name, wrapped)
    return calls


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_bi_encoder_trainer_matches_jax(catalogs, optimizer):
    jcat, tcat = catalogs
    kw = dict(lr=0.005, batch_size=8, optimizer=optimizer)
    jt = jtr.BiEncoderTrainer(JaxEncoderConfig(**ENC), **kw)
    tt = ttr.BiEncoderTrainer(EncoderConfig(**ENC), device="cpu", **kw)
    tt.encoder.load_state_dict(from_jax_params(_flatten_params(jt.params)))
    j_batches = recorder(jt, "_make_batch", lambda pairs: list(pairs))
    t_batches = recorder(tt, "_make_batch", lambda pairs: list(pairs))
    ref = jt.train(jcat, epochs=5)
    got = tt.train(tcat, epochs=5)
    assert got.steps == ref.steps == 20
    assert t_batches == j_batches
    assert_losses_close(got.losses, ref.losses)
    assert got.losses[-1] < got.losses[0]


@pytest.mark.parametrize("strategy", ["random", "cycle"])
def test_cross_encoder_trainer_matches_jax(catalogs, monkeypatch, strategy):
    jcat, tcat = catalogs
    cfg = {**ENC, "max_len": 16}
    kw = dict(lr=0.01, batch_size=8, negative_strategy=strategy, seed=3)
    jt = jce.CrossEncoderTrainer(JaxEncoderConfig(**cfg), **kw)
    tt = tce.CrossEncoderTrainer(EncoderConfig(**cfg), device="cpu", **kw)
    tt.model.load_state_dict(tce.cross_params_from_jax(_flatten_params(jt.params)))
    batches = {}
    for mod, name in ((jce, "jax"), (tce, "port")):
        calls = batches[name] = []
        fn = mod.pair_tokenize
        monkeypatch.setattr(mod, "pair_tokenize", lambda q, d, *a, fn=fn, calls=calls: (
            calls.append((list(q), list(d))), fn(q, d, *a))[1])
    ref = jt.train(jcat, epochs=10, max_steps=22)
    got = tt.train(tcat, epochs=10, max_steps=22)
    assert got.steps == ref.steps == 22
    assert batches["port"] == batches["jax"] and len(batches["jax"]) == 44
    assert_losses_close(got.losses, ref.losses)


def test_lm_trainer_matches_jax():
    """Same schedule (the ragged tail resampled, chunks padded), same
    per-step losses, ``report.steps`` counting the padded schedule."""
    kw = dict(lr=3e-3, batch_size=2, seq_len=48, seed=1)
    jt = jlt.LMTrainer(JaxDecoderConfig(**DEC), **kw)
    tt = tlt.LMTrainer(DecoderConfig(**DEC), params=_flatten_params(jt.params), device="cpu",
                       **kw)
    j_rows, t_rows = [], []
    run = jt._run_steps

    def jax_run(params, opt_state, batches):
        j_rows.extend(np.asarray(batches["ids"]))
        return run(params, opt_state, batches)

    jt._run_steps = jax_run
    recorder(tt, "step", lambda batch: t_rows.append(batch["ids"].numpy()))
    ref = jt.train(list(QA), epochs=7, max_steps=20)
    got = tt.train(list(QA), epochs=7, max_steps=20)
    assert got.steps == ref.steps == len(got.losses) == 20
    np.testing.assert_array_equal(np.stack(t_rows), np.stack(j_rows))
    assert_losses_close(got.losses, ref.losses)


def test_lm_trainer_pads_the_tail_chunk():
    """``max(1, min(128, steps, (256 << 20) // (B·T·6)))``-step chunks, the
    tail padded by resampling: the JAX test's ``200 <= steps <= 328`` band,
    here exactly the JAX schedule."""
    jt = jlt.LMTrainer(JaxDecoderConfig(**DEC), batch_size=4, seq_len=16)
    tt = tlt.LMTrainer(DecoderConfig(**DEC), batch_size=4, seq_len=16, device="cpu")
    order, chunk = tt.schedule(len(QA), epochs=100)
    assert chunk == 128 and order.shape == (256, 4)
    rows = []
    run = jt._run_steps
    jt._run_steps = lambda p, s, b: (rows.extend(np.asarray(b["ids"])), run(p, s, b))[1]
    ref = jt.train(list(QA), epochs=100, max_steps=None)
    assert ref.steps == order.shape[0]
    data = tlt.encode_sft(list(QA), 16)
    np.testing.assert_array_equal(np.stack(rows), data["ids"][order])


# --------------------------------------------------------------- checkpoints
CK = dict(vocab_size=512, hidden=32, layers=2, heads=2, max_len=8, out_dim=16)


def test_save_restore_roundtrip(catalogs, tmp_path):
    _, tcat = catalogs
    trainer = ttr.BiEncoderTrainer(EncoderConfig(**CK), lr=0.005, batch_size=8,
                                   optimizer="adamw", device="cpu")
    trainer.train(tcat, epochs=3)
    ckdir = tmp_path / "ckpts"
    trainer.save_checkpoint(ckdir, 3)

    fresh = ttr.BiEncoderTrainer(EncoderConfig(**CK), lr=0.005, batch_size=8,
                                 optimizer="adamw", seed=99, device="cpu")
    assert fresh.restore_checkpoint(ckdir) == 3
    for (name, a), (_, b) in zip(trainer.encoder.state_dict().items(),
                                 fresh.encoder.state_dict().items()):
        assert torch.equal(a, b), name
    a, b = trainer._opt.state_dict(), fresh._opt.state_dict()
    assert a["param_groups"] == b["param_groups"] and a["state"].keys() == b["state"].keys()
    for i in a["state"]:
        for key, value in a["state"][i].items():
            assert torch.equal(value, b["state"][i][key]), (i, key)
    # the two continue alike (the data order comes from the seed)
    fresh.seed = trainer.seed
    assert trainer.train(tcat, epochs=1).losses == fresh.train(tcat, epochs=1).losses


def test_auto_resume_continues_step_count(catalogs, tmp_path):
    _, tcat = catalogs
    ckdir = tmp_path / "ckpts"

    def trainer():
        return ttr.BiEncoderTrainer(EncoderConfig(**CK), lr=0.005, batch_size=8, device="cpu")

    r1 = trainer().train(tcat, epochs=2, checkpoint_dir=ckdir, checkpoint_every=2)
    assert r1.steps == 8
    assert ttr.BiEncoderTrainer.latest_checkpoint(ckdir).name == "step_8"
    # a resume at 5: the newest checkpoint is step 5
    t5 = trainer()
    t5.train(tcat, epochs=2, max_steps=5, checkpoint_dir=tmp_path / "at5")
    assert ttr.BiEncoderTrainer.latest_checkpoint(tmp_path / "at5").name == "step_5"
    # a new trainer resumes at step 5 and max_steps counts TOTAL steps
    t2 = trainer()
    r2 = t2.train(tcat, epochs=10, max_steps=8, checkpoint_dir=tmp_path / "at5")
    assert r2.steps == 3  # only the 3 missing steps ran
    assert ttr.BiEncoderTrainer.latest_checkpoint(tmp_path / "at5").name == "step_8"
    assert {p.name for p in (tmp_path / "at5").iterdir()} == {"step_5", "step_8"}
    # already at max_steps -> no-op
    r3 = trainer().train(tcat, epochs=10, max_steps=8, checkpoint_dir=tmp_path / "at5")
    assert r3.steps == 0


def test_resume_no_checkpoint_is_fresh_start(catalogs, tmp_path):
    _, tcat = catalogs
    t = ttr.BiEncoderTrainer(EncoderConfig(**CK), batch_size=8, device="cpu")
    assert t.restore_checkpoint(tmp_path / "nowhere") == 0
    r = t.train(tcat, epochs=2, checkpoint_dir=tmp_path / "new")
    assert r.steps == 8
    assert ttr.BiEncoderTrainer.latest_checkpoint(tmp_path / "new").name == "step_8"


def test_mesh_refused_naming_item_6(catalogs):
    """ROADMAP.md item 6b is in: ``BiEncoderTrainer(mesh=)`` trains over a
    (dp, tp) mesh, here (2, 2) on the CPU, to the unsharded trainer's losses
    (``tests/test_torch_mesh_training.py`` holds it against JAX)."""
    from autorag_research_tpu_torch.parallel.mesh import train_mesh

    _, tcat = catalogs
    mesh = train_mesh([torch.device("cpu")] * 4)
    meshed = ttr.BiEncoderTrainer(EncoderConfig(**CK), batch_size=8, mesh=mesh, device="cpu")
    plain = ttr.BiEncoderTrainer(EncoderConfig(**CK), batch_size=8, device="cpu")
    got, ref = meshed.train(tcat, epochs=2), plain.train(tcat, epochs=2)
    assert got.steps == ref.steps == 8
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-5)


# ------------------------------------------------------- trained -> serving
def test_wrappers_serve_the_trained_weights(catalogs, tmp_path):
    """``as_embedding``, ``as_reranker``, ``to_llm`` and each ``save`` give
    the trained module's outputs."""
    from autorag_research_tpu_torch.embeddings.torch_encoder import TorchEncoderEmbedding
    from autorag_research_tpu_torch.llm.torch_lm import TorchLM
    from autorag_research_tpu_torch.rerankers.torch_cross import TorchCrossEncoderReranker

    _, tcat = catalogs
    texts = ["find topic a0", "topic b1 document body 1", ""]
    bi = ttr.BiEncoderTrainer(EncoderConfig(**CK), batch_size=8, device="cpu")
    bi.train(tcat, epochs=1)
    bi.save(tmp_path / "bi.npz")
    loaded = TorchEncoderEmbedding(EncoderConfig(**CK), params_path=tmp_path / "bi.npz",
                                   device="cpu").embed_texts(texts)
    np.testing.assert_array_equal(bi.as_embedding().embed_texts(texts), loaded)

    cross = tce.CrossEncoderTrainer(EncoderConfig(**{**CK, "max_len": 16}), batch_size=8,
                                    device="cpu")
    cross.train(tcat, max_steps=2)
    cross.save(tmp_path / "cross.npz")
    r = TorchCrossEncoderReranker(EncoderConfig(**{**CK, "max_len": 16}),
                                  params_path=tmp_path / "cross.npz", device="cpu")
    assert torch.equal(cross.as_reranker().score_pairs("q", texts), r.score_pairs("q", texts))

    lm = tlt.LMTrainer(DecoderConfig(**DEC), batch_size=2, seq_len=48, device="cpu")
    lm.train(list(QA), epochs=1)
    lm.save(str(tmp_path / "lm.npz"))
    kw = dict(max_prompt_len=48, max_new_tokens=8)
    served = TorchLM(DecoderConfig(**DEC), checkpoint=str(tmp_path / "lm.npz"), device="cpu",
                     **kw)
    prompts = [p for p, _ in QA]
    assert lm.to_llm(**kw).generate_batch(prompts) == served.generate_batch(prompts)


def test_full_loop_trained_lm_beats_no_retrieval(tmp_path):
    """ingest -> train -> index -> generate -> evaluate on the port:
    ``basic_rag`` over ``bm25`` with the trained ``TorchLM`` through the
    port's ``Executor`` answers from retrieved context; the no-retrieval
    ablation (same LM, context withheld) scores worse."""
    from autorag_research_tpu_torch.config import BaseMetricConfig, BuildContext, ExecutorConfig
    from autorag_research_tpu_torch.evaluation.metrics.generation import exact_match
    from autorag_research_tpu_torch.executor import Executor
    from autorag_research_tpu_torch.pipelines.generation.basic_rag import BasicRAGConfig
    from autorag_research_tpu_torch.pipelines.retrieval.bm25 import BM25Config
    from autorag_research_tpu_torch.schema import MetricInput

    cat = Catalog(tmp_path / "lm.db")
    cat.add_chunks([
        {"id": 0, "contents": "paris is the capital of france"},
        {"id": 1, "contents": "berlin is the capital of germany"},
        {"id": 2, "contents": "the sky is blue on clear days"},
    ])
    cat.add_queries([
        {"id": 0, "contents": "capital of france", "generation_gt": ["paris"]},
        {"id": 1, "contents": "capital of germany", "generation_gt": ["berlin"]},
        {"id": 2, "contents": "color of the sky", "generation_gt": ["blue"]},
        {"id": 3, "contents": "no gt query"},  # skipped: no generation_gt
    ])
    for i in range(3):
        cat.add_retrieval_gt(i, i)

    cfg = DecoderConfig(hidden=128, layers=2, heads=4, max_len=384)
    trainer = tlt.LMTrainer(cfg, lr=3e-3, batch_size=3, seq_len=192, device="cpu")
    report = trainer.train(cat, epochs=250)
    assert report.final_loss < 0.05, report.losses[-5:]
    llm = trainer.to_llm(max_prompt_len=320, max_new_tokens=16)

    config = ExecutorConfig(
        pipelines=[BasicRAGConfig(name="rag_torchlm", retrieval_pipeline_name="bm25", llm=llm,
                                  top_k=1)],
        metrics=[BaseMetricConfig(name="exact_match", metric_type="generation"),
                 BaseMetricConfig(name="token_f1", metric_type="generation")],
        health_check=False,
    )
    ctx = BuildContext(device="cpu", pipeline_configs={"bm25": BM25Config(name="bm25")})
    result = Executor(cat, config, ctx).run()
    assert result.success, result.report()
    em_rag = {m.metric_name: m for m in result.pipelines[0].metrics}["exact_match"].average

    queries = [("capital of france", "paris"), ("capital of germany", "berlin"),
               ("color of the sky", "blue")]
    prompts = [tlt.DEFAULT_LM_PROMPT.format(context="(no context retrieved)", query=q)
               for q, _ in queries]
    outs = llm.generate_batch(prompts)
    em_ablation = np.mean(exact_match([MetricInput(generated_texts=o, generation_gt=[a])
                                       for o, (_, a) in zip(outs, queries)]))
    assert em_rag >= 2 / 3, (em_rag, outs)
    assert em_rag > em_ablation, (em_rag, em_ablation, outs)
    cat.close()
