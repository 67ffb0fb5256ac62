"""The port's 15 agentic generation pipelines against the JAX package's:
``tests/test_generation_agents.py``'s cases, each run through both packages.

Every case builds one catalog (``build`` with the port's ``Catalog``, then a
copy of the file a package) and runs the same LLM script through the JAX
pipeline over the JAX ``BM25Pipeline`` and through the port's over the
port's (``device="cpu"``). The answer, token usage, metadata, the prompts
each LLM received and the ``retrieved`` ids in their order must be equal;
scores, in ``retrieved`` and in the metadata, within 1e-6 of max(1, |s|).
The JAX test's own assertions then hold for the port's result.

The last case runs all 15 pipelines from the ``init`` templates through
both CLIs' ``run`` (the ``Executor``), with ``TorchLM`` and ``JaxLM`` at
hidden 32 on one checkpoint (greedy): each query's row of each pipeline is
equal, unless the two decoders' replies first differ at a step whose top-2
margin in the JAX logits is below ``NEAR_TIE``; such rows are counted.
"""

import contextvars
import importlib
import json
import random
import shutil
import sqlite3

import numpy as np
import pytest
import yaml

JAX, TORCH = "autorag_research_tpu", "autorag_research_tpu_torch"
PKGS = (JAX, TORCH)
DOCS = [
    "Paris is the capital of France.",
    "Berlin is the capital of Germany.",
    "The Seine river flows through Paris.",
    "Germany borders France to the east.",
]
SCORE_TOL = 1e-6


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _kw(pkg):
    return {"device": "cpu"} if pkg == TORCH else {}


def gen(pkg, module):
    return _mod(pkg, f"pipelines.generation.{module}")


@pytest.fixture(autouse=True)
def clear_cache():
    for pkg in PKGS:
        _mod(pkg, "index.registry").invalidate()
    yield
    for pkg in PKGS:
        _mod(pkg, "index.registry").invalidate()


def _agents_catalog(cat):
    """``tests/test_generation_agents.py``'s catalog."""
    cat.add_chunks([{"id": i, "contents": d} for i, d in enumerate(DOCS)])
    cat.add_queries([{"id": 0, "contents": "What is the capital of France?",
                      "generation_gt": ["Paris"]}])
    cat.add_retrieval_gt(0, 0)


def copies(tmp_path, build=_agents_catalog, **cat_kw):
    """``build(Catalog)`` once with the port's catalog, then one copy of the
    file per package, opened by that package's ``Catalog``."""
    src = tmp_path / "src.db"
    cat = _mod(TORCH, "store.catalog").Catalog(src, **cat_kw)
    build(cat)
    cat.close()
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir(exist_ok=True)
        shutil.copy(src, tmp_path / pkg / "a.db")
        out[pkg] = _mod(pkg, "store.catalog").Catalog(tmp_path / pkg / "a.db", **cat_kw)
    return out


@pytest.fixture
def cats(tmp_path):
    return copies(tmp_path)


def bm25(pkg, cat):
    return _mod(pkg, "pipelines.retrieval.bm25").BM25Pipeline(cat, "bm25_sub", **_kw(pkg))


def scripted(pkg, responses):
    return _mod(pkg, "llm").ScriptedLLM(responses=list(responses))


def mock(pkg, responder):
    return _mod(pkg, "llm").MockLLM(responder=responder)


def assert_close(got, ref, where="result"):
    """Equal structures; floats within ``SCORE_TOL`` of max(1, |ref|)."""
    if isinstance(ref, float) or isinstance(got, float):
        assert isinstance(got, (int, float)) and isinstance(ref, (int, float)), (where, got, ref)
        assert abs(got - ref) <= SCORE_TOL * max(1.0, abs(ref)), (where, got, ref)
    elif isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys(), (where, got, ref)
        for key in ref:
            assert_close(got[key], ref[key], f"{where}[{key!r}]")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref), (where, got, ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close(g, r, f"{where}[{i}]")
    else:
        assert got == ref, (where, got, ref)


def assert_results_equal(got, ref):
    assert got.text == ref.text
    assert got.token_usage == ref.token_usage
    assert_close(got.metadata, ref.metadata, "metadata")
    assert (got.retrieved is None) == (ref.retrieved is None)
    if ref.retrieved is not None:
        assert [h["doc_id"] for h in got.retrieved] == [h["doc_id"] for h in ref.retrieved]
        assert_close([float(h["score"]) for h in got.retrieved],
                     [float(h["score"]) for h in ref.retrieved], "retrieved")


def run_both(cats, make, top_k=3, query_id=0):
    """``make(pkg, cat)`` -> (pipeline, [LLMs]) for each package; runs
    ``_generate(query_id, top_k)`` in both and holds the port's result and
    every LLM's prompts against the JAX package's. Returns the port's
    result and its LLMs."""
    out = {}
    for pkg, cat in cats.items():
        pipe, llms = make(pkg, cat)
        result = _mod(pkg, "utils.concurrency").run_async(pipe._generate(query_id, top_k))
        out[pkg] = (result, llms)
    (got, t_llms), (ref, j_llms) = out[TORCH], out[JAX]
    assert_results_equal(got, ref)
    assert [llm.calls for llm in t_llms] == [llm.calls for llm in j_llms]
    return got, t_llms


def simple(module, cls, responses, name=None, **kw):
    """A ``make`` for a pipeline over the BM25 leg with one ScriptedLLM."""

    def make(pkg, cat):
        llm = scripted(pkg, responses)
        args = (cat,) if name is None else (cat, name)
        pipe = getattr(gen(pkg, module), cls)(*args, retrieval_pipeline=bm25(pkg, cat), llm=llm, **kw)
        return pipe, [llm]

    return make


# -------------------------------------------- tests/test_generation_agents.py


def test_ircot_terminates_on_answer(cats):
    out, _ = run_both(cats, simple("ircot", "IRCoTPipeline", [
        "The question asks about France's capital.", "answer is: Paris"], max_steps=4))
    assert out.text == "Paris"
    assert out.metadata["steps"] == 2
    assert out.metadata["context_chunk_ids"]


def test_ircot_budget_fallback(cats):
    out, _ = run_both(cats, simple("ircot", "IRCoTPipeline",
                                   ["thinking...", "still thinking...", "Paris"], "ircot2",
                                   max_steps=2))
    assert out.text == "Paris"  # QA fallback prompt consumed the last response


def test_search_r1_protocol(cats):
    out, _ = run_both(cats, simple("search_r1", "SearchR1Pipeline", [
        "<think>need info</think><search>capital of France</search>trailing junk",
        "<think>got it</think><answer>Paris</answer>",
    ]))
    assert out.text == "Paris"
    assert out.metadata["terminated_by"] == "answer"
    assert "<information>" in out.metadata["rollout"]
    assert "trailing junk" not in out.metadata["rollout"]  # truncated at action


def test_search_r1_budget_fallback(cats):
    out, _ = run_both(cats, simple("search_r1", "SearchR1Pipeline",
                                   ["<search>France</search>", "<search>capital</search>", "Paris"],
                                   "sr2", max_actions=2))
    assert out.text == "Paris"
    assert out.metadata["terminated_by"] == "budget_exhausted_fallback"


def test_self_rag_loop(cats):
    out, _ = run_both(cats, simple("self_rag", "SelfRAGPipeline", [
        "Maybe Lyon",
        '{"should_retrieve": true, "is_supported": false, "retrieval_query": "capital of France", '
        '"critique": "unsupported"}',
        "Paris",
        '{"should_retrieve": false, "is_supported": true, "retrieval_query": "", "critique": "ok"}',
    ]))
    assert out.text == "Paris"
    assert len(out.metadata["critiques"]) == 2


@pytest.mark.parametrize("script, route, text", [
    (["simple", "Paris"], "zero", "Paris"),
    (["moderate", "Paris"], "single", "Paris"),
    (["complex", "answer is: Paris"], "multi", "Paris"),  # early answer, case kept
])
def test_adaptive_rag_routes(cats, script, route, text):
    out, _ = run_both(cats, simple("adaptive_rag", "AdaptiveRAGPipeline", script, f"ar_{route}"))
    assert out.text == text and out.metadata["route"] == route
    assert bool(out.metadata["context_chunk_ids"]) == (route != "zero")


def test_question_decomposition_gen(cats):
    out, _ = run_both(cats, simple("question_decomposition",
                                   "QuestionDecompositionGenerationPipeline",
                                   ["Which country?\nWhat is its capital?", "Paris"]))
    assert out.text == "Paris"
    assert len(out.metadata["subquestions"]) == 2


@pytest.mark.parametrize("script, n_selected", [
    (["1, 2", "Paris"], 2),
    (["none", "Paris from memory"], 0),
    # reference semantics: only a LEADING 'None' is a zero-doc decision
    (["1, 2 are useful; none of the others help.", "Paris"], 2),
    (["None of the documents 1, 2 are useful.", "memory"], 0),
], ids=["selection", "empty_selection", "mid_text_none", "leading_none"])
def test_dynamic_rag_selection(cats, script, n_selected):
    out, _ = run_both(cats, simple("dynamic_rag", "DynamicRAGPipeline", script))
    assert len(out.metadata["selected_chunk_ids"]) == n_selected
    if n_selected:
        assert out.text == "Paris"


def test_et2rag_majority_vote(cats):
    """String-vote fallback (no embedding model): partial answers vote, the
    winning subset generates the FULL answer."""
    calls = {}

    def make(pkg, cat):
        seen = calls.setdefault(pkg, [])

        def responder(prompt):
            seen.append(prompt)
            if "Be complete" in prompt:
                return "Paris is the capital of France."
            return ["Paris", "Paris!", "Lyon", "paris", "Lyon"][len(seen) - 1]

        llm = mock(pkg, responder)
        return gen(pkg, "et2rag").ET2RAGPipeline(
            cat, retrieval_pipeline=bm25(pkg, cat), llm=llm, organization_strategy="random",
            num_subsets=5, seed=42), [llm]

    out, _ = run_both(cats, make)
    assert "paris" in out.text.lower()
    assert out.metadata["votes"]["paris"] == 3
    assert out.metadata["num_subsets"] == 5
    assert out.metadata["selected_subset_index"] == 0
    assert sum("Be complete" in c for c in calls[TORCH]) == 1


@pytest.mark.parametrize("strategy, n, seed", [
    ("qa", 4, 0), ("recipe", 3, 0), ("image", 3, 0), ("random", 5, 7), ("qa", 5, 1),
])
def test_et2rag_subset_schedules(strategy, n, seed):
    """Every organization strategy gives the JAX package's subsets from the
    same ``random.Random``; the JAX test's exact schedules hold."""
    docs = [(i, f"doc {i}") for i in range(8)]
    got = gen(TORCH, "et2rag").make_subsets(docs, strategy, n, None, random.Random(seed))
    ref = gen(JAX, "et2rag").make_subsets(docs, strategy, n, None, random.Random(seed))
    assert got == ref
    if strategy == "qa" and n == 4:
        assert got[0] == [docs[0]] and got[1] == [docs[0], docs[1]] and got[3] == [docs[0], docs[3]]
    if strategy == "recipe":
        assert got == [[docs[0]], [docs[1]], [docs[2]]]
    if strategy == "image":
        assert got[0] == [docs[0], docs[1], docs[2], docs[3]] and len(got) == 3
    assert gen(TORCH, "et2rag").make_subsets([], strategy, n, None, random.Random(seed)) == []


def test_et2rag_embedding_vote(cats):
    """Semantic-consistency vote: the odd answer out loses."""

    def make(pkg, cat):
        seen = []

        def responder(prompt):
            seen.append(prompt)
            if "Be complete" in prompt:
                return "final answer"
            return ["Paris", "Paris", "Lyon"][len(seen) - 1]

        llm = mock(pkg, responder)
        return gen(pkg, "et2rag").ET2RAGPipeline(
            cat, retrieval_pipeline=bm25(pkg, cat), llm=llm,
            embedding_model=_mod(pkg, "embeddings").MockEmbedding(dim=32),
            organization_strategy="recipe", num_subsets=3), [llm]

    out, _ = run_both(cats, make)
    assert out.metadata["selected_subset_index"] in (0, 1)
    assert out.text == "final answer"


def test_et2rag_similarity_vote_matches_jax():
    """``similarity_vote`` over one embedder's vectors: the same winner in
    both packages (its cosines computed in numpy in both)."""
    answers = ["Paris", "paris, France", "Lyon", "Paris", "Marseille"]
    got = gen(TORCH, "et2rag").similarity_vote(answers, _mod(TORCH, "embeddings").MockEmbedding(dim=32))
    ref = gen(JAX, "et2rag").similarity_vote(answers, _mod(JAX, "embeddings").MockEmbedding(dim=32))
    assert_close(got, ref, "similarity_vote")


def test_spd_rag_aggregates(cats):
    """Sub-agent per doc -> coordinator Yes/No -> synthesis."""

    def responder(prompt):
        if "Finding:" in prompt:
            if "Berlin" in prompt:
                return "IRRELEVANT"
            if "Seine" in prompt:
                return "Talks about a river only"
            return "Mentions Paris as capital"
        if "Partial answer:" in prompt:
            return "No" if "river" in prompt else "Yes"
        return "Paris"

    def make(pkg, cat):
        llm = mock(pkg, responder)
        return gen(pkg, "spd_rag").SPDRAGPipeline(cat, retrieval_pipeline=bm25(pkg, cat), llm=llm), [llm]

    out, _ = run_both(cats, make)
    assert out.text == "Paris"
    assert 1 not in out.metadata["context_chunk_ids"]
    assert 2 not in out.metadata["context_chunk_ids"]
    assert 0 in out.metadata["context_chunk_ids"]


def test_deep_rag_trace(cats):
    out, _ = run_both(cats, simple("deep_rag", "DeepRAGPipeline", [
        '{"action": "subquery", "subquery": "capital of France", "use_retrieval": true}',
        "Paris",
        '{"action": "terminate", "final_answer": "Paris"}',
    ]))
    assert out.text == "Paris"
    assert "[retrieval]" in out.metadata["trace"][0]


@pytest.mark.parametrize("logprob", [None, -0.2], ids=["parsed_verdict", "logprobs"])
def test_main_rag_filters(cats, logprob):
    """Both scores of a judge's verdict: the parsed Yes / No (``TorchLM``
    and ``JaxLM`` return no logprobs) and the reply's logprobs."""

    def responder(prompt):
        if "Reply:" in prompt:
            return "Yes" if "France" in prompt or "Paris" in prompt else "No"
        return "Paris"

    class NoLogprobs:
        """An LLM that returns no logprobs, as ``TorchLM`` and ``JaxLM``."""

        def __init__(self, llm):
            self.llm, self.calls = llm, llm.calls

        async def agenerate(self, prompt, **kw):
            res = await self.llm.agenerate(prompt, **kw)
            res.logprobs = None
            return res

    def make(pkg, cat):
        llm = mock(pkg, responder)
        if logprob is not None:
            llm.logprob_value = logprob
        return gen(pkg, "main_rag").MainRAGPipeline(
            cat, retrieval_pipeline=bm25(pkg, cat), llm=llm if logprob is not None else NoLogprobs(llm),
            tau=0.0), [llm]

    out, _ = run_both(cats, make)
    assert out.text == "Paris"
    assert out.metadata["filter_scores"]


def test_main_rag_yes_score_matches_jax():
    LLMResult = {pkg: _mod(pkg, "llm").LLMResult for pkg in PKGS}
    cases = [("Yes", None), ("No", None), ("maybe", None),
             ("yes, it helps", [{"token": "yes,", "logprob": -0.1}, {"token": "Yes", "logprob": -0.1}]),
             ("No", [{"token": "No", "logprob": -0.3}]), ("Yes", [])]
    for text, lp in cases:
        got = gen(TORCH, "main_rag")._yes_score(LLMResult[TORCH](text=text, logprobs=lp))
        ref = gen(JAX, "main_rag")._yes_score(LLMResult[JAX](text=text, logprobs=lp))
        assert_close(got, ref, text)


def test_rag_critic_corrective_loop(cats):
    out, _ = run_both(cats, simple("rag_critic", "RAGCriticPipeline", [
        "Lyon",
        '{"verdict": "revise", "feedback": "Lyon is wrong", '
        '"recommended_actions": ["generate_answer"]}',
        "Paris",
        '{"verdict": "approved", "feedback": "", "recommended_actions": []}',
    ]))
    assert out.text == "Paris"
    assert out.metadata["critiques"][0]["actions"] == ["generate_answer"]
    assert out.metadata["critiques"][1]["approved"] is True


def test_rag_critic_rewrite_action_changes_search_query(cats):
    out, _ = run_both(cats, simple("rag_critic", "RAGCriticPipeline", [
        "vague",
        '{"verdict": "revise", "feedback": "bad evidence", "recommended_actions": ["rewrite_query"]}',
        "capital of France",
        "Paris",
        '{"verdict": "approved"}',
    ]))
    assert out.text == "Paris"
    assert out.metadata["final_search_query"] == "capital of France"


def test_rag_critic_trained_tag_taxonomy(cats):
    for pkg in PKGS:
        parse = gen(pkg, "rag_critic").parse_critique
        c = parse('{"Judgement": "Error", "Error_analysis": "missed entity", '
                  '"tag2": ["Entity and Concept Confusion"]}', "rag_critic_tags")
        assert c["actions"] == ["rewrite_query", "decompose_query"]
        assert parse('{"Judgement": "Correct"}', "rag_critic_tags")["approved"]
    out, _ = run_both(cats, simple("rag_critic", "RAGCriticPipeline", [
        "Lyon",
        '{"Judgement": "Error", "Error_analysis": "wrong fact", "tag2": ["Factual Inaccuracies"]}',
        "Paris",
        '{"Judgement": "Correct"}',
    ], critic_output_format="rag_critic_tags"))
    assert out.text == "Paris"
    assert out.metadata["critiques"][0]["actions"] == ["generate_answer"]


def test_interact_rag_commands(cats):
    def make(pkg, cat):
        llm = scripted(pkg, ["sparse(capital of France)", "include(Paris)", "answer(Paris)"])
        leg = bm25(pkg, cat)
        return gen(pkg, "interact_rag").InteractRAGPipeline(
            cat, retrieval_pipeline=leg, sparse_retrieval_pipeline=leg, llm=llm), [llm]

    out, _ = run_both(cats, make)
    assert out.text == "Paris"
    assert out.metadata["interaction_log"][0].startswith("sparse")
    assert set(out.metadata["context_chunk_ids"]) <= {0, 2}


def test_hybrid_deep_searcher_parallel(cats):
    out, _ = run_both(cats, simple("hybrid_deep_searcher", "HybridDeepSearcherPipeline", [
        "<search>capital France</search><search>Seine river</search>",
        "<answer>Paris</answer>",
    ]))
    assert out.text == "Paris"
    assert out.metadata["searches_used"] == 2
    assert len(out.metadata["interaction_log"]) == 2


def test_ras_triples(cats):
    out, _ = run_both(cats, simple("ras", "RASPipeline", [
        "[SUBQ] capital of France",
        "<triple>Paris | is capital of | France</triple>",
        "[SUFFICIENT]",
        "Paris",
    ]))
    assert out.text == "Paris"
    assert out.metadata["triples"] == [["Paris", "is capital of", "France"]]
    assert out.metadata["subquery_history"][0].startswith("capital of France ->")


def test_ras_no_retrieval_first_action(cats):
    out, _ = run_both(cats, simple("ras", "RASPipeline", ["[NO_RETRIEVAL]", "Paris from memory"],
                                   "ras_nr"))
    assert out.text == "Paris from memory"
    assert out.metadata["triples"] == []
    assert out.metadata["context_chunk_ids"] == []


@pytest.mark.parametrize("text", [
    "[SUBQ] who founded Paris", "...[SUFFICIENT]", "[NO_RETRIEVAL]", "garbage",
    "<triple>a | b | c</triple> and (x; y; z)", "[SUBQ]  ", "[subq] lower case",
])
def test_ras_parsers_match_jax(text):
    for fn in ("parse_plan_action", "parse_triples"):
        assert getattr(gen(TORCH, "ras"), fn)(text) == getattr(gen(JAX, "ras"), fn)(text)


def test_ras_plan_parsing():
    parse_plan_action, parse_triples = gen(TORCH, "ras").parse_plan_action, gen(TORCH, "ras").parse_triples
    assert parse_plan_action("[SUBQ] who founded Paris") == ("subquery", "who founded Paris")
    assert parse_plan_action("...[SUFFICIENT]") == ("sufficient", "")
    assert parse_plan_action("[NO_RETRIEVAL]") == ("no_retrieval", "")
    assert parse_plan_action("garbage")[0] == "invalid"
    assert parse_triples("<triple>a | b | c</triple> and (x; y; z)") == [("a", "b", "c"), ("x", "y", "z")]


def _autothink_responder(prompt):
    if "Item:" in prompt:  # perception phase
        return "Paris is the capital" if "Paris" in prompt else "NONE"
    if "Reasoning chain so far" in prompt:  # iterative reasoning
        if "(start)" in prompt:
            return "THOUGHT: the facts point to Paris"
        return "ANSWER: Paris"
    return "complex"


@pytest.mark.parametrize("tier", ["simple", "complex", "moderate"])
def test_autothinkrag_routes(cats, tier):
    def make(pkg, cat):
        if tier == "complex":
            llm = mock(pkg, _autothink_responder)
        else:
            llm = scripted(pkg, ["simple", "Paris"] if tier == "simple"
                           else ["moderate", "Synthesis: therefore Paris"])
        return gen(pkg, "autothinkrag").AutoThinkRAGPipeline(
            cat, f"atr_{tier}", retrieval_pipeline=bm25(pkg, cat), llm=llm), [llm]

    out, _ = run_both(cats, make)
    assert out.metadata["complexity"] == tier
    assert "Paris" in out.text
    if tier != "moderate":
        assert out.text == "Paris"
    if tier == "complex":
        assert out.metadata["perceived_facts"]
        assert out.metadata["reasoning_chain"] == ["THOUGHT: the facts point to Paris"]


@pytest.mark.parametrize("arg", [
    "capital, semantic=0.7, exact=0.3", "plain query", "q, semantic=2", "q, exact=0.25",
    "a, b, semantic=0.1, exact=0.9",
])
def test_interact_rag_fusion_arg_matches_jax(arg):
    got = gen(TORCH, "interact_rag")._parse_fusion_arg(arg)
    assert_close(got, gen(JAX, "interact_rag")._parse_fusion_arg(arg), arg)


def test_interact_rag_weighted_fusion_and_id_controls(cats):
    """Weighted fusion (``cc_fuse``), include / exclude by chunk id, the
    scale cap."""
    assert gen(TORCH, "interact_rag")._parse_fusion_arg("capital, semantic=0.7, exact=0.3") == (
        "capital", 0.7, 0.3)
    assert gen(TORCH, "interact_rag")._parse_fusion_arg("plain query") == ("plain query", 0.5, 0.5)
    for raw in ("0", "paris", "3", "99", " 1 "):
        got = gen(TORCH, "interact_rag")._coerce_id(raw, {}, cats[TORCH])
        assert got == gen(JAX, "interact_rag")._coerce_id(raw, {}, cats[JAX]), raw
    assert gen(TORCH, "interact_rag")._coerce_id("0", {}, cats[TORCH]) == 0
    assert gen(TORCH, "interact_rag")._coerce_id("paris", {}, cats[TORCH]) is None

    out, _ = run_both(cats, simple("interact_rag", "InteractRAGPipeline", [
        "scale(500)",
        "fusion(capital of France, semantic=0.8, exact=0.2)",
        "exclude(1)",
        "answer(Paris)",
    ], max_turns=6, max_scale=20))
    assert out.text == "Paris"
    assert 1 not in out.metadata["context_chunk_ids"]
    assert any(log.startswith("fusion") for log in out.metadata["interaction_log"])


def test_interact_rag_entity_top3(cats):
    out, _ = run_both(cats, simple("interact_rag", "InteractRAGPipeline",
                                   ["entity(capital)", "answer(Paris)"], "ir3"))
    assert out.text == "Paris"
    assert 0 < len(out.metadata["context_chunk_ids"]) <= 3


def test_deep_rag_tag_protocol(cats):
    out, _ = run_both(cats, simple("deep_rag", "DeepRAGPipeline", [
        "<retrieve>capital of France</retrieve>",
        "Paris",
        "<parametric>is Paris in Europe</parametric>",
        "yes",
        "<answer>Paris</answer>",
    ], "dr_tags"))
    assert out.text == "Paris"
    assert "[retrieval]" in out.metadata["trace"][0]
    assert "[parametric]" in out.metadata["trace"][1]
    assert out.metadata["context_chunk_ids"]


@pytest.mark.parametrize("text", [
    '{"action": "subquery", "subquery": "x", "use_retrieval": false}',
    '{"action": "terminate", "final_answer": "Paris"}',
    "<retrieve>a</retrieve>", "<parametric>b</parametric>", "<answer>c</answer>",
    "rambling", '{"action": "subquery"', "```json\n{\"action\": \"terminate\"}\n```",
])
def test_deep_rag_decision_parsing_matches_jax(text):
    assert gen(TORCH, "deep_rag")._parse_decision(text) == gen(JAX, "deep_rag")._parse_decision(text)


@pytest.mark.parametrize("text, budget", [
    ("thinking <|begin search queries|>capital of France; Seine river\nGermany borders"
     "<|end search queries|>", 8),
    (r"so the answer is \boxed{Paris}", 8),
    ("<search>a</search><search>b</search><search>c</search>", 2),
    ("<answer>Paris</answer>", 8),
    ("<|begin search queries|>x; y; z", 8),
])
def test_hds_action_parsing_matches_jax(text, budget):
    got = gen(TORCH, "hybrid_deep_searcher").parse_hds_action(text, budget)
    assert got == gen(JAX, "hybrid_deep_searcher").parse_hds_action(text, budget)


def test_hds_paper_token_protocol(cats):
    """The trained-model protocol: ``<|begin search queries|>`` blocks with
    semicolon-separated queries, ``\\boxed{}`` answers."""
    parse = gen(TORCH, "hybrid_deep_searcher").parse_hds_action
    final, qs = parse("thinking <|begin search queries|>capital of France; Seine river\n"
                      "Germany borders<|end search queries|>", 8)
    assert final is None and qs == ["capital of France", "Seine river", "Germany borders"]
    assert parse(r"so the answer is \boxed{Paris}", 8) == ("Paris", [])

    out, _ = run_both(cats, simple("hybrid_deep_searcher", "HybridDeepSearcherPipeline", [
        "<|begin search queries|>capital of France; river in Paris<|end search queries|>",
        r"\boxed{Paris}",
    ], "hds_tok"))
    assert out.text == "Paris"
    assert out.metadata["searches_used"] == 2


# ------------------------------------------ all 15 through both CLIs' `run`

SMALL = dict(hidden=32, layers=2, heads=2, max_len=256)
PROMPT, NEW = 192, 24
AGENTS = ("ircot", "search_r1", "self_rag", "adaptive_rag", "question_decomposition_gen",
          "dynamic_rag", "deep_rag", "hybrid_deep_searcher", "et2rag", "spd_rag", "main_rag",
          "ras", "autothinkrag", "interact_rag", "rag_critic")
_CURRENT = contextvars.ContextVar("current_row", default=None)


def _recording(monkeypatch, pkg, streams):
    """Record each LLM call as (prompt, text, usage) under the (pipeline,
    query) whose ``_generate`` made it."""
    package = _mod(pkg, "pipelines.generation")
    classes = {getattr(package, name) for name in package.__all__ if name.endswith("Pipeline")}
    for cls in classes:
        if "_generate" not in vars(cls):
            continue
        orig = cls._generate

        async def _generate(self, query_id, top_k, _orig=orig):
            token = _CURRENT.set((self.name, query_id))
            try:
                return await _orig(self, query_id, top_k)
            finally:
                _CURRENT.reset(token)

        monkeypatch.setattr(cls, "_generate", _generate)
    lm_cls = _mod(TORCH, "llm").TorchLM if pkg == TORCH else _mod(JAX, "llm").JaxLM
    orig_agenerate = lm_cls.agenerate

    async def agenerate(self, prompt, **kw):
        res = await orig_agenerate(self, prompt, **kw)
        key = _CURRENT.get()
        if key is not None:
            streams.setdefault(key, []).append((prompt, res.text, res.token_usage))
        return res

    monkeypatch.setattr(lm_cls, "agenerate", agenerate)


def test_all_agents_through_both_clis_on_real_decoders(tmp_path, monkeypatch):
    """``init``, ``ingest`` and ``run`` through both CLIs, the experiment
    naming all 15 pipelines at their templates (``max_concurrency: 1``,
    ``interact_rag``'s dense leg ``vector_search`` on the ingest's mock
    embeddings), ``llm`` a ``torch_lm`` / ``jax_lm`` model file on one
    ``JaxLM.save`` checkpoint: every pipeline's rows, token usage, metadata
    and retrieval rows are equal, but rows whose replies first differ at a
    decode near-tie (counted)."""
    from test_torch_llm import assert_rows_equal_but_near_ties

    from autorag_research_tpu.cli.app import main as jax_main
    from autorag_research_tpu.llm import JaxLM
    from autorag_research_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
    from autorag_research_tpu_torch.cli.app import main as torch_main
    from autorag_research_tpu_torch.llm import TorchLM
    from autorag_research_tpu_torch.models.decoder import DecoderConfig

    checkpoint = str(tmp_path / "lm.npz")
    JaxLM(config=JaxDecoderConfig(**SMALL), max_prompt_len=PROMPT, max_new_tokens=NEW,
          seed=3).save(checkpoint)
    mains = {JAX: jax_main, TORCH: lambda argv: torch_main(["--device", "cpu", *argv])}
    out, streams = {}, {pkg: {} for pkg in PKGS}
    for pkg, main in mains.items():
        root = tmp_path / f"cli_{pkg}"
        root.mkdir()
        monkeypatch.chdir(root)
        assert main(["init"]) == 0
        configs = root / "configs"
        kind = "torch_lm" if pkg == TORCH else "jax_lm"
        spec = yaml.safe_load((configs / "llm" / f"{kind}.yaml").read_text())
        spec.update(SMALL, max_prompt_len=PROMPT, max_new_tokens=NEW, checkpoint=checkpoint)
        (configs / "llm" / f"{kind}.yaml").write_text(yaml.safe_dump(spec))
        for name in AGENTS:
            path = configs / "pipelines" / "generation" / f"{name}.yaml"
            agent = yaml.safe_load(path.read_text())
            assert agent["llm"] == "mock", name
            agent.update(llm=kind, max_concurrency=1)
            if name == "rag_critic":
                agent["critic_llm"] = kind
            path.write_text(yaml.safe_dump(agent))
        (configs / "experiment.yaml").write_text(yaml.safe_dump({
            "pipelines": {"retrieval": [], "generation": list(AGENTS)},
            "metrics": {"retrieval": ["recall"], "generation": ["exact_match", "token_f1"]},
            "executor": {"health_check": False},
        }))
        assert main(["ingest", "--name", "synthetic", "--db", "ws", "--extra", "n_docs=40",
                     "--extra", "n_queries=2", "--embedding-model", "mock"]) == 0
        _mod(pkg, "index.registry").invalidate()
        with monkeypatch.context() as m:
            _recording(m, pkg, streams[pkg])
            assert main(["run", "--db", "ws"]) == 0
        cat = _mod(pkg, "store.catalog").Catalog(root / "ws" / "catalog.db")
        rows = {}
        with sqlite3.connect(cat.path) as conn:
            for name in AGENTS:
                pid = cat.get_pipeline(name)["id"]
                for q, text, usage, meta in conn.execute(
                        "SELECT query_id, generation_result, token_usage, result_metadata FROM "
                        "executor_result WHERE pipeline_id = ? ORDER BY query_id", (pid,)):
                    hits = [(r["doc_id"], r["rel_score"]) for r in cat.get_retrieved(q, pid)]
                    rows[(name, q)] = (text, json.loads(usage), json.loads(meta), hits)
        cat.close()
        out[pkg] = rows
    assert out[TORCH].keys() == out[JAX].keys()
    assert {name for name, _ in out[TORCH]} == set(AGENTS)
    assert len(out[TORCH]) == 2 * len(AGENTS)
    jlm = JaxLM(config=JaxDecoderConfig(**SMALL), max_prompt_len=PROMPT, max_new_tokens=NEW,
                checkpoint=checkpoint)
    tlm = TorchLM(DecoderConfig(**SMALL), max_prompt_len=PROMPT, max_new_tokens=NEW,
                  checkpoint=checkpoint, device="cpu")
    near_ties = 0
    for key, ref in out[JAX].items():
        got = out[TORCH][key]
        assert got[1], key  # token usage is not empty
        t_calls, j_calls = streams[TORCH][key], streams[JAX][key]
        assert t_calls and j_calls, key  # every pipeline asked the decoder
        first = next((i for i, (t, j) in enumerate(zip(t_calls, j_calls)) if t != j), None)
        if first is None:
            assert len(t_calls) == len(j_calls), key
            assert got[:3] == ref[:3], key
            assert [d for d, _ in got[3]] == [d for d, _ in ref[3]], key
            np.testing.assert_allclose([s for _, s in got[3]], [s for _, s in ref[3]],
                                       rtol=1e-5, err_msg=str(key))
            continue
        # the replies part at a decode near-tie on one prompt; what follows
        # runs on other replies
        prompt = j_calls[first][0]
        assert t_calls[first][0] == prompt, key
        LLMResult = _mod(TORCH, "llm").LLMResult
        assert_rows_equal_but_near_ties(
            jlm, tlm, [prompt], [LLMResult(text=t_calls[first][1], token_usage=t_calls[first][2])],
            [LLMResult(text=j_calls[first][1], token_usage=j_calls[first][2])])
        near_ties += 1
    print(f"{len(out[TORCH])} rows, {near_ties} parted at a decode near-tie")
