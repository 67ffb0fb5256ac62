"""Adversarial edge cases of the port's agentic generation pipelines against
the JAX package's: ``tests/test_generation_agents_edge.py``'s cases
(malformed LLM output, empty retrieval, budget and turn exhaustion, loop
termination), each run through both packages as in
``tests/test_torch_generation_agents.py``: the answer, token usage,
metadata, each LLM's prompts and the ``retrieved`` ids equal, scores within
1e-6, and the JAX test's own assertions on the port's result.
"""

import pytest

from test_torch_generation_agents import (
    JAX,
    PKGS,
    TORCH,
    _mod,
    bm25,
    cats,  # noqa: F401  (fixture)
    clear_cache,  # noqa: F401  (autouse fixture)
    gen,
    run_both,
    scripted,
    simple,
)


class NullRetrieval:
    """Retrieval pipeline stub that finds nothing (empty corpus regime)."""

    def __init__(self):
        self.calls: list[tuple[str, int]] = []

    async def _retrieve_by_text(self, text, top_k):
        self.calls.append((text, top_k))
        return []


class CountingRetrieval:
    """Records every (query, k) and returns one fixed hit."""

    def __init__(self, doc_id=0, score=1.0):
        self.calls: list[tuple[str, int]] = []
        self.doc_id = doc_id
        self.score = score

    async def _retrieve_by_text(self, text, top_k):
        self.calls.append((text, top_k))
        return [{"doc_id": self.doc_id, "score": self.score}]


def with_stub(module, cls, stubs, responses, name, **kw):
    """A ``make`` over a retrieval stub (one a package, kept in ``stubs``)."""

    def make(pkg, cat):
        stub = stubs[pkg]
        llm = scripted(pkg, responses)
        return getattr(gen(pkg, module), cls)(cat, name, retrieval_pipeline=stub, llm=llm, **kw), [llm]

    return make


def critic_pair(name, responses, critic_responses, retrieval=None, **kw):
    """A ``make`` for ``rag_critic`` with a generator and a critic LLM."""

    def make(pkg, cat):
        llm, critic = scripted(pkg, responses), scripted(pkg, critic_responses)
        leg = retrieval[pkg] if retrieval else bm25(pkg, cat)
        return gen(pkg, "rag_critic").RAGCriticPipeline(
            cat, name, retrieval_pipeline=leg, llm=llm, critic_llm=critic, **kw), [llm, critic]

    return make


# =========================================================== RAG-Critic
@pytest.mark.parametrize("garbage", ["utter nonsense with no braces",
                                     '{"verdict": "revise", busted', "{}"])
def test_rag_critic_malformed_critic_output_terminates(cats, garbage):
    """Garbage critiques must not loop or crash."""
    out, (_, critic) = run_both(cats, critic_pair(
        f"rc_mal_{len(garbage)}", ["draft answer"], [garbage] * 5, max_rounds=3))
    assert out.text == "draft answer"
    assert len(out.metadata["critiques"]) == 1
    assert len(critic.calls) == 1


def test_rag_critic_never_approving_critic_stops_at_max_rounds(cats):
    revise = '{"verdict": "revise", "feedback": "bad", "recommended_actions": ["generate_answer"]}'
    out, (_, critic) = run_both(cats, critic_pair(
        "rc_loop", ["draft"] + [f"revision {i}" for i in range(10)], [revise] * 10, max_rounds=3))
    assert len(out.metadata["critiques"]) == 3
    assert len(critic.calls) == 3
    assert out.text == "revision 2"


@pytest.mark.parametrize("text, fmt", [
    ('{"verdict": "revise", "recommended_actions": ["summon_demon", "RETRIEVAL", 42]}',
     "json_actions"),
    ('{"verdict": "revise", "recommended_actions": ["summon_demon"]}', "json_actions"),
    ('{"verdict": "approved"}', "json_actions"),
    ("no json here", "json_actions"),
    ('{"Judgement": "Error", "Error_analysis": "x", "tag2": ["not a real tag"]}', "rag_critic_tags"),
    ('{"Judgement": "Error", "tag2": "relevance gaps in retrieval"}', "rag_critic_tags"),
    ('{"Judgement": "Incorrect", "Error_analysis": "contradicts passage"}', "rag_critic_tags"),
    ('```json\n{"Judgement": "Correct"}\n```', "rag_critic_tags"),
])
def test_rag_critic_parse_critique_matches_jax(text, fmt):
    got = gen(TORCH, "rag_critic").parse_critique(text, fmt)
    assert got == gen(JAX, "rag_critic").parse_critique(text, fmt)
    assert gen(TORCH, "rag_critic")._json_payload(text) == gen(JAX, "rag_critic")._json_payload(text)


def test_rag_critic_unknown_actions_are_filtered():
    parse = gen(TORCH, "rag_critic").parse_critique
    c = parse('{"verdict": "revise", "recommended_actions": ["summon_demon", "RETRIEVAL", 42]}',
              "json_actions")
    assert c["actions"] == ["retrieval"]
    c2 = parse('{"verdict": "revise", "recommended_actions": ["summon_demon"]}', "json_actions")
    assert c2["actions"] == ["generate_answer"]


def test_rag_critic_tags_unknown_tag_falls_back_to_regenerate():
    parse = gen(TORCH, "rag_critic").parse_critique
    c = parse('{"Judgement": "Error", "Error_analysis": "x", "tag2": ["not a real tag"]}',
              "rag_critic_tags")
    assert c["approved"] is False
    assert c["actions"] == ["generate_answer"]
    c2 = parse('{"Judgement": "Error", "tag2": "relevance gaps in retrieval"}', "rag_critic_tags")
    assert c2["actions"] == ["retrieval"]


def test_rag_critic_refine_with_no_numbers_keeps_evidence(cats):
    revise = '{"verdict": "revise", "feedback": "junk", "recommended_actions": ["refine_documents"]}'
    out, _ = run_both(cats, critic_pair(
        "rc_refine", ["draft", "none of them seem useful", "better answer"],
        [revise, '{"verdict": "approved"}']))
    assert out.metadata["context_chunk_ids"]
    assert out.text == "better answer"


def test_rag_critic_empty_retrieval_still_answers(cats):
    nulls = {pkg: NullRetrieval() for pkg in PKGS}
    out, _ = run_both(cats, critic_pair("rc_empty", ["best-effort answer"],
                                        ['{"verdict": "approved"}'], retrieval=nulls))
    assert out.text == "best-effort answer"
    assert out.metadata["context_chunk_ids"] == []
    assert out.retrieved == []
    assert nulls[TORCH].calls == nulls[JAX].calls


# =========================================================== Search-R1
def test_search_r1_unclosed_tags_budget_fallback(cats):
    out, (llm,) = run_both(cats, simple("search_r1", "SearchR1Pipeline", [
        "<think>...</think> <answer>Paris", "<search>capital", "no tags at all", "fallback: Paris",
    ], "sr1_unclosed", max_actions=3))
    assert out.text == "fallback: Paris"
    assert out.metadata["terminated_by"] == "budget_exhausted_fallback"
    assert len(llm.calls) == 4


def test_search_r1_answer_after_search_in_same_segment_is_dropped(cats):
    out, _ = run_both(cats, simple("search_r1", "SearchR1Pipeline", [
        "<search>capital of France</search><answer>premature</answer>", "<answer>Paris</answer>",
    ], "sr1_order", max_actions=4))
    assert out.text == "Paris"
    assert out.metadata["terminated_by"] == "answer"
    assert "<information>" in out.metadata["rollout"]


def test_search_r1_answer_before_search_skips_retrieval(cats):
    counting = {pkg: CountingRetrieval() for pkg in PKGS}
    out, _ = run_both(cats, with_stub("search_r1", "SearchR1Pipeline", counting,
                                      ["<answer>Paris</answer><search>never runs</search>"],
                                      "sr1_ans_first"))
    assert out.text == "Paris"
    assert counting[TORCH].calls == counting[JAX].calls == []


def test_search_r1_empty_retrieval_injects_empty_information(cats):
    nulls = {pkg: NullRetrieval() for pkg in PKGS}
    out, _ = run_both(cats, with_stub("search_r1", "SearchR1Pipeline", nulls,
                                      ["<search>anything</search>", "<answer>unknown</answer>"],
                                      "sr1_empty"))
    assert out.text == "unknown"
    assert out.metadata["context_chunk_ids"] == []
    assert "<information>" in out.metadata["rollout"]
    assert nulls[TORCH].calls == nulls[JAX].calls


# =================================================== HybridDeepSearcher
def test_hds_search_budget_caps_parallel_queries(cats):
    three = ("<search>capital France</search><search>Paris Seine</search>"
             "<search>Germany border</search>")
    out, (llm,) = run_both(cats, simple("hybrid_deep_searcher", "HybridDeepSearcherPipeline",
                                        [three, three, "final: Paris"], "hds_budget",
                                        max_turns=5, search_budget=4))
    assert out.metadata["searches_used"] == 4
    assert out.text == "final: Paris"
    assert len(llm.calls) == 3


def test_hds_no_action_turns_terminate_at_max_turns(cats):
    out, _ = run_both(cats, simple("hybrid_deep_searcher", "HybridDeepSearcherPipeline",
                                   ["rambling", "more rambling", "final answer"], "hds_noact",
                                   max_turns=2))
    assert out.text == "final answer"
    assert out.metadata["searches_used"] == 0
    assert sum("(no action)" in line for line in out.metadata["interaction_log"]) == 2


@pytest.mark.parametrize("text, budget", [
    ("<|begin search queries|> ; ;\n <|end search queries|>", 8),
    ("<search>q1</search>", 0),
    ("<search> </search>", 3),
])
def test_hds_empty_token_block_is_no_action(text, budget):
    parse = gen(TORCH, "hybrid_deep_searcher").parse_hds_action
    assert parse(text, max_queries=budget) == (None, [])
    assert parse(text, max_queries=budget) == gen(JAX, "hybrid_deep_searcher").parse_hds_action(
        text, max_queries=budget)


def test_hds_boxed_answer_first_turn_skips_all_search(cats):
    counting = {pkg: CountingRetrieval() for pkg in PKGS}
    out, _ = run_both(cats, with_stub("hybrid_deep_searcher", "HybridDeepSearcherPipeline",
                                      counting, [r"reasoning... \boxed{Paris}"], "hds_boxed"))
    assert out.text == "Paris"
    assert counting[TORCH].calls == []
    assert out.metadata["searches_used"] == 0


# ========================================================= InteractRAG
def test_interact_rag_unparseable_commands_fall_back(cats):
    out, _ = run_both(cats, simple("interact_rag", "InteractRAGPipeline",
                                   ["I think we should search", "fetch(paris", "final fallback answer"],
                                   "ir_unparsed", max_turns=2))
    assert out.text == "final fallback answer"
    assert all(line.startswith("unparsed:") for line in out.metadata["interaction_log"])
    assert out.metadata["context_chunk_ids"] == []


def test_interact_rag_scale_clamps_and_ignores_garbage(cats):
    counting = {pkg: CountingRetrieval(doc_id=0) for pkg in PKGS}
    out, _ = run_both(cats, with_stub(
        "interact_rag", "InteractRAGPipeline", counting,
        ["scale(9999)", "dense(capital)", "scale(no digits here)", "dense(again)", "answer(done)"],
        "ir_scale", max_turns=5, max_scale=7))
    assert out.text == "done"
    assert [k for _, k in counting[TORCH].calls] == [7, 7]
    assert counting[TORCH].calls == counting[JAX].calls


def test_interact_rag_include_filters_working_set_by_substring(cats):
    out, _ = run_both(cats, simple("interact_rag", "InteractRAGPipeline",
                                   ["sparse(capital)", "include(Germany)", "answer(Berlin)"],
                                   "ir_incl", max_turns=4), top_k=4)
    assert out.text == "Berlin"
    kept = out.metadata["context_chunk_ids"]
    texts = cats[TORCH].get_chunk_contents(kept)
    assert kept and all("Germany" in texts[d] for d in kept)


def test_interact_rag_exclude_unknown_term_keeps_everything(cats):
    out, _ = run_both(cats, simple("interact_rag", "InteractRAGPipeline",
                                   ["sparse(capital)", "exclude(zebra)", "answer(ok)"],
                                   "ir_excl", max_turns=4), top_k=4)
    assert out.text == "ok"
    assert out.metadata["context_chunk_ids"]


def test_interact_rag_entity_without_matches_is_noop(cats):
    out, _ = run_both(cats, simple("interact_rag", "InteractRAGPipeline",
                                   ["entity(xylophone)", "answer(nothing found)"], "ir_ent",
                                   max_turns=3))
    assert out.text == "nothing found"
    assert out.metadata["context_chunk_ids"] == []


# ==================================================== other agentic loops
def test_ircot_empty_retrieval_still_terminates(cats):
    nulls = {pkg: NullRetrieval() for pkg in PKGS}
    out, _ = run_both(cats, with_stub("ircot", "IRCoTPipeline", nulls,
                                      ["thinking", "thinking more", "Paris (from memory)"],
                                      "ircot_empty", max_steps=2))
    assert out.text
    assert out.metadata["context_chunk_ids"] == []
    assert nulls[TORCH].calls == nulls[JAX].calls


def test_deep_rag_malformed_decision_terminates(cats):
    out, _ = run_both(cats, simple("deep_rag", "DeepRAGPipeline",
                                   ["completely unstructured rambling"] * 5 + ["final answer"],
                                   "dr_mal", max_steps=3))
    assert out.text


@pytest.mark.parametrize("text", ["no tokens here at all", "not a triple; (lonely", "(a; b)",
                                  "<none/>", "[SUBQ]", "(a; b; c; d)"])
def test_ras_malformed_parsing_matches_jax(text):
    for fn in ("parse_plan_action", "parse_triples"):
        assert getattr(gen(TORCH, "ras"), fn)(text) == getattr(gen(JAX, "ras"), fn)(text)


def test_ras_malformed_plan_and_triples(cats):
    ras = gen(TORCH, "ras")
    assert ras.parse_plan_action("no tokens here at all") == ("invalid", "")
    assert ras.parse_triples("not a triple; (lonely") == []
    assert ras.parse_triples("(a; b)") == []
    out, _ = run_both(cats, simple("ras", "RASPipeline",
                                   ["gibberish plan", "<none/>"] * 3 + ["graph answer"],
                                   "ras_mal", max_iterations=3))
    assert out.text == "graph answer"
    assert out.metadata["context_chunk_ids"]


def test_et2rag_all_votes_distinct_falls_back_deterministically(cats):
    out, _ = run_both(cats, simple("et2rag", "ET2RAGPipeline",
                                   [f"unique answer {i}" for i in range(12)], "et2_split",
                                   num_subsets=3))
    assert out.text.startswith("unique answer")


def test_rag_critic_incorrect_judgement_is_not_approved(cats):
    """Only an explicit 'Correct' judgement approves."""
    out, _ = run_both(cats, simple("rag_critic", "RAGCriticPipeline", [
        "draft answer",
        '{"Judgement": "Incorrect", "Error_analysis": "contradicts passage"}',
        "revised answer",
        '{"Judgement": "Correct"}',
    ], "critic_incorrect", critic_output_format="rag_critic_tags", max_rounds=3))
    assert out.text == "revised answer"
    history = out.metadata["critiques"]
    assert history[0]["approved"] is False
    assert "contradicts passage" in history[0]["feedback"]


def test_autothinkrag_simple_tier_sends_images(cats):
    """Image evidence reaches the LLM through ``images=`` on the simple
    tier, as bytes, in both packages."""

    class FakeImagePipeline:
        retrieval_unit = "image_chunk"

        async def _retrieve_by_id(self, qid, k):
            return [{"doc_id": "img1", "score": 1.0}]

    seen = {}

    def make(pkg, cat):
        base = _mod(pkg, "llm")
        cat.add_image_chunks([{"id": "img1", "image": b"\x89PNG-bytes", "mimetype": "image/png"}])

        class VLM(base.MockLLM):
            async def agenerate(self, prompt, images=None, **kw):
                self.calls.append(prompt)
                if images is not None:
                    seen[pkg] = images
                    return base.LLMResult(text="a chart of capitals")
                if "simple" in prompt or "complexity" in prompt.lower():
                    return base.LLMResult(text="simple")
                return base.LLMResult(text="Paris")

        llm = VLM()
        return gen(pkg, "autothinkrag").AutoThinkRAGPipeline(
            cat, "atr_img", retrieval_pipeline=FakeImagePipeline(), llm=llm), [llm]

    out, _ = run_both(cats, make)
    assert out.metadata["complexity"] == "simple"
    assert seen[TORCH] == seen[JAX] == [b"\x89PNG-bytes"]
    assert out.text == "Paris"


def test_select_top_evidence_breaks_ties_by_doc_id():
    select = gen(TORCH, "base").select_top_evidence
    evidence = {"z9": 0.5, "a1": 0.5, "m5": 0.9}
    assert select(evidence, 3) == ["m5", "a1", "z9"]
    assert select(evidence, 2) == ["m5", "a1"]
    assert select(evidence, 3) == gen(JAX, "base").select_top_evidence(evidence, 3)
