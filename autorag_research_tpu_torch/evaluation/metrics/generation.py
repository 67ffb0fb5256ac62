"""Generation metrics.

Capability parity with the reference ``evaluation/metrics/generation.py``
(1 981 LoC), re-implemented natively where the reference shells out to
sacrebleu / rouge-score / evaluate:

- ``bleu``: sentence BLEU with sacrebleu semantics — 13a-style tokenization,
  exp smoothing, effective order, multi-reference clipped counts, closest
  reference length, 0-100 scale (reference ``generation.py:1004-1044``).
- ``rouge``: rouge1/rouge2/rougeL f-measure, non-alphanumeric tokenization,
  optional Porter stemmer, max over references (reference ``:1079-1121``).
- ``meteor``: native alignment-based METEOR (exact + stem + WordNet-synonym
  stages; the synonym stage degrades gracefully when wordnet data is absent)
  with the standard alpha/beta/gamma parameters
  (reference ``:1046-1077`` delegates to HF evaluate).
- ``exact_match`` / ``token_f1``: SQuAD normalization (lowercase, strip
  punctuation/articles, whitespace), best score across references
  (reference ``:103-150, 1123-1133``).
- ``sem_score``: max cosine between generated-text embedding and each GT
  embedding via this framework's embedding adapters (reference ``:1135-1177``).
- ``response_relevancy``: RAGAS-style — LLM writes questions from the answer,
  mean cosine to the actual query (reference ``:1312-1360``).
- model-backed metrics (``bert_score``, ``bart_score_*``, ``unieval``,
  ``align_score``, ``mini_check``): implemented against local HF checkpoints
  in ``evaluation/metrics/model_scorers.py``, on the ``device`` they are
  given (the Executor passes its ``BuildContext`` device, see
  ``MODEL_SCORER_METRICS``); they raise ``ModelLoadError`` with guidance when
  no local checkpoint is available (nothing is downloaded).

The port's copy of the JAX package's ``evaluation/metrics/generation.py``:
host code, the same numbers. The ROUGE stemmer and METEOR use nltk where it
imports, as the JAX copy does.
"""

from __future__ import annotations

import math
import re
import string
from collections import Counter
from typing import Any, Callable, Sequence

import numpy as np

from autorag_research_tpu_torch.evaluation.metrics.util import (
    calculate_cosine_similarity,
    metric_loop,
)
from autorag_research_tpu_torch.exceptions import ModelLoadError
from autorag_research_tpu_torch.schema import MetricInput
from autorag_research_tpu_torch.utils.concurrency import run_async

# --------------------------------------------------------------- SQuAD utils

_ARTICLES_RE = re.compile(r"\b(a|an|the)\b")


def normalize_string(text: str) -> str:
    """SQuAD answer normalization: lowercase, drop punctuation, drop
    articles, collapse whitespace."""
    text = text.lower()
    text = "".join(ch for ch in text if ch not in string.punctuation)
    text = _ARTICLES_RE.sub(" ", text)
    return " ".join(text.split())


def _best_over_references(
    inputs: list[MetricInput], scorer: Callable[[str, str], float]
) -> list[float]:
    return [
        max(scorer(mi.generated_texts or "", ref) for ref in (mi.generation_gt or [""]))
        for mi in inputs
    ]


@metric_loop(fields_to_check=["generation_gt"])
def exact_match(metric_inputs: list[MetricInput]) -> list[float]:
    return _best_over_references(
        metric_inputs,
        lambda pred, ref: float(normalize_string(pred) == normalize_string(ref)),
    )


def _token_f1_one(pred: str, ref: str) -> float:
    p_tokens = normalize_string(pred).split()
    r_tokens = normalize_string(ref).split()
    if not p_tokens or not r_tokens:
        return float(p_tokens == r_tokens)
    overlap = sum((Counter(p_tokens) & Counter(r_tokens)).values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(p_tokens)
    recall = overlap / len(r_tokens)
    return 2 * precision * recall / (precision + recall)


@metric_loop(fields_to_check=["generation_gt"])
def token_f1(metric_inputs: list[MetricInput]) -> list[float]:
    return _best_over_references(metric_inputs, _token_f1_one)


# ----------------------------------------------------------------------- BLEU

_13A_RE = [
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),  # punctuation
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),  # period/comma not after digit
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),  # period/comma not before digit
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
]


def _tokenize_13a(text: str) -> list[str]:
    """sacrebleu '13a' (mteval-v13a) tokenization, simplified: normalize
    whitespace then split out punctuation."""
    text = text.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
    if "&" in text:
        text = text.replace("&quot;", '"').replace("&amp;", "&")
        text = text.replace("&lt;", "<").replace("&gt;", ">")
    text = f" {text} "
    for pattern, repl in _13A_RE:
        text = pattern.sub(repl, text)
    return text.split()


def _ngram_counts(tokens: Sequence[str], max_order: int) -> list[Counter]:
    return [
        Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))
        for n in range(1, max_order + 1)
    ]


_BLEU_SMOOTH_DEFAULTS: dict[str, float | None] = {
    "floor": 0.1,
    "add-k": 1.0,
    "exp": None,
    "none": None,
}


def _my_log(num: float) -> float:
    # sacrebleu's my_log: log(0) stands in as a huge negative (not -inf) so
    # exp(sum/eff_order) underflows to exactly 0.0 the same way
    return -9999999999.0 if num == 0.0 else math.log(num)


def sentence_bleu(
    hypothesis: str,
    references: list[str],
    max_ngram_order: int = 4,
    smooth_method: str = "exp",
    smooth_value: float | None = None,
    effective_order: bool = True,
) -> float:
    """Sentence BLEU, bit-parity with ``sacrebleu.BLEU.sentence_score``
    (fuzz-verified in ``tests/test_reference_oracle_generation.py``): clipped
    n-gram precision against the union-max of references, brevity penalty vs
    the closest reference length, 'exp'/'floor'/'add-k'/'none' smoothing
    (add-k applies only to orders n>1), early zero when NO order matches,
    0-100 scale. Reference role: ``generation.py:1004-1044``."""
    if smooth_value is None:
        smooth_value = _BLEU_SMOOTH_DEFAULTS[smooth_method]
    hyp = _tokenize_13a(hypothesis)
    refs = [_tokenize_13a(r) for r in references if r is not None]
    if not refs:
        return 0.0
    sys_len = len(hyp)
    ref_len = min((abs(len(r) - sys_len), len(r)) for r in refs)[1]

    hyp_counts = _ngram_counts(hyp, max_ngram_order)
    max_ref_counts: list[Counter] = [Counter() for _ in range(max_ngram_order)]
    for r in refs:
        for n, counts in enumerate(_ngram_counts(r, max_ngram_order)):
            for ng, c in counts.items():
                if c > max_ref_counts[n][ng]:
                    max_ref_counts[n][ng] = c
    correct: list[float] = [
        float(sum(min(c, max_ref_counts[n][ng]) for ng, c in hyp_counts[n].items()))
        for n in range(max_ngram_order)
    ]
    total: list[float] = [float(max(sys_len - n, 0)) for n in range(max_ngram_order)]

    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    if not any(correct):  # no match at any order -> 0 regardless of smoothing
        return 0.0

    precisions = [0.0] * max_ngram_order
    smooth_mteval = 1.0
    eff_order = max_ngram_order
    for n in range(1, max_ngram_order + 1):
        if smooth_method == "add-k" and n > 1:
            correct[n - 1] += smooth_value
            total[n - 1] += smooth_value
        if total[n - 1] == 0:
            break
        if effective_order:
            eff_order = n
        if correct[n - 1] == 0:
            if smooth_method == "exp":
                smooth_mteval *= 2.0
                precisions[n - 1] = 100.0 / (smooth_mteval * total[n - 1])
            elif smooth_method == "floor":
                precisions[n - 1] = 100.0 * smooth_value / total[n - 1]
        else:
            precisions[n - 1] = 100.0 * correct[n - 1] / total[n - 1]
    return bp * math.exp(sum(_my_log(p) for p in precisions[:eff_order]) / eff_order)


@metric_loop(fields_to_check=["generation_gt", "generated_texts"])
def bleu(
    metric_inputs: list[MetricInput],
    max_ngram_order: int = 4,
    smooth_method: str = "exp",
    smooth_value: float | None = None,
    effective_order: bool = True,
    **extra: Any,
) -> list[float]:
    # this implementation is bit-parity with sacrebleu's 13a tokenizer ONLY;
    # silently ignoring semantic options (tokenize='intl'/'zh', lowercase,
    # trg_lang) would score materially wrong with no signal
    unsupported = {
        k: v for k, v in extra.items()
        if k in ("tokenize", "lowercase", "trg_lang") and v not in (None, "13a", False)
    }
    if unsupported:
        raise TypeError(
            f"bleu: unsupported sacrebleu option(s) {sorted(unsupported)} — "
            "this implementation matches the default 13a tokenizer only"
        )
    return [
        sentence_bleu(
            mi.generated_texts or "",
            list(mi.generation_gt or []),
            max_ngram_order=max_ngram_order,
            smooth_method=smooth_method,
            smooth_value=smooth_value,
            effective_order=effective_order,
        )
        for mi in metric_inputs
    ]


# ---------------------------------------------------------------------- ROUGE

_ROUGE_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _rouge_tokens(text: str, use_stemmer: bool) -> list[str]:
    tokens = _ROUGE_TOKEN_RE.findall(text.lower())
    if use_stemmer:
        # the shared memoized porter stem (same PorterStemmer.stem meteor
        # uses) — constructing a stemmer per call was pure wasted work;
        # rouge_score's len>3 guard stays
        tokens = [_stem(t) if len(t) > 3 else t for t in tokens]
    return tokens


def _f_measure(matches: int, p_total: int, r_total: int) -> float:
    if p_total == 0 or r_total == 0 or matches == 0:
        return 0.0
    p = matches / p_total
    r = matches / r_total
    return 2 * p * r / (p + r)


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _lcs_indices(ref: Sequence[str], can: Sequence[str]) -> list[int]:
    """Indices into ``ref`` of one LCS, with rouge_score's backtrack
    tie-break (prefer shrinking the candidate when t[i][j-1] > t[i-1][j])."""
    n, m = len(ref), len(can)
    t = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            if ref[i - 1] == can[j - 1]:
                t[i][j] = t[i - 1][j - 1] + 1
            else:
                t[i][j] = max(t[i - 1][j], t[i][j - 1])
    out: list[int] = []
    i, j = n, m
    while i > 0 and j > 0:
        if ref[i - 1] == can[j - 1]:
            out.insert(0, i - 1)
            i -= 1
            j -= 1
        elif t[i][j - 1] > t[i - 1][j]:
            j -= 1
        else:
            i -= 1
    return out


def _summary_level_lcs(
    ref_sents: list[list[str]], can_sents: list[list[str]]
) -> float:
    """rouge_score ``_summary_level_lcs`` mirror (ROUGE paper §3.2 with the
    v1.5.5 double-counting fix): per reference sentence, union-LCS against
    all candidate sentences; hits consume per-token budgets on both sides."""
    if not ref_sents or not can_sents:
        return 0.0
    m = sum(map(len, ref_sents))
    n = sum(map(len, can_sents))
    if not n or not m:
        return 0.0
    token_cnts_r: Counter = Counter()
    token_cnts_c: Counter = Counter()
    for s in ref_sents:
        token_cnts_r.update(s)
    for s in can_sents:
        token_cnts_c.update(s)
    hits = 0
    for r in ref_sents:
        union = sorted(set().union(*[set(_lcs_indices(r, c)) for c in can_sents]))
        for idx in union:
            tok = r[idx]
            if token_cnts_c[tok] > 0 and token_cnts_r[tok] > 0:
                hits += 1
                token_cnts_c[tok] -= 1
                token_cnts_r[tok] -= 1
    return _f_measure(hits, n, m)


def _split_sentences(text: str, split_summaries: bool) -> list[str]:
    if split_summaries:
        try:
            import nltk

            return [s for s in nltk.sent_tokenize(text) if s]
        except (ImportError, LookupError):
            return [s for s in re.split(r"(?<=[.!?])\s+", text) if s]
    return [s for s in text.split("\n") if s]


def rouge_score_single(
    target: str,
    prediction: str,
    rouge_type: str = "rougeL",
    use_stemmer: bool = False,
    split_summaries: bool = False,
) -> float:
    """One (target, prediction) ROUGE f-measure, bit-parity with
    ``rouge_score.RougeScorer`` + ``DefaultTokenizer(use_stemmer)``
    (fuzz-verified in ``tests/test_reference_oracle_generation.py``).
    Reference role: ``generation.py:1079-1121``."""
    if rouge_type in ("rougeLsum", "rougeLSum"):
        t_sents = [
            _rouge_tokens(s, use_stemmer)
            for s in _split_sentences(target, split_summaries)
        ]
        p_sents = [
            _rouge_tokens(s, use_stemmer)
            for s in _split_sentences(prediction, split_summaries)
        ]
        return _summary_level_lcs(t_sents, p_sents)
    t = _rouge_tokens(target, use_stemmer)
    p = _rouge_tokens(prediction, use_stemmer)
    if rouge_type == "rouge1" or rouge_type == "rouge2":
        n = 1 if rouge_type == "rouge1" else 2
        t_ngrams = Counter(tuple(t[i : i + n]) for i in range(len(t) - n + 1))
        p_ngrams = Counter(tuple(p[i : i + n]) for i in range(len(p) - n + 1))
        matches = sum(min(c, t_ngrams[ng]) for ng, c in p_ngrams.items())
        return _f_measure(matches, sum(p_ngrams.values()), sum(t_ngrams.values()))
    if rouge_type == "rougeL":
        matches = _lcs_len(t, p)
        return _f_measure(matches, len(p), len(t))
    raise ValueError(f"unknown rouge_type: {rouge_type}")


@metric_loop(fields_to_check=["generation_gt"])
def rouge(
    metric_inputs: list[MetricInput],
    rouge_type: str | None = "rougeL",
    use_stemmer: bool = False,
    split_summaries: bool = False,
    **_: Any,
) -> list[float]:
    rt = rouge_type or "rougeL"
    return [
        max(
            rouge_score_single(ref, mi.generated_texts or "", rt, use_stemmer, split_summaries)
            for ref in (mi.generation_gt or [""])
        )
        for mi in metric_inputs
    ]


# --------------------------------------------------------------------- METEOR


import functools as _functools


@_functools.lru_cache(maxsize=65536)
def _stem(token: str) -> str:
    # module-level stemmer + memoized stems: meteor's alignment loop compares
    # O(|hyp| x |ref|) token pairs
    global _PORTER_STEMMER
    try:
        stemmer = _PORTER_STEMMER
    except NameError:
        from nltk.stem.porter import PorterStemmer

        stemmer = _PORTER_STEMMER = PorterStemmer()
    return stemmer.stem(token)


def _wordnet_synonyms(token: str) -> set[str]:
    """Single-word synonym set for METEOR's third stage (empty when the
    wordnet corpus is absent)."""
    try:
        from nltk.corpus import wordnet

        return {
            lemma.name()
            for syn in wordnet.synsets(token)
            for lemma in syn.lemmas()
            if "_" not in lemma.name()
        } | {token}
    except (LookupError, ImportError):
        return {token}


def _meteor_tokenize(text: str) -> list[str]:
    """The reference meteor path tokenizes with nltk ``word_tokenize``
    (via HF evaluate); punkt data is absent offline, so fall back to the
    data-free Treebank tokenizer, then to a regex split without nltk."""
    try:
        import nltk

        try:
            return nltk.word_tokenize(text)
        except LookupError:
            from nltk.tokenize.treebank import TreebankWordTokenizer

            return TreebankWordTokenizer().tokenize(text)
    except ImportError:
        return re.findall(r"\w+|[^\w\s]", text)


def _meteor_align(
    hyp: list[str], ref: list[str]
) -> list[tuple[int, int]]:
    """nltk ``_enum_align_words`` mirror: exact, then Porter-stem, then
    wordnet-synonym stages; each stage scans the hypothesis in REVERSE and
    matches to the highest still-unused reference position (this exact
    pairing determines the chunk count, so it must match nltk bit-for-bit)."""

    def match_enums(h_enum, r_enum, key):
        from collections import defaultdict

        ref_positions: dict[str, list[int]] = defaultdict(list)
        for j, (_, w) in enumerate(r_enum):
            ref_positions[key(w)].append(j)
        pairs, used_h, used_r = [], set(), set()
        for i in range(len(h_enum))[::-1]:
            positions = ref_positions.get(key(h_enum[i][1]))
            if positions:
                j = positions.pop()
                used_h.add(i)
                used_r.add(j)
                pairs.append((h_enum[i][0], r_enum[j][0]))
        return (
            pairs,
            [p for i, p in enumerate(h_enum) if i not in used_h],
            [p for j, p in enumerate(r_enum) if j not in used_r],
        )

    def syn_match(h_enum, r_enum):
        from collections import defaultdict

        ref_positions: dict[str, list[int]] = defaultdict(list)
        for j, (_, w) in enumerate(r_enum):
            ref_positions[w].append(j)
        pairs, used_h, used_r = [], set(), set()
        for i in range(len(h_enum))[::-1]:
            best_j, best_word = -1, None
            for syn in _wordnet_synonyms(h_enum[i][1]):
                positions = ref_positions.get(syn)
                if positions and positions[-1] > best_j:
                    best_j, best_word = positions[-1], syn
            if best_word is not None:
                ref_positions[best_word].pop()
                used_h.add(i)
                used_r.add(best_j)
                pairs.append((h_enum[i][0], r_enum[best_j][0]))
        return (
            pairs,
            [p for i, p in enumerate(h_enum) if i not in used_h],
            [p for j, p in enumerate(r_enum) if j not in used_r],
        )

    h_enum = list(enumerate(hyp))
    r_enum = list(enumerate(ref))
    exact, h_enum, r_enum = match_enums(h_enum, r_enum, lambda w: w)
    stem, h_enum, r_enum = match_enums(h_enum, r_enum, _stem)
    syn, h_enum, r_enum = syn_match(h_enum, r_enum)
    return sorted(exact + stem + syn)


class _NoWordnet:
    """Stand-in wordnet corpus reader when the data package is absent."""

    @staticmethod
    def synsets(_word):
        return []


def meteor_single(
    prediction: str,
    reference: str,
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
) -> float:
    """METEOR for one (prediction, reference) pair with nltk
    ``single_meteor_score`` semantics (the reference delegates there via HF
    evaluate, ``generation.py:1046-1077``): delegate to nltk when importable
    (wordnet stage active iff corpus data present), else run the native
    mirror of its alignment. Fuzz-verified in
    ``tests/test_reference_oracle_generation.py``."""
    hyp = _meteor_tokenize(prediction)
    ref = _meteor_tokenize(reference)
    try:
        from nltk.translate.meteor_score import single_meteor_score

        try:
            from nltk.corpus import wordnet

            wordnet.synsets("test")  # force the LookupError early if no data
            wn = wordnet
        except (LookupError, ImportError):
            wn = _NoWordnet()
        return float(
            single_meteor_score(
                ref, hyp, wordnet=wn, alpha=alpha, beta=beta, gamma=gamma
            )
        )
    except ImportError:
        return _meteor_native(hyp, ref, alpha, beta, gamma)


def _meteor_native(
    hyp: list[str], ref: list[str], alpha: float, beta: float, gamma: float
) -> float:
    """Native mirror of nltk ``single_meteor_score`` over pre-tokenized
    inputs (used when nltk is absent; fuzz-checked against nltk in tests)."""
    hyp = [w.lower() for w in hyp]
    ref = [w.lower() for w in ref]
    matches = _meteor_align(hyp, ref)
    m = len(matches)
    if m == 0 or not hyp or not ref:
        return 0.0
    precision = m / len(hyp)
    recall = m / len(ref)
    try:
        f_mean = precision * recall / (alpha * precision + (1 - alpha) * recall)
    except ZeroDivisionError:
        return 0.0
    chunks = 1
    for (i0, j0), (i1, j1) in zip(matches, matches[1:]):
        if i1 != i0 + 1 or j1 != j0 + 1:
            chunks += 1
    penalty = gamma * (chunks / m) ** beta
    return (1 - penalty) * f_mean


@metric_loop(fields_to_check=["generation_gt", "generated_texts"])
def meteor(
    metric_inputs: list[MetricInput],
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
) -> list[float]:
    return [
        max(
            meteor_single(mi.generated_texts or "", ref, alpha, beta, gamma)
            for ref in (mi.generation_gt or [""])
        )
        for mi in metric_inputs
    ]


# ----------------------------------------------------------- embedding-based


@metric_loop(fields_to_check=["generation_gt"])
def sem_score(
    metric_inputs: list[MetricInput],
    embedding_model=None,
    truncate_length: int = 4096,
) -> list[float]:
    """Max cosine(generated, gt_i) using an embedding adapter."""
    if embedding_model is None:
        raise ModelLoadError("sem_score requires embedding_model")
    preds = [(mi.generated_texts or "")[: truncate_length * 4] for mi in metric_inputs]
    pred_embs = embedding_model.embed_texts(preds)
    # flatten every row's GT references into ONE batched embed call (an API
    # embedder otherwise pays N sequential request latencies per batch)
    all_gts: list[str] = []
    spans: list[tuple[int, int]] = []
    for mi in metric_inputs:
        gts = [g[: truncate_length * 4] for g in (mi.generation_gt or [])]
        spans.append((len(all_gts), len(all_gts) + len(gts)))
        all_gts.extend(gts)
    all_gt_embs = embedding_model.embed_texts(all_gts) if all_gts else []
    out = []
    for pe, (lo, hi) in zip(pred_embs, spans):
        out.append(
            max(calculate_cosine_similarity(ge, pe) for ge in all_gt_embs[lo:hi])
        )
    return out


# The RAGAS relevance instruction + JSON contract: these strings ARE the
# compatibility spec — an LLM judged with different wording produces different
# questions/scores than the reference (generation.py:35-60; originally from
# the public ragas project).
RAGAS_RESPONSE_RELEVANCE_INSTRUCTION = (
    "Generate a question for the given answer and Identify if answer is "
    "noncommittal. Give noncommittal as 1 if the answer is noncommittal and 0 "
    "if the answer is committal. A noncommittal answer is one that is evasive, "
    'vague, or ambiguous. For example, "I don\'t know" or "I\'m not sure" are '
    "noncommittal answers"
)

DEFAULT_RESPONSE_RELEVANCY_PROMPT = """Generate a question for the given answer and identify if the answer is noncommittal.

Use this exact instruction:
{instruction}

Return a JSON object:
{{
  "question": "<generated question>",
  "noncommittal": 0 or 1
}}

Example input:
Albert Einstein was born in Germany.
Example output:
{{"question":"Where was Albert Einstein born?","noncommittal":0}}

Example input:
I don't know about the  groundbreaking feature of the smartphone invented in 2023 as am unaware of information beyond 2022.
Example output:
{{"question":"What was the groundbreaking feature of the smartphone invented in 2023?","noncommittal":1}}

Input:
{response}
"""

_JSON_BLOCK_PATTERN = re.compile(r"\{.*\}", re.DOTALL)


def _parse_noncommittal(value: Any) -> int:
    if isinstance(value, str):
        return int(value.strip().lower() in {"1", "true", "yes"})
    return int(bool(value))


def _parse_relevancy_output(text: str) -> tuple[str, int]:
    """Parse the {"question", "noncommittal"} JSON from LLM output, tolerating
    code fences and surrounding prose (reference ``generation.py:166-196``)."""
    import json

    candidate = text.strip()
    if candidate.startswith("```"):
        candidate = re.sub(r"^```(?:json)?\s*", "", candidate).strip()
        candidate = re.sub(r"\s*```$", "", candidate).strip()
    payload: dict[str, Any] = {}
    try:
        loaded = json.loads(candidate)
        if isinstance(loaded, dict):
            payload = loaded
    except json.JSONDecodeError:
        pass
    if not payload:
        match = _JSON_BLOCK_PATTERN.search(candidate)
        if match:
            try:
                loaded = json.loads(match.group(0))
                if isinstance(loaded, dict):
                    payload = loaded
            except json.JSONDecodeError:
                pass
    question = str(payload.get("question", "")).strip()
    return question, _parse_noncommittal(payload.get("noncommittal", 0))


def _relevancy_score(
    query: str,
    questions: list[str],
    noncommittal_flags: list[int],
    embedding_model,
) -> float:
    """Mean cosine(generated question, actual query), zeroed when every
    generation was judged noncommittal (reference ``generation.py:198-216``)."""
    if all(q == "" for q in questions):
        return 0.0
    query_vec = np.asarray(embedding_model.embed_query(query), dtype=np.float64)
    q_vecs = np.asarray(embedding_model.embed_texts(questions), dtype=np.float64)
    norm = np.linalg.norm(q_vecs, axis=1) * np.linalg.norm(query_vec)
    # a failed generation (unparseable JSON -> question "") can embed to a
    # zero vector; 0/0 would poison the metric average with NaN — such
    # samples contribute 0 relevancy instead
    cosine = np.where(norm > 0, (q_vecs @ query_vec) / np.where(norm == 0, 1.0, norm), 0.0)
    all_noncommittal = np.all(noncommittal_flags)
    return float(cosine.mean() * int(not all_noncommittal))


@metric_loop(fields_to_check=["query", "generated_texts"])
def response_relevancy(
    metric_inputs: list[MetricInput],
    llm=None,
    embedding_model=None,
    strictness: int = 3,
    prompt_template: str = DEFAULT_RESPONSE_RELEVANCY_PROMPT,
) -> list[float]:
    """RAGAS-style answer relevancy (reference ``generation.py:1312-1364``):
    the LLM writes ``strictness`` questions from the answer (JSON protocol
    with a noncommittal flag); score = mean cosine(question, actual query),
    zeroed when every sample is noncommittal."""
    if llm is None or embedding_model is None:
        raise ModelLoadError("response_relevancy requires llm and embedding_model")
    if strictness < 1:
        raise ValueError("strictness must be >= 1")

    async def one(mi: MetricInput) -> float:
        import asyncio

        prompt = prompt_template.format(
            instruction=RAGAS_RESPONSE_RELEVANCE_INSTRUCTION,
            response=mi.generated_texts,
        )
        results = await asyncio.gather(*[llm.agenerate(prompt) for _ in range(strictness)])
        parsed = [_parse_relevancy_output(r.text) for r in results]
        questions = [q for q, _ in parsed]
        flags = [f for _, f in parsed]
        return _relevancy_score(mi.query or "", questions, flags, embedding_model)

    async def runner():
        import asyncio

        return await asyncio.gather(*[one(mi) for mi in metric_inputs])

    return list(run_async(runner()))


# ----------------------------------------------------- model-backed (gated)


def _model_scorer(name: str):
    from autorag_research_tpu_torch.evaluation.metrics import model_scorers

    return getattr(model_scorers, name)


@metric_loop(fields_to_check=["generation_gt"])
def bert_score(metric_inputs, **kwargs):
    return _model_scorer("bert_score_batch")(metric_inputs, **kwargs)


@metric_loop(fields_to_check=["retrieved_contents", "generated_texts"])
def bart_score_faithfulness(metric_inputs, **kwargs):
    return _model_scorer("bart_score_batch")(metric_inputs, direction="faithfulness", **kwargs)


@metric_loop(fields_to_check=["generation_gt", "generated_texts"])
def bart_score_precision(metric_inputs, **kwargs):
    return _model_scorer("bart_score_batch")(metric_inputs, direction="precision", **kwargs)


@metric_loop(fields_to_check=["generation_gt", "generated_texts"])
def bart_score_recall(metric_inputs, **kwargs):
    return _model_scorer("bart_score_batch")(metric_inputs, direction="recall", **kwargs)


@metric_loop(fields_to_check=["generation_gt", "generated_texts"])
def bart_score_f1(metric_inputs, **kwargs):
    return _model_scorer("bart_score_batch")(metric_inputs, direction="f1", **kwargs)


@metric_loop(fields_to_check=["generated_texts"])
def unieval(metric_inputs, **kwargs):
    return _model_scorer("unieval_batch")(metric_inputs, **kwargs)


@metric_loop(fields_to_check=["retrieved_contents", "generated_texts"])
def align_score(metric_inputs, **kwargs):
    return _model_scorer("align_score_batch")(metric_inputs, **kwargs)


@metric_loop(fields_to_check=["retrieved_contents", "generated_texts"])
def mini_check(metric_inputs, **kwargs):
    return _model_scorer("mini_check_batch")(metric_inputs, **kwargs)


@metric_loop(fields_to_check=["generation_gt", "generated_texts"])
def huggingface_evaluate(
    metric_inputs: list[MetricInput],
    metric_name: str = "meteor",
    **kwargs: Any,
) -> list[float]:
    """Generic bridge to any ``evaluate``-hub metric (reference
    ``generation.py:832``): loads the metric by name and scores each
    (prediction, best-reference) pair. Requires the ``evaluate`` package and,
    for most metrics, network access on first load."""
    try:
        import evaluate as hf_evaluate
    except ImportError as exc:
        raise ModelLoadError(
            "huggingface_evaluate requires the 'evaluate' package"
        ) from exc
    scorer = hf_evaluate.load(metric_name)
    out = []
    for mi in metric_inputs:
        refs = list(mi.generation_gt or [""])
        best: float | None = None
        for ref in refs:
            result = scorer.compute(
                predictions=[mi.generated_texts or ""], references=[ref], **kwargs
            )
            # explicit key lookup: a legitimate 0.0 must not fall through to an
            # arbitrary other stat, and signed metrics keep their sign
            value = result[metric_name] if metric_name in result else next(iter(result.values()))
            if isinstance(value, list):
                value = value[0]
            value = float(value)
            best = value if best is None else max(best, value)
        out.append(best if best is not None else 0.0)
    return out


# -------------------------------------------------------------------- registry

GENERATION_METRICS: dict[str, Callable] = {
    "bleu": bleu,
    "meteor": meteor,
    "rouge": rouge,
    "exact_match": exact_match,
    "token_f1": token_f1,
    "sem_score": sem_score,
    "response_relevancy": response_relevancy,
    "bert_score": bert_score,
    "bart_score_faithfulness": bart_score_faithfulness,
    "bart_score_precision": bart_score_precision,
    "bart_score_recall": bart_score_recall,
    "bart_score_f1": bart_score_f1,
    "unieval": unieval,
    "align_score": align_score,
    "mini_check": mini_check,
    "huggingface_evaluate": huggingface_evaluate,
}

# The entries that run a model through ``model_scorers``: they take a
# ``device`` keyword, which ``BuildContext.metric_extras`` fills with the
# context's device unless the metric's config sets one.
MODEL_SCORER_METRICS = frozenset({
    "bert_score", "bart_score_faithfulness", "bart_score_precision", "bart_score_recall",
    "bart_score_f1", "unieval", "align_score", "mini_check",
})
