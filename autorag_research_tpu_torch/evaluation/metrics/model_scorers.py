"""Model-backed generation scorers (BERTScore, BARTScore, UniEval, AlignScore,
MiniCheck).

Capability parity with the reference's HF-model metrics
(``evaluation/metrics/generation.py:885-1003`` BARTScore forced-decode scorer,
``:1179-1220`` BERTScore, ``unieval.py:18-116`` T5 yes/no scorer,
``:1443-1523`` AlignScore with context windowing, ``:1525+`` MiniCheck).

These scorers require a *local* HF checkpoint directory (``checkpoint=...``)
and never download one. They run the models through ``transformers`` on
``device`` (``"cuda"`` unless the caller asks for another; the Executor
passes its ``BuildContext`` device); asked for ``cuda`` on a machine without
one, they raise. Where ``transformers`` or the checkpoint is missing they
raise ``ModelLoadError`` with guidance instead of failing obscurely, and
nothing falls back to another scorer.

The port's copy of the JAX package's ``evaluation/metrics/model_scorers.py``
(that file already runs its models in PyTorch). ``tests/test_torch_metrics_generation.py``
holds it against the JAX copy on tiny random-init checkpoints built offline
(``tests/tiny_models.py``).
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np

from autorag_research_tpu_torch.exceptions import ModelLoadError
from autorag_research_tpu_torch.schema import MetricInput

DEFAULT_BARTSCORE_CHECKPOINT = "facebook/bart-large-cnn"
DEFAULT_UNIEVAL_CHECKPOINT = "MingZhong/unieval-sum"
DEFAULT_ALIGNSCORE_CHECKPOINT = "krotima1/AlignScore-base"
DEFAULT_MINICHECK_CHECKPOINT = "lytang/MiniCheck-Flan-T5-Large"
DEFAULT_BERTSCORE_CHECKPOINT = "roberta-large"


def _to_device(model, device):
    """``model`` in eval mode on ``device``; a CUDA device without a card
    raises rather than scoring on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"model scorer asked for device '{dev}', but CUDA is not available "
            "(pass device='cpu' to score on the CPU)"
        )
    return model.eval().to(dev)


@functools.lru_cache(maxsize=4)
def _load_seq2seq(checkpoint: str, device: str = "cuda"):
    try:
        import torch  # noqa: F401
        from transformers import AutoModelForSeq2SeqLM, AutoTokenizer

        tok = AutoTokenizer.from_pretrained(checkpoint, local_files_only=True)
        model = AutoModelForSeq2SeqLM.from_pretrained(checkpoint, local_files_only=True)
    except Exception as exc:  # noqa: BLE001
        raise ModelLoadError(
            f"cannot load local seq2seq checkpoint '{checkpoint}' "
            "(zero-egress image: pass checkpoint=<local path> to this metric)"
        ) from exc
    return tok, _to_device(model, device)


@functools.lru_cache(maxsize=4)
def _load_encoder(checkpoint: str, device: str = "cuda"):
    try:
        import torch  # noqa: F401
        from transformers import AutoModel, AutoTokenizer

        tok = AutoTokenizer.from_pretrained(checkpoint, local_files_only=True)
        model = AutoModel.from_pretrained(checkpoint, local_files_only=True)
    except Exception as exc:  # noqa: BLE001
        raise ModelLoadError(
            f"cannot load local encoder checkpoint '{checkpoint}' "
            "(zero-egress image: pass checkpoint=<local path> to this metric)"
        ) from exc
    return tok, _to_device(model, device)


def _forced_decode_logprob(tok, model, sources: list[str], targets: list[str],
                           max_length: int, batch_size: int) -> list[float]:
    """Mean per-token log-likelihood of target given source (BARTScore core,
    reference ``generation.py:885-1003``)."""
    import torch

    scores: list[float] = []
    loss_fct = torch.nn.NLLLoss(reduction="none", ignore_index=model.config.pad_token_id)
    lsm = torch.nn.LogSoftmax(dim=1)
    with torch.no_grad():
        for i in range(0, len(sources), batch_size):
            src = sources[i : i + batch_size]
            tgt = targets[i : i + batch_size]
            enc_src = tok(src, truncation=True, padding=True, max_length=max_length,
                          return_tensors="pt").to(model.device)
            enc_tgt = tok(tgt, truncation=True, padding=True, max_length=max_length,
                          return_tensors="pt").to(model.device)
            tgt_ids = enc_tgt["input_ids"]
            tgt_mask = enc_tgt["attention_mask"].float()
            output = model(
                input_ids=enc_src["input_ids"],
                attention_mask=enc_src["attention_mask"],
                labels=tgt_ids,
            )
            logits = output.logits.view(-1, model.config.vocab_size)
            loss = loss_fct(lsm(logits), tgt_ids.view(-1))
            loss = loss.view(tgt_ids.shape[0], -1) * tgt_mask
            # reference divides by clamped non-pad target length
            # (generation.py:926-933); ignore_index already zeroes pads
            scores.extend((-loss.sum(dim=1) / tgt_mask.sum(dim=1).clamp(min=1)).tolist())
    return scores


def bart_score_batch(
    metric_inputs: list[MetricInput],
    direction: str = "faithfulness",
    checkpoint: str = DEFAULT_BARTSCORE_CHECKPOINT,
    batch_size: int = 4,
    max_length: int = 1024,
    device: str = "cuda",
    **_: Any,
) -> list[float]:
    """direction: faithfulness = p(answer|context); precision = p(answer|gt);
    recall = p(gt|answer); f1 = harmonic-style mean of both directions."""
    tok, model = _load_seq2seq(checkpoint, str(device))

    def score(srcs, tgts):
        return _forced_decode_logprob(tok, model, srcs, tgts, max_length, batch_size)

    if direction == "faithfulness":
        # reference _join_retrieved_contents: double-newline join of STRIPPED
        # passages is the conditioning context
        srcs = [
            "\n\n".join(c.strip() for c in (mi.retrieved_contents or []))
            for mi in metric_inputs
        ]
        tgts = [mi.generated_texts or "" for mi in metric_inputs]
        return score(srcs, tgts)

    preds = [mi.generated_texts or "" for mi in metric_inputs]
    # best reference per input
    out = []
    for mi, pred in zip(metric_inputs, preds):
        refs = list(mi.generation_gt or [""])
        if direction == "precision":
            vals = score(refs, [pred] * len(refs))
        elif direction == "recall":
            vals = score([pred] * len(refs), refs)
        elif direction == "f1":
            # reference bart_score_f1: (max-over-refs precision +
            # max-over-refs recall) / 2 — NOT max over per-ref means, which
            # is strictly smaller whenever the best directions come from
            # different references
            p = score(refs, [pred] * len(refs))
            r = score([pred] * len(refs), refs)
            vals = [(max(p) + max(r)) / 2]
        else:
            raise ValueError(f"unknown bart_score direction: {direction}")
        out.append(max(vals))
    return out


def bert_score_batch(
    metric_inputs: list[MetricInput],
    checkpoint: str = DEFAULT_BERTSCORE_CHECKPOINT,
    batch: int = 32,
    layer: int = -2,
    device: str = "cuda",
    **_: Any,
) -> list[float]:
    """Greedy token-similarity F1 between prediction and best reference using
    contextual embeddings (BERTScore, reference ``generation.py:1179-1220``)."""
    import torch

    tok, model = _load_encoder(checkpoint, str(device))

    def embed(texts: list[str]):
        with torch.no_grad():
            enc = tok(texts, truncation=True, padding=True, max_length=512,
                      return_tensors="pt").to(model.device)
            hidden = model(**enc, output_hidden_states=True).hidden_states[layer]
            mask = enc["attention_mask"].bool()
        return hidden, mask

    out = []
    for mi in metric_inputs:
        pred = mi.generated_texts or ""
        refs = list(mi.generation_gt or [""])
        ph, pm = embed([pred])
        best = 0.0
        for ref in refs:
            rh, rm = embed([ref])
            p = torch.nn.functional.normalize(ph[0][pm[0]], dim=-1)
            r = torch.nn.functional.normalize(rh[0][rm[0]], dim=-1)
            sim = p @ r.T
            if sim.numel() == 0:
                continue
            precision = sim.max(dim=1).values.mean().item()
            recall = sim.max(dim=0).values.mean().item()
            f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
            best = max(best, f1)
        out.append(best)
    return out


def _split_sentences(text: str) -> list[str]:
    """Sentence-split with a regex fallback when punkt data is unavailable —
    the claim/sentence unit shared by UniEval, AlignScore, and MiniCheck
    (reference ``generation.py:228-234,347-371``)."""
    import re

    stripped = text.strip()
    if not stripped:
        return []
    try:
        import nltk

        sentences = [s.strip() for s in nltk.sent_tokenize(stripped) if s.strip()]
    except LookupError:
        sentences = [s.strip() for s in re.split(r"(?<=[.!?])\s+", stripped) if s.strip()]
    return sentences or [stripped]


# The official UniEval summarization Bool-QA prompts, `</s>` separators
# included (published UniEval `add_question` templates; reference
# ``generation.py:237-265``).
_UNIEVAL_PROMPTS = {
    "fluency": "question: Is this a fluent paragraph? </s> paragraph: {text}",
    "coherence": (
        "question: Is this a coherent summary to the document? "
        "</s> summary: {text} </s> document: {document}"
    ),
    "consistency": (
        "question: Is this claim consistent with the document? "
        "</s> claim: {text} </s> document: {document}"
    ),
    "relevance": (
        "question: Is this summary relevant to the reference? "
        "</s> summary: {text} </s> reference: {reference}"
    ),
}
_UNIEVAL_FIELDS = {
    "fluency": ("generated_texts",),
    "coherence": ("generated_texts", "retrieved_contents"),
    "consistency": ("generated_texts", "retrieved_contents"),
    "relevance": ("generated_texts", "generation_gt"),
}


def unieval_batch(
    metric_inputs: list[MetricInput],
    dimension: str = "consistency",
    checkpoint: str = DEFAULT_UNIEVAL_CHECKPOINT,
    batch_size: int = 8,
    max_length: int = 1024,
    device: str = "cuda",
    **_: Any,
) -> list[float | None]:
    """One UniEval dimension via the official summarization Bool-QA contract
    (reference ``unieval.py:18-116`` scorer + ``generation.py:1363-1440``):
    fluency/consistency score per generated SENTENCE and average; coherence
    scores the full text once; relevance keeps the best score over all
    references. Score per prompt = p(Yes)/(p(Yes)+p(No)) at the first decoder
    position. Missing required fields -> None."""
    import torch

    dimension = dimension.strip().lower()
    if dimension not in _UNIEVAL_PROMPTS:
        raise ValueError(f"unsupported UniEval dimension: {dimension}")
    tok, model = _load_seq2seq(checkpoint, str(device))
    yes_id = tok("Yes", add_special_tokens=False)["input_ids"][0]
    no_id = tok("No", add_special_tokens=False)["input_ids"][0]

    def yes_prob(prompts: list[str]) -> list[float]:
        probs: list[float] = []
        with torch.no_grad():
            for i in range(0, len(prompts), batch_size):
                enc = tok(
                    prompts[i : i + batch_size],
                    truncation=True, padding=True,
                    max_length=max_length, return_tensors="pt",
                ).to(model.device)
                start = torch.full(
                    (enc["input_ids"].shape[0], 1), model.config.decoder_start_token_id,
                    device=model.device,
                )
                logits = model(**enc, decoder_input_ids=start).logits[:, 0, :]
                full = torch.softmax(logits, dim=1)
                yes, no = full[:, yes_id], full[:, no_id]
                probs.extend((yes / (yes + no)).tolist())
        return probs

    def prompts_for(mi: MetricInput) -> list[str]:
        text = (mi.generated_texts or "").strip()
        if dimension == "relevance":
            refs = [r.strip() for r in (mi.generation_gt or []) if r.strip()]
            return [_UNIEVAL_PROMPTS["relevance"].format(text=text, reference=r) for r in refs]
        document = " ".join(c.strip() for c in (mi.retrieved_contents or []))
        units = _split_sentences(text) if dimension in ("fluency", "consistency") else [text]
        return [_UNIEVAL_PROMPTS[dimension].format(text=u, document=document) for u in units]

    out: list[float | None] = []
    for mi in metric_inputs:
        if any(getattr(mi, f, None) is None for f in _UNIEVAL_FIELDS[dimension]):
            out.append(None)
            continue
        prompts = prompts_for(mi)
        if not prompts:
            out.append(None)
            continue
        scores = yes_prob(prompts)
        if dimension == "relevance":
            out.append(max(scores))
        elif dimension == "coherence":
            out.append(scores[0])
        else:
            out.append(float(np.mean(scores)))
    return out


def _positive_label_id(model) -> int:
    """Entailment/support class id from config labels, else the last label
    (reference ``generation.py:658-665``)."""
    id2label = getattr(model.config, "id2label", {}) or {}
    for label_id, label in id2label.items():
        if any(t in str(label).strip().lower() for t in ("entail", "support", "positive", "consistent")):
            return int(label_id)
    return max(0, int(getattr(model.config, "num_labels", 2)) - 1)


def _alignment_probability(torch, output, positive_id: int):
    """Support probability under every AlignScore head protocol
    (reference ``generation.py:667-678``)."""
    if hasattr(output, "tri_label_logits"):
        return torch.softmax(output.tri_label_logits, dim=-1)[:, 0]
    if hasattr(output, "seq_relationship_logits"):
        return torch.softmax(output.seq_relationship_logits, dim=-1)[:, 1]
    if hasattr(output, "reg_label_logits"):
        return output.reg_label_logits.reshape(-1)
    logits = output.logits
    if logits.shape[-1] == 1:
        return torch.sigmoid(logits).reshape(-1)
    return torch.softmax(logits, dim=-1)[:, positive_id]


def _alignscore_windows(
    tok, contents: list[str], claim: str, max_length: int, token_overlap: int = 32
) -> list[str]:
    """Token-budgeted context windows: pack whole sentences up to the budget
    left by the claim + pair special tokens; overlong single sentences split
    into overlapping token windows (reference ``generation.py:401-478``)."""
    special = (
        int(tok.num_special_tokens_to_add(pair=True))
        if hasattr(tok, "num_special_tokens_to_add")
        else 3
    )
    claim_tokens = len(tok.encode(claim, add_special_tokens=False))
    budget = max_length - claim_tokens - special
    if claim_tokens > max_length - special:
        raise ValueError(
            f"AlignScore claim exceeds the model token budget ({claim_tokens} tokens, "
            f"max_length={max_length})"
        )
    windows: list[str] = []
    for content in contents:
        stripped = content.strip()
        if not stripped:
            continue
        current: list[str] = []
        used = 0
        for sentence in _split_sentences(stripped):
            n_tok = len(tok.encode(sentence, add_special_tokens=False))
            if n_tok > budget:
                if current:
                    windows.append(" ".join(current))
                    current, used = [], 0
                ids = tok.encode(sentence, add_special_tokens=False)
                stride = max(1, budget - min(token_overlap, max(0, budget - 1)))
                for start in range(0, len(ids), stride):
                    piece = tok.decode(ids[start : start + budget], skip_special_tokens=True).strip()
                    if piece:
                        windows.append(piece)
                    if start + budget >= len(ids):
                        break
                continue
            if current and used + n_tok > budget:
                windows.append(" ".join(current))
                current, used = [], 0
            current.append(sentence)
            used += n_tok
        if current:
            windows.append(" ".join(current))
    return windows


def align_score_batch(
    metric_inputs: list[MetricInput],
    checkpoint: str = DEFAULT_ALIGNSCORE_CHECKPOINT,
    max_length: int = 512,
    batch_size: int = 8,
    aggregation: str = "mean",
    device: str = "cuda",
    **_: Any,
) -> list[float | None]:
    """AlignScore factual consistency (reference ``generation.py:1443-1523``):
    split the answer into sentence claims, score each claim against every
    token-budgeted context window (pair-encoded, ``truncation='only_first'``),
    keep the best window per claim, then mean/min over claims."""
    if aggregation not in ("mean", "min"):
        raise ValueError(f"unsupported AlignScore aggregation: {aggregation}")
    try:
        import torch
        from transformers import AutoModelForSequenceClassification, AutoTokenizer

        tok = AutoTokenizer.from_pretrained(checkpoint, local_files_only=True)
        model = AutoModelForSequenceClassification.from_pretrained(checkpoint, local_files_only=True)
    except Exception as exc:  # noqa: BLE001
        raise ModelLoadError(
            f"cannot load local alignscore checkpoint '{checkpoint}'"
        ) from exc
    model = _to_device(model, device)
    positive_id = _positive_label_id(model)

    def score_pairs(contexts: list[str], claims: list[str]) -> list[float]:
        scores: list[float] = []
        with torch.no_grad():
            for i in range(0, len(contexts), batch_size):
                enc = tok(
                    contexts[i : i + batch_size],
                    claims[i : i + batch_size],
                    max_length=max_length,
                    truncation="only_first",
                    padding="max_length",
                    return_tensors="pt",
                ).to(model.device)
                probs = _alignment_probability(torch, model(**enc), positive_id)
                scores.extend(float(p) for p in probs.tolist())
        return scores

    out: list[float | None] = []
    for mi in metric_inputs:
        if mi.retrieved_contents is None or mi.generated_texts is None:
            out.append(None)
            continue
        claims = _split_sentences(mi.generated_texts)
        claim_scores: list[float] = []
        for claim in claims:
            windows = _alignscore_windows(tok, mi.retrieved_contents, claim, max_length)
            if not windows:
                continue
            claim_scores.append(max(score_pairs(windows, [claim] * len(windows))))
        if not claim_scores:
            out.append(None)
            continue
        out.append(min(claim_scores) if aggregation == "min" else float(np.mean(claim_scores)))
    return out


def mini_check_batch(
    metric_inputs: list[MetricInput],
    checkpoint: str = DEFAULT_MINICHECK_CHECKPOINT,
    max_length: int = 2048,
    batch_size: int = 8,
    context_strategy: str = "max",
    aggregation: str = "mean",
    support_token_id: int = 209,
    unsupported_token_id: int = 3,
    device: str = "cuda",
    **_: Any,
) -> list[float | None]:
    """MiniCheck claim grounding (reference ``generation.py:1525-1612``):
    sentence claims scored against each retrieved passage (``max``) or their
    concatenation (``concat``) with the official ``predict: {doc}</s>{claim}``
    source and p(support) = softmax over the (unsupported, support) label
    token logits at decoder position 0; best context per claim, mean/min over
    claims. Default label ids are the ``lytang/MiniCheck-Flan-T5-Large``
    contract (209 support / 3 unsupported)."""
    if context_strategy not in ("max", "concat"):
        raise ValueError(f"unsupported MiniCheck context_strategy: {context_strategy}")
    if aggregation not in ("mean", "min"):
        raise ValueError(f"unsupported MiniCheck aggregation: {aggregation}")
    import torch

    tok, model = _load_seq2seq(checkpoint, str(device))
    sep = tok.eos_token or "</s>"

    def score_pairs(docs: list[str], claims: list[str]) -> list[float]:
        scores: list[float] = []
        with torch.no_grad():
            for i in range(0, len(docs), batch_size):
                srcs = [
                    f"predict: {d}{sep}{c}"
                    for d, c in zip(docs[i : i + batch_size], claims[i : i + batch_size])
                ]
                enc = tok(srcs, max_length=max_length, truncation=True, padding=True,
                          return_tensors="pt").to(model.device)
                dec = torch.zeros((len(srcs), 1), dtype=torch.long, device=model.device)
                logits = model(**enc, decoder_input_ids=dec).logits[:, 0, :]
                pair = logits[:, [unsupported_token_id, support_token_id]]
                scores.extend(torch.softmax(pair, dim=-1)[:, 1].tolist())
        return scores

    out: list[float | None] = []
    for mi in metric_inputs:
        if mi.retrieved_contents is None or mi.generated_texts is None:
            out.append(None)
            continue
        contexts = [c.strip() for c in mi.retrieved_contents if c.strip()]
        if context_strategy == "concat" and contexts:
            contexts = ["\n\n".join(contexts)]
        claims = _split_sentences(mi.generated_texts)
        if not contexts or not claims:
            out.append(None)
            continue
        claim_scores = []
        for claim in claims:
            claim_scores.append(max(score_pairs(contexts, [claim] * len(contexts))))
        out.append(min(claim_scores) if aggregation == "min" else float(np.mean(claim_scores)))
    return out
