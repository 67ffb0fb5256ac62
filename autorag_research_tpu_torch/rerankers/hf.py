"""Local-checkpoint HF rerankers (zero-egress: require a local model dir).

Capability parity with the reference's local torch rerankers — cross-encoder
sentence_transformer/koreranker/flag_embedding (``rerankers/*.py``), MonoT5
(``rerankers/monot5.py``), UPR query-likelihood (``rerankers/upr.py``).
Each raises ``ModelLoadError`` with guidance when the checkpoint is absent.

The port's copy of the JAX package's ``rerankers/hf.py`` (that file already
runs its models in PyTorch). The torch-backed rerankers (cross-encoder,
MonoT5, UPR, the flag LLM reranker, TART) run on ``device`` (``"cuda"``
unless the caller asks for another; the model registry passes its own), as
``evaluation/metrics/model_scorers.py`` does: asked for ``cuda`` on a machine
without one, they raise, and nothing falls back to another reranker. The
ONNX and OpenVINO rerankers run where their runtimes put them.
"""

from __future__ import annotations

import functools
from typing import Sequence

from autorag_research_tpu_torch.evaluation.metrics.model_scorers import _to_device
from autorag_research_tpu_torch.exceptions import ModelLoadError
from autorag_research_tpu_torch.rerankers.base import BaseReranker


@functools.lru_cache(maxsize=4)
def _load_cross_encoder(checkpoint: str, device: str = "cuda"):
    try:
        from transformers import AutoModelForSequenceClassification, AutoTokenizer

        tok = AutoTokenizer.from_pretrained(checkpoint, local_files_only=True)
        model = AutoModelForSequenceClassification.from_pretrained(
            checkpoint, local_files_only=True
        )
    except Exception as exc:  # noqa: BLE001
        raise ModelLoadError(
            f"cannot load local cross-encoder '{checkpoint}' (zero-egress image: "
            "pass a local checkpoint directory)"
        ) from exc
    return tok, _to_device(model, device)


class CrossEncoderReranker(BaseReranker):
    """(query, passage) -> relevance logit via a local sequence classifier."""

    def __init__(
        self, checkpoint: str, batch_size: int = 16, max_length: int = 512, device: str = "cuda"
    ):
        self.checkpoint = checkpoint
        self.batch_size = batch_size
        self.max_length = max_length
        self.device = str(device)
        self.model_name = f"cross_encoder({checkpoint})"

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        import torch

        tok, model = _load_cross_encoder(self.checkpoint, self.device)
        scores: list[float] = []
        with torch.no_grad():
            for i in range(0, len(texts), self.batch_size):
                batch = list(texts[i : i + self.batch_size])
                enc = tok(
                    [query] * len(batch),
                    batch,
                    truncation=True,
                    padding=True,
                    max_length=self.max_length,
                    return_tensors="pt",
                ).to(model.device)
                logits = model(**enc).logits
                if logits.shape[-1] == 1:
                    scores.extend(logits[:, 0].tolist())
                else:
                    scores.extend(torch.softmax(logits, -1)[:, -1].tolist())
        return self._finalize(
            [(i, t, float(s)) for i, (t, s) in enumerate(zip(texts, scores))], top_k
        )


class MonoT5Reranker(BaseReranker):
    """MonoT5: p('true') for 'Query: .. Document: .. Relevant:' prompts."""

    def __init__(
        self,
        checkpoint: str = "castorini/monot5-base-msmarco",
        batch_size: int = 8,
        device: str = "cuda",
    ):
        self.checkpoint = checkpoint
        self.batch_size = batch_size
        self.device = str(device)
        self.model_name = f"monot5({checkpoint})"

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        import torch

        from autorag_research_tpu_torch.evaluation.metrics.model_scorers import _load_seq2seq

        tok, model = _load_seq2seq(self.checkpoint, self.device)
        true_id = tok("true", add_special_tokens=False)["input_ids"][0]
        false_id = tok("false", add_special_tokens=False)["input_ids"][0]
        scores: list[float] = []
        with torch.no_grad():
            for i in range(0, len(texts), self.batch_size):
                batch = list(texts[i : i + self.batch_size])
                prompts = [f"Query: {query} Document: {t} Relevant:" for t in batch]
                enc = tok(prompts, truncation=True, padding=True, max_length=512,
                          return_tensors="pt").to(model.device)
                start = torch.full((len(batch), 1), model.config.decoder_start_token_id,
                                   device=model.device)
                logits = model(**enc, decoder_input_ids=start).logits[:, 0, :]
                pair = torch.stack([logits[:, true_id], logits[:, false_id]], dim=1)
                scores.extend(torch.softmax(pair, 1)[:, 0].tolist())
        return self._finalize(
            [(i, t, float(s)) for i, (t, s) in enumerate(zip(texts, scores))], top_k
        )


class UPRReranker(BaseReranker):
    """UPR: query log-likelihood given the passage under a local seq2seq LM."""

    def __init__(
        self,
        checkpoint: str = "t5-base",
        batch_size: int = 4,
        max_length: int = 512,
        device: str = "cuda",
    ):
        self.checkpoint = checkpoint
        self.batch_size = batch_size
        self.max_length = max_length
        self.device = str(device)
        self.model_name = f"upr({checkpoint})"

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        from autorag_research_tpu_torch.evaluation.metrics.model_scorers import (
            _forced_decode_logprob,
            _load_seq2seq,
        )

        tok, model = _load_seq2seq(self.checkpoint, self.device)
        sources = [
            f"Passage: {t}. Please write a question based on this passage." for t in texts
        ]
        scores = _forced_decode_logprob(
            tok, model, sources, [query] * len(texts), self.max_length, self.batch_size
        )
        return self._finalize(
            [(i, t, float(s)) for i, (t, s) in enumerate(zip(texts, scores))], top_k
        )


class FlagLLMReranker(BaseReranker):
    """FlagEmbedding LLM reranker (bge-reranker-v2-gemma class): a causal LM
    judges '(query, passage)' with the published yes/no prompt; the score is
    p('Yes') from the final-position logits. Reference role:
    ``rerankers/flag_embedding_llm.py``."""

    PROMPT = (
        "Given a query A and a passage B, determine whether the passage "
        "contains an answer to the query by providing a prediction of either "
        "'Yes' or 'No'.\nA: {query}\nB: {passage}\nPrediction:"
    )

    def __init__(
        self, checkpoint: str, batch_size: int = 4, max_length: int = 1024, device: str = "cuda"
    ):
        self.checkpoint = checkpoint
        self.batch_size = batch_size
        self.max_length = max_length
        self.device = str(device)
        self.model_name = f"flag_llm({checkpoint})"

    @staticmethod
    @functools.lru_cache(maxsize=2)
    def _load(checkpoint: str, device: str = "cuda"):
        try:
            from transformers import AutoModelForCausalLM, AutoTokenizer

            tok = AutoTokenizer.from_pretrained(checkpoint, local_files_only=True)
            if tok.pad_token is None:
                tok.pad_token = tok.eos_token or tok.unk_token
            model = AutoModelForCausalLM.from_pretrained(checkpoint, local_files_only=True)
        except Exception as exc:  # noqa: BLE001
            raise ModelLoadError(
                f"cannot load local causal-LM reranker '{checkpoint}'"
            ) from exc
        return tok, _to_device(model, device)

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        import torch

        tok, model = self._load(self.checkpoint, self.device)
        # FlagEmbedding scores with the raw Yes-token logit alone (last sub-token
        # when 'Yes' splits) — softmax over (Yes,No) is NOT order-equivalent.
        yes_id = tok("Yes", add_special_tokens=False)["input_ids"][-1]
        scores: list[float] = []
        with torch.no_grad():
            for i in range(0, len(texts), self.batch_size):
                batch = list(texts[i : i + self.batch_size])
                prompts = [self.PROMPT.format(query=query, passage=t) for t in batch]
                enc = tok(
                    prompts, truncation=True, padding=True,
                    max_length=self.max_length, return_tensors="pt",
                ).to(model.device)
                logits = model(**enc).logits  # [B, T, V]
                # final REAL position per row (right padding)
                last = enc["attention_mask"].sum(dim=1) - 1
                rows = torch.arange(len(batch), device=model.device)
                final = logits[rows, last]
                scores.extend(final[:, yes_id].tolist())
        return self._finalize(
            [(i, t, float(s)) for i, (t, s) in enumerate(zip(texts, scores))], top_k
        )


class TARTReranker(BaseReranker):
    """TART: instruction-conditioned cross-encoder — the instruction prefixes
    the query ('{instruction} [SEP] {query}') so one model serves many intents.
    Reference role: ``rerankers/tart.py``."""

    def __init__(
        self,
        checkpoint: str,
        instruction: str = "Find passage to answer given question",
        batch_size: int = 16,
        max_length: int = 512,
        device: str = "cuda",
    ):
        self.checkpoint = checkpoint
        self.instruction = instruction
        self.batch_size = batch_size
        self.max_length = max_length
        self.device = str(device)
        self.model_name = f"tart({checkpoint})"

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        import torch

        tok, model = _load_cross_encoder(self.checkpoint, self.device)
        sep = tok.sep_token or "[SEP]"
        directed = f"{self.instruction} {sep} {query}"
        scores: list[float] = []
        with torch.no_grad():
            for i in range(0, len(texts), self.batch_size):
                batch = list(texts[i : i + self.batch_size])
                enc = tok(
                    [directed] * len(batch), batch, truncation=True, padding=True,
                    max_length=self.max_length, return_tensors="pt",
                ).to(model.device)
                logits = model(**enc).logits
                if logits.shape[-1] == 1:
                    scores.extend(logits[:, 0].tolist())
                else:
                    scores.extend(torch.softmax(logits, -1)[:, -1].tolist())
        return self._finalize(
            [(i, t, float(s)) for i, (t, s) in enumerate(zip(texts, scores))], top_k
        )


class FlashRankReranker(BaseReranker):
    """FlashRank-class ONNX cross-encoder: quantized int8 inference through
    onnxruntime (reference role: ``rerankers/flashrank.py``). The checkpoint
    directory must hold the tokenizer plus an exported ``model.onnx``."""

    def __init__(self, checkpoint: str, batch_size: int = 32, max_length: int = 512):
        self.checkpoint = checkpoint
        self.batch_size = batch_size
        self.max_length = max_length
        self.model_name = f"flashrank({checkpoint})"

    @staticmethod
    @functools.lru_cache(maxsize=2)
    def _load(checkpoint: str):
        try:
            import onnxruntime  # noqa: F401
            from transformers import AutoTokenizer
        except ImportError as exc:
            raise ModelLoadError(
                "flashrank reranker needs the onnxruntime package (not in this "
                "image); use reranker type 'cross_encoder' for the torch path"
            ) from exc
        try:
            import os

            tok = AutoTokenizer.from_pretrained(checkpoint, local_files_only=True)
            sess = onnxruntime.InferenceSession(os.path.join(checkpoint, "model.onnx"))
            return tok, sess
        except Exception as exc:  # noqa: BLE001
            raise ModelLoadError(
                f"cannot load ONNX reranker from '{checkpoint}'"
            ) from exc

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        import numpy as np

        tok, sess = self._load(self.checkpoint)
        input_names = {i.name for i in sess.get_inputs()}
        scores: list[float] = []
        for i in range(0, len(texts), self.batch_size):
            batch = list(texts[i : i + self.batch_size])
            enc = tok(
                [query] * len(batch), batch, truncation=True, padding=True,
                max_length=self.max_length, return_tensors="np",
            )
            feed = {k: v.astype(np.int64) for k, v in enc.items() if k in input_names}
            logits = sess.run(None, feed)[0]
            if logits.shape[-1] == 1:
                scores.extend(logits[:, 0].tolist())
            else:
                e = np.exp(logits - logits.max(-1, keepdims=True))
                scores.extend((e / e.sum(-1, keepdims=True))[:, -1].tolist())
        return self._finalize(
            [(i, t, float(s)) for i, (t, s) in enumerate(zip(texts, scores))], top_k
        )


class OpenVINOReranker(BaseReranker):
    """OpenVINO-compiled cross-encoder (reference role: ``rerankers/openvino.py``).
    Requires the optimum-intel/openvino runtime; absent here, it raises with
    guidance toward the torch cross_encoder."""

    def __init__(self, checkpoint: str, batch_size: int = 32, max_length: int = 512):
        self.checkpoint = checkpoint
        self.batch_size = batch_size
        self.max_length = max_length
        self.model_name = f"openvino({checkpoint})"

    @staticmethod
    @functools.lru_cache(maxsize=2)
    def _load(checkpoint: str):
        try:
            from optimum.intel import OVModelForSequenceClassification
            from transformers import AutoTokenizer
        except ImportError as exc:
            raise ModelLoadError(
                "openvino reranker needs optimum-intel (not in this image); "
                "use reranker type 'cross_encoder' for the torch path"
            ) from exc
        tok = AutoTokenizer.from_pretrained(checkpoint, local_files_only=True)
        model = OVModelForSequenceClassification.from_pretrained(
            checkpoint, local_files_only=True
        )
        return tok, model

    def rerank(self, query: str, texts: Sequence[str], top_k: int | None = None):
        import torch

        tok, model = self._load(self.checkpoint)
        scores: list[float] = []
        for i in range(0, len(texts), self.batch_size):
            batch = list(texts[i : i + self.batch_size])
            enc = tok(
                [query] * len(batch), batch, truncation=True, padding=True,
                max_length=self.max_length, return_tensors="pt",
            )
            logits = torch.as_tensor(model(**enc).logits)
            if logits.shape[-1] == 1:
                scores.extend(logits[:, 0].tolist())
            else:
                scores.extend(torch.softmax(logits, -1)[:, -1].tolist())
        return self._finalize(
            [(i, t, float(s)) for i, (t, s) in enumerate(zip(texts, scores))], top_k
        )
