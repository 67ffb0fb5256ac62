"""BM25 tokenizers (host side).

Counterpart of ``autorag_research_tpu/index/tokenize.py``, with the same
word regex, so that a vocabulary built by one package tokenizes queries the
same way in the other:

- ``simple``: lowercase unicode word/number regex, the default;
  ``wiki_tocken`` is an alias for it.
- ``english``: ``simple`` + Lucene's stopwords + Porter stemming (``nltk``,
  imported when the tokenizer is made).
- ``bert`` / ``gemma2b`` / ``llmlingua2`` or a local checkpoint path: a
  HuggingFace tokenizer resolved from local files only.

A tokenizer whose package or checkpoint is missing raises
``TokenizerError``.
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod
from typing import Sequence

from autorag_research_tpu_torch.exceptions import TokenizerError

_WORD_RE = re.compile(r"[^\W_]+", re.UNICODE)

# Lucene's English stopword list (public domain word list).
ENGLISH_STOPWORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split()
)


class BaseTokenizer(ABC):
    name: str = "base"

    @abstractmethod
    def tokenize(self, text: str) -> list[str]:
        ...

    def tokenize_batch(self, texts: Sequence[str]) -> list[list[str]]:
        return [self.tokenize(t) for t in texts]


class SimpleTokenizer(BaseTokenizer):
    name = "simple"

    def tokenize(self, text: str) -> list[str]:
        return _WORD_RE.findall(text.lower())


class EnglishTokenizer(BaseTokenizer):
    """simple + stopwords + Porter stemming."""

    name = "english"

    def __init__(self):
        try:
            from nltk.stem.porter import PorterStemmer
        except ImportError as exc:
            raise TokenizerError(
                "the 'english' tokenizer needs nltk; use 'simple' where it is not installed"
            ) from exc
        self._stemmer = PorterStemmer()

    def tokenize(self, text: str) -> list[str]:
        return [
            self._stemmer.stem(tok)
            for tok in _WORD_RE.findall(text.lower())
            if tok not in ENGLISH_STOPWORDS
        ]


class HFTokenizer(BaseTokenizer):
    """HuggingFace tokenizer adapter (wordpiece/sentencepiece token strings)."""

    def __init__(self, checkpoint: str, name: str | None = None):
        try:
            from transformers import AutoTokenizer

            self._tok = AutoTokenizer.from_pretrained(checkpoint, local_files_only=True)
        except Exception as exc:  # noqa: BLE001
            raise TokenizerError(
                f"cannot load local HF tokenizer '{checkpoint}'; use 'simple' or "
                "'english', or point to a local checkpoint directory"
            ) from exc
        self.name = name or checkpoint

    def tokenize(self, text: str) -> list[str]:
        return self._tok.tokenize(text)


_HF_PRESETS = {
    "bert": "bert-base-uncased",
    "gemma2b": "google/gemma-2b",
    "llmlingua2": "microsoft/llmlingua-2-xlm-roberta-large-meetingbank",
}

_CACHE: dict[str, BaseTokenizer] = {}


def get_tokenizer(name: str = "simple") -> BaseTokenizer:
    if name in _CACHE:
        return _CACHE[name]
    if name == "simple" or name == "wiki_tocken":
        tok: BaseTokenizer = SimpleTokenizer()
    elif name == "english":
        tok = EnglishTokenizer()
    elif name in _HF_PRESETS:
        tok = HFTokenizer(_HF_PRESETS[name], name)
    elif "/" in name or name.startswith("."):
        tok = HFTokenizer(name)
    else:
        raise TokenizerError(
            f"unknown tokenizer '{name}'; known: simple, english, wiki_tocken, "
            f"{', '.join(_HF_PRESETS)} or a local HF checkpoint path"
        )
    _CACHE[name] = tok
    return tok
