"""Deterministic synthetic benchmark: the offline stand-in for BEIR.

The reference's headline recipe (BEIR dataset -> pipelines -> leaderboard,
``README.md:157-200``) is egress-blocked in this image, so this ingestor
generates a CALIBRATED offline benchmark with the statistics that matter:

- zipfian token frequencies (long-tail vocabulary like real text — exercises
  BM25 idf, bucketized layouts, and the probe kernel's rare-term path);
- topical cluster structure: each document belongs to a topic carrying 2-4
  rare signature terms, so lexical (BM25) and bag-of-token dense retrieval
  both work but disagree — hybrid fusion has something to fuse;
- graded AND/OR retrieval GT: gold docs (all signature terms) form one OR
  group; some queries add a second AND group of related docs, exercising the
  full GT DSL (reference ``schema.py`` AND-of-OR contract);
- generation GT derived from the topic, so generation pipelines and LM
  training run on the same fixture.

Everything is a pure function of (seed, n_docs, n_queries): two ingests on
any host produce byte-identical catalogs, which is what makes cross-device
leaderboard-equality assertions meaningful (scripts/parity_run.py
--expect-leaderboard).

The port's copy of the JAX package's ``data/synthetic.py``: the same seed
gives the same catalog, row for row, in either package.
"""

from __future__ import annotations

import zlib
from typing import Literal

import numpy as np

from autorag_research_tpu_torch.data.base import TextDataIngestor
from autorag_research_tpu_torch.data.registry import register_ingestor
from autorag_research_tpu_torch.embeddings.base import BaseEmbedding, _hash_vec
from autorag_research_tpu_torch.store.gt import or_all


class BagOfTokensEmbedding(BaseEmbedding):
    """Deterministic lexical-overlap embedding: mean of hash vectors over
    whitespace tokens, L2-normalized. Unlike the whole-text MockEmbedding
    hash, shared terms produce real cosine similarity, so dense retrieval has
    actual (imperfect) recall on the synthetic fixture — the regime fusion
    metrics need."""

    def __init__(self, dim: int = 256):
        self.dim = dim

    def embed_texts(self, texts):
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            toks = t.lower().split()
            if toks:
                v = np.mean([_hash_vec(tok, self.dim) for tok in toks], axis=0)
                n = np.linalg.norm(v)
                out[i] = v / n if n > 0 else v
        return out

    def embed_images(self, images):
        return np.stack([_hash_vec(b.hex(), self.dim, "img:") for b in images])


class BagOfTokensMultiVectorEmbedding:
    """Token-identity late-interaction embedding: one L2-normalized hash
    vector per whitespace token (capped). Unlike MockMultiVectorEmbedding —
    whose position-salted hashes make identical tokens in different docs
    orthogonal — the SAME token always maps to the SAME vector, so MaxSim
    scores express real lexical overlap and the fixture's maxsim pipeline
    has meaningful (imperfect) recall instead of hash noise."""

    def __init__(self, dim: int = 64, max_tokens: int = 16):
        self.dim = dim
        self.max_tokens = max_tokens

    def _tok_vec(self, tok: str) -> np.ndarray:
        v = _hash_vec(tok, self.dim)
        n = np.linalg.norm(v)
        return v / n if n > 0 else v

    def embed_texts_multi(self, texts):
        out = []
        for t in texts:
            tokens = t.lower().split()[: self.max_tokens] or [t]
            out.append(np.stack([self._tok_vec(tok) for tok in tokens]).astype(np.float32))
        return out

    def embed_images_multi(self, images):
        out = []
        for b in images:
            out.append(
                np.stack(
                    [self._tok_vec(f"img{i}:{b.hex()[:16]}") for i in range(self.max_tokens)]
                ).astype(np.float32)
            )
        return out


def _zipf_vocab(rng: np.random.Generator, n_types: int) -> tuple[list[str], np.ndarray]:
    words = [f"w{i}" for i in range(n_types)]
    weights = 1.0 / np.arange(1, n_types + 1) ** 1.1
    return words, weights / weights.sum()


@register_ingestor(
    name="synthetic",
    description="Deterministic zipfian corpus with topical AND/OR graded GT (offline BEIR stand-in)",
    aliases=("zipf",),
)
class SyntheticIngestor(TextDataIngestor):
    def __init__(
        self,
        embedding_model=None,
        n_docs: int = 5000,
        n_queries: int = 250,
        n_topics: int | None = None,
        vocab: int = 2000,
        seed: int = 42,
        doc_len: tuple[int, int] = (20, 120),
    ):
        super().__init__(embedding_model)
        self.n_docs = int(n_docs)
        self.n_queries = int(n_queries)
        self.n_topics = int(n_topics) if n_topics else max(8, self.n_queries // 2)
        self.vocab = int(vocab)
        self.seed = int(seed)
        self.doc_len = doc_len

    def detect_primary_key_type(self) -> Literal["bigint", "string"]:
        return "bigint"

    def ingest(
        self,
        subset: str = "test",
        query_limit: int | None = None,
        min_corpus_cnt: int | None = None,
    ) -> None:
        service = self._require_service()
        # honor the ingestor contract instead of silently ignoring it:
        # min_corpus_cnt grows the corpus (never shrinks — n_docs is the
        # user's explicit floor), and non-"test" subsets derive a distinct
        # deterministic seed ("test" keeps the plain seed so recorded
        # leaderboards stay reproducible)
        if min_corpus_cnt is not None and int(min_corpus_cnt) > self.n_docs:
            self.n_docs = int(min_corpus_cnt)
        seed = self.seed
        if subset != "test":
            seed = self.seed + 1 + (zlib.crc32(subset.encode()) % 9973)
        rng = np.random.default_rng(seed)
        words, probs = _zipf_vocab(rng, self.vocab)
        # choice() over an array draws what it draws over the list, without
        # converting the vocabulary on every call (5x faster at 100k docs)
        word_arr = np.asarray(words)

        # topic signatures draw from the RARE tail (exercises selective BM25)
        tail = np.arange(self.vocab // 2, self.vocab)
        signatures = []
        for t in range(self.n_topics):
            k = int(rng.integers(2, 5))
            sig = rng.choice(tail, size=k, replace=False)
            signatures.append([f"topic{t}sig{j}_{words[s]}" for j, s in enumerate(sig)])

        # docs: zipfian filler + (for topical docs) full or partial signature
        chunks = []
        topic_gold: dict[int, list[int]] = {t: [] for t in range(self.n_topics)}
        topic_related: dict[int, list[int]] = {t: [] for t in range(self.n_topics)}
        lo, hi = self.doc_len
        for d in range(self.n_docs):
            n_tok = int(rng.integers(lo, hi + 1))
            toks = list(rng.choice(word_arr, size=n_tok, p=probs))
            topic = int(rng.integers(0, self.n_topics * 2))  # half the docs off-topic
            if topic < self.n_topics:
                sig = signatures[topic]
                if rng.random() < 0.5:  # gold: carries the FULL signature
                    ins = sig
                    topic_gold[topic].append(d)
                else:  # related: a partial signature
                    n_part = max(1, len(sig) - 1 - int(rng.integers(0, 2)))
                    ins = list(rng.choice(sig, size=n_part, replace=False))
                    topic_related[topic].append(d)
                for term in ins:
                    toks.insert(int(rng.integers(0, len(toks) + 1)), term)
            chunks.append({"id": d, "contents": " ".join(toks)})
        service.add_chunks(chunks)

        # queries: signature terms + light noise; graded AND/OR GT
        n_q = self.n_queries if query_limit is None else min(self.n_queries, query_limit)
        queries, gt_rows = [], []
        for q in range(n_q):
            topic = q % self.n_topics
            sig = signatures[topic]
            noise = list(rng.choice(word_arr[:200], size=int(rng.integers(1, 4))))
            q_terms = list(sig) + noise
            rng.shuffle(q_terms)
            answer = " ".join(sig[:2])
            queries.append(
                {
                    "id": q,
                    "contents": " ".join(q_terms),
                    "generation_gt": [answer],
                }
            )
            gold = topic_gold[topic]
            related = topic_related[topic]
            if not gold and not related:
                continue
            if gold and related and q % 3 == 0:
                # AND of two OR groups: a gold hit AND a related hit required
                expr = or_all(gold) & or_all(related[:8])
            elif gold:
                expr = or_all(gold)
            else:
                expr = or_all(related[:8])
            gt_rows.append((q, expr))
        service.add_queries(queries)
        for qid, expr in gt_rows:
            service.add_retrieval_gt(qid, expr)
        service.clean()
