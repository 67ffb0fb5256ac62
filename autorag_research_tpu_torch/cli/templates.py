"""Default config tree for ``init``.

The reference fetches its default ``configs/`` from GitHub
(``cli/commands/init.py:16-99``); the defaults are embedded here so that
``init`` works offline.

The port's copy of the JAX package's ``cli/templates.py``: the same tree,
but for the model files of the JAX package's own models. The encoder presets
are ``embedding/torch_encoder*.yaml``, the decoder's is ``llm/torch_lm.yaml``
and the cross-encoder's is ``reranker/torch_cross_encoder.yaml`` (each with
the JAX template's defaults). Every pipeline the tree names, retrieval and
generation, resolves to the port's own config.
"""

from __future__ import annotations

from pathlib import Path

DEFAULT_CONFIGS: dict[str, str] = {
    "experiment.yaml": (
        "# Experiment spec: names resolve under pipelines/ and metrics/\n"
        "pipelines:\n"
        "  retrieval:\n    - vector_search\n    - bm25\n    - hybrid_rrf\n"
        "  generation: []\n"
        "metrics:\n"
        "  retrieval:\n    - recall\n    - ndcg\n"
        "  generation: []\n"
        "executor:\n  health_check: true\n  health_check_queries: 2\n"
    ),
    "db.yaml": "# default workspace location\npath: ./workspaces/default\n",
    "pipelines/retrieval/vector_search.yaml": (
        "type: vector_search\nsearch_mode: single\ntop_k: 10\n"
    ),
    "pipelines/retrieval/vector_search_multi.yaml": (
        "type: vector_search\nsearch_mode: multi\ntop_k: 10\n"
    ),
    "pipelines/retrieval/bm25.yaml": "type: bm25\ntokenizer: english\ntop_k: 10\n",
    "pipelines/retrieval/hybrid_rrf.yaml": (
        "type: hybrid_rrf\nretrieval_pipeline_1_name: vector_search\n"
        "retrieval_pipeline_2_name: bm25\nrrf_k: 60\ntop_k: 10\n"
    ),
    "pipelines/retrieval/hybrid_cc.yaml": (
        "type: hybrid_cc\nretrieval_pipeline_1_name: vector_search\n"
        "retrieval_pipeline_2_name: bm25\nweight: 0.5\nnormalize_method: mm\ntop_k: 10\n"
    ),
    "pipelines/retrieval/hyde.yaml": (
        "type: hyde\nllm: mock\nembedding_model: mock\ntop_k: 10\n"
    ),
    "pipelines/retrieval/image_vector_search.yaml": (
        "type: image_vector_search\nsearch_mode: single\ntop_k: 10\n"
    ),
    "pipelines/generation/basic_rag.yaml": (
        "type: basic_rag\nretrieval_pipeline_name: vector_search\nllm: mock\ntop_k: 5\n"
    ),
    "pipelines/generation/ircot.yaml": (
        # bm25 sub-pipeline: IRCoT retrieves with ad-hoc CoT sentences, which
        # needs text-capable retrieval (dense would require an embedding model)
        "type: ircot\nretrieval_pipeline_name: bm25\nllm: mock\nmax_steps: 8\n"
    ),
    # --- remaining retrieval pipelines -----------------------------------
    "pipelines/retrieval/query_rewrite.yaml": (
        "type: query_rewrite\ninner_retrieval_pipeline_name: bm25\nllm: mock\ntop_k: 10\n"
    ),
    "pipelines/retrieval/question_decomposition.yaml": (
        "type: question_decomposition\ninner_retrieval_pipeline_name: bm25\n"
        "llm: mock\nmax_subquestions: 3\ntop_k: 10\n"
    ),
    "pipelines/retrieval/rerank.yaml": (
        "type: rerank\ninner_retrieval_pipeline_name: bm25\nreranker: mock\n"
        "fetch_k_multiplier: 3\ntop_k: 10\n"
    ),
    "pipelines/retrieval/retro_star.yaml": (
        "type: retro_star\nretrieval_pipeline_name: bm25\nllm: mock\n"
        "candidate_top_k: 50\ntop_k: 10\n"
    ),
    "pipelines/retrieval/power_of_noise.yaml": (
        "type: power_of_noise\nbase_retrieval_pipeline_name: bm25\n"
        "noise_count: 2\nnoise_order: retrieved_first\ntop_k: 10\n"
    ),
    "pipelines/retrieval/gqr_hybrid.yaml": (
        "type: gqr_hybrid\nretrieval_pipeline_1_name: vector_search\n"
        "retrieval_pipeline_2_name: bm25\nn_steps: 25\ntop_k: 10\n"
    ),
    "pipelines/retrieval/heaven.yaml": (
        "type: heaven\nstage1_candidate_count: 200\nstage2_refine_ratio: 0.25\n"
        "stage1_weight: 0.3\ntop_k: 10\n"
    ),
    "pipelines/retrieval/vector_search_ivf.yaml": (
        "type: vector_search\nsearch_mode: single\nindex_type: ivf\ntop_k: 10\n"
    ),
    # approximate k-selection + bf16 corpus (ops/dense.dense_topk_approx):
    # for serving, not parity runs
    "pipelines/retrieval/vector_search_fast.yaml": (
        "type: vector_search\nsearch_mode: single\ntop_k: 10\n"
        "index_options:\n  mode: approx\n  dtype: bfloat16\n"
    ),
    # per-row int8 corpus (a quarter of f32's device bytes) + int8 matmul +
    # approximate k-selection (ops/dense.dense_topk_int8): a serving mode,
    # never for parity runs
    "pipelines/retrieval/vector_search_int8.yaml": (
        "type: vector_search\nsearch_mode: single\ntop_k: 10\n"
        "index_options:\n  mode: int8\n"
    ),
    # GUARANTEED-EXACT fast path: bf16 prescreen + per-query coverage proof
    # + f32 rescore; results always equal the exact scan including tie order
    # (ops/dense.dense_topk_verified), so it is parity-safe
    "pipelines/retrieval/vector_search_verified.yaml": (
        "type: vector_search\nsearch_mode: single\ntop_k: 10\n"
        "index_options:\n  mode: verified\n"
    ),
    # same contract for late interaction (ops/maxsim.maxsim_topk_verified)
    "pipelines/retrieval/vector_search_multi_verified.yaml": (
        "type: vector_search\nsearch_mode: multi\ntop_k: 10\n"
        "index_options:\n  mode: verified\n"
    ),
    # APPROXIMATE int8 late-interaction serving: per-token quantized corpus,
    # int8 contraction (ops/maxsim.maxsim_topk_int8) — never for parity runs
    "pipelines/retrieval/vector_search_multi_int8.yaml": (
        "type: vector_search\nsearch_mode: multi\ntop_k: 10\n"
        "index_options:\n  mode: int8\n"
    ),
    # --- remaining generation pipelines ----------------------------------
    "pipelines/generation/search_r1.yaml": (
        "type: search_r1\nretrieval_pipeline_name: bm25\nllm: mock\nmax_actions: 4\ntop_k: 5\n"
    ),
    "pipelines/generation/self_rag.yaml": (
        "type: self_rag\nretrieval_pipeline_name: bm25\nllm: mock\nmax_reflection_steps: 3\ntop_k: 5\n"
    ),
    "pipelines/generation/adaptive_rag.yaml": (
        "type: adaptive_rag\nretrieval_pipeline_name: bm25\nllm: mock\ntop_k: 5\n"
    ),
    "pipelines/generation/deep_rag.yaml": (
        "type: deep_rag\nretrieval_pipeline_name: bm25\nllm: mock\nmax_steps: 5\ntop_k: 5\n"
    ),
    "pipelines/generation/dynamic_rag.yaml": (
        "type: dynamic_rag\nretrieval_pipeline_name: bm25\nllm: mock\ntop_k: 5\n"
    ),
    "pipelines/generation/et2rag.yaml": (
        "type: et2rag\nretrieval_pipeline_name: bm25\nllm: mock\nnum_subsets: 5\ntop_k: 5\n"
    ),
    "pipelines/generation/spd_rag.yaml": (
        "type: spd_rag\nretrieval_pipeline_name: bm25\nllm: mock\ntop_k: 5\n"
    ),
    "pipelines/generation/main_rag.yaml": (
        "type: main_rag\nretrieval_pipeline_name: bm25\nllm: mock\ntau: 0.5\ntop_k: 5\n"
    ),
    "pipelines/generation/rag_critic.yaml": (
        "type: rag_critic\nretrieval_pipeline_name: bm25\nllm: mock\nmax_rounds: 3\ntop_k: 5\n"
    ),
    "pipelines/generation/interact_rag.yaml": (
        "type: interact_rag\nretrieval_pipeline_name: vector_search\n"
        "sparse_retrieval_pipeline_name: bm25\nllm: mock\nmax_turns: 6\ntop_k: 5\n"
    ),
    "pipelines/generation/hybrid_deep_searcher.yaml": (
        "type: hybrid_deep_searcher\nretrieval_pipeline_name: bm25\nllm: mock\n"
        "max_turns: 4\nsearch_budget: 8\ntop_k: 5\n"
    ),
    "pipelines/generation/ras.yaml": (
        "type: ras\nretrieval_pipeline_name: bm25\nllm: mock\nmax_iterations: 3\ntop_k: 5\n"
    ),
    "pipelines/generation/autothinkrag.yaml": (
        "type: autothinkrag\nretrieval_pipeline_name: bm25\nllm: mock\ntop_k: 5\n"
    ),
    "pipelines/generation/question_decomposition_gen.yaml": (
        "type: question_decomposition_gen\nretrieval_pipeline_name: bm25\n"
        "llm: mock\nmax_subquestions: 3\ntop_k: 5\n"
    ),
    "pipelines/generation/visrag_gen.yaml": (
        "type: visrag_gen\nretrieval_pipeline_name: image_vector_search\n"
        "llm: mock\nmax_images: 3\ntop_k: 5\n"
    ),
    "metrics/retrieval/recall.yaml": "name: recall\nmetric_type: retrieval\n",
    "metrics/retrieval/mrr.yaml": "name: mrr\nmetric_type: retrieval\n",
    "metrics/retrieval/map.yaml": "name: map\nmetric_type: retrieval\n",
    "metrics/retrieval/f1.yaml": "name: f1\nmetric_type: retrieval\n",
    "metrics/generation/bleu.yaml": "name: bleu\nmetric_type: generation\n",
    "metrics/generation/meteor.yaml": "name: meteor\nmetric_type: generation\n",
    "metrics/generation/token_f1.yaml": "name: token_f1\nmetric_type: generation\n",
    "metrics/generation/sem_score.yaml": (
        "name: sem_score\nmetric_type: generation\nkwargs:\n  embedding_model: mock\n"
    ),
    "metrics/retrieval/ndcg.yaml": "name: ndcg\nmetric_type: retrieval\n",
    "metrics/generation/exact_match.yaml": "name: exact_match\nmetric_type: generation\n",
    "metrics/generation/rouge.yaml": (
        "name: rouge\nmetric_type: generation\nkwargs:\n  rouge_type: rougeL\n"
    ),
    "llm/mock.yaml": "type: mock\n",
    "llm/torch_lm.yaml": (
        "type: torch_lm\n# local causal decoder on the GPU (models/decoder.py);\n"
        "# point checkpoint at a trained .npz (JaxLM.save's format) for non-random output\n"
        "max_prompt_len: 384\nmax_new_tokens: 96\ntemperature: 0.0\n"
        "# checkpoint: /path/to/lm.npz\n"
    ),
    "llm/openai.yaml": (
        "type: openai_compat\nmodel: gpt-4o-mini\nbase_url: https://api.openai.com/v1\n"
    ),
    "llm/vllm.yaml": (
        "type: openai_compat\nmodel: my-model\nbase_url: http://localhost:8000/v1\n"
        "api_key_env: VLLM_API_KEY\n"
    ),
    "llm/anthropic.yaml": (
        "type: anthropic\nmodel: claude-sonnet-4-5\n"
        "# api key read from ANTHROPIC_API_KEY\nmax_tokens: 1024\n"
    ),
    "llm/gemini.yaml": (
        "type: gemini\nmodel: gemini-2.0-flash\n"
        "# api key read from GOOGLE_API_KEY\nmax_tokens: 1024\n"
    ),
    "llm/bedrock.yaml": (
        "type: bedrock\nmodel_id: anthropic.claude-sonnet-4-5-20250929-v1:0\n"
        "region_name: us-east-1\n"
        "# credentials read from AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY\n"
        "max_tokens: 1024\n"
    ),
    "llm/ollama.yaml": (
        "type: ollama\nmodel: llama3.1\nbase_url: http://localhost:11434/v1\n"
    ),
    "llm/together.yaml": (
        "type: together\nmodel: meta-llama/Llama-3.3-70B-Instruct-Turbo\n"
        "# api key read from TOGETHER_API_KEY\n"
    ),
    "llm/xai_grok.yaml": (
        "type: xai\nmodel: grok-4-1-fast-non-reasoning\n"
        "# api key read from XAI_API_KEY\n"
    ),
    "llm/huggingface.yaml": (
        "type: huggingface\nmodel: my-model\n"
        "# any TGI / OpenAI-compatible local HF endpoint\n"
        "base_url: http://localhost:8080/v1\n"
    ),
    "llm/azure_openai.yaml": (
        "type: azure_openai\ndeployment: my-deployment\n"
        "base_url: https://my-resource.openai.azure.com\n"
        "api_version: '2024-06-01'\n# api key read from AZURE_OPENAI_API_KEY\n"
    ),
    "llm/anthropic_haiku.yaml": (
        "type: anthropic\nmodel: claude-haiku-4-5\nmax_tokens: 1024\n"
    ),
    "llm/anthropic_opus.yaml": (
        "type: anthropic\nmodel: claude-opus-4-6\nmax_tokens: 1024\n"
    ),
    "llm/gemini_pro.yaml": (
        "type: gemini\nmodel: gemini-2.5-pro\nmax_tokens: 1024\n"
    ),
    "embedding/mock.yaml": "type: mock\ndim: 64\n",
    "embedding/openai_small.yaml": (
        "type: openai\nmodel: text-embedding-3-small\n"
        "# api key read from OPENAI_API_KEY\n"
    ),
    "embedding/openai_large.yaml": (
        "type: openai\nmodel: text-embedding-3-large\n"
    ),
    "embedding/openai_like.yaml": (
        "type: openai_compat\nmodel: my-model\nbase_url: http://localhost:8000/v1\n"
    ),
    "embedding/together.yaml": "type: together\n",
    "embedding/jina.yaml": "type: jina\n",
    "embedding/ollama.yaml": "type: ollama\n",
    "embedding/vllm.yaml": (
        "type: vllm\nmodel: my-model\nbase_url: http://localhost:8000/v1\n"
    ),
    "embedding/colpali.yaml": (
        "type: colpali\ncheckpoint: vidore/colpali-v1.3\ndevice: cpu\n"
    ),
    "embedding/colqwen2.yaml": "type: colqwen\ndevice: cpu\n",
    "embedding/bipali.yaml": "type: bipali\ndevice: cpu\n",
    "embedding/infinity.yaml": (
        "type: infinity\nbase_url: http://localhost:7997\nmodel: my-model\n"
    ),
    "embedding/infinity_colqwen2.yaml": (
        "type: infinity_multi\nbase_url: http://localhost:7997\n"
        "model: vidore/colqwen2-v1.0\n"
    ),
    "embedding/torch_encoder.yaml": (
        "type: torch_encoder\nhidden: 256\nlayers: 4\nheads: 4\nout_dim: 128\n"
    ),
    "embedding/torch_encoder_multi.yaml": (
        "type: torch_encoder\nmulti_vector: true\nhidden: 256\nlayers: 4\nheads: 4\nout_dim: 128\n"
    ),
    "reranker/mock.yaml": "type: mock\n",
    "reranker/llm_listwise.yaml": "type: llm_listwise\nllm: mock\n",
    "reranker/torch_cross_encoder.yaml": (
        "type: torch_cross_encoder\n# params_path: /path/to/trained.npz\n"
    ),
    # the reference's full reranker preset roster (configs/reranker/*.yaml);
    # every type name resolves through injection._builtin_factories
    "reranker/cross_encoder.yaml": (
        "type: cross_encoder\ncheckpoint: cross-encoder/ms-marco-MiniLM-L-6-v2\n"
    ),
    "reranker/colbert.yaml": "type: colbert\n",
    "reranker/monot5.yaml": "type: monot5\n",
    "reranker/upr.yaml": "type: upr\n",
    "reranker/flag_embedding.yaml": "type: flag_embedding\n",
    "reranker/flag_embedding_llm.yaml": "type: flag_embedding_llm\n",
    "reranker/koreranker.yaml": "type: koreranker\n",
    "reranker/sentence_transformer.yaml": "type: sentence_transformer\n",
    "reranker/tart.yaml": "type: tart\n",
    "reranker/flashrank.yaml": "type: flashrank\n",
    "reranker/openvino.yaml": "type: openvino\n",
    "reranker/cohere.yaml": "type: cohere\nmodel: rerank-v3.5\n",
    "reranker/jina.yaml": "type: jina\nmodel: jina-reranker-v2-base-multilingual\n",
    "reranker/voyageai.yaml": "type: voyageai\nmodel: rerank-2\n",
    "reranker/mixedbreadai.yaml": (
        "type: mixedbreadai\nmodel: mixedbread-ai/mxbai-rerank-large-v1\n"
    ),
}


def write_default_configs(target: Path, overwrite: bool = False) -> list[Path]:
    written = []
    for rel, content in DEFAULT_CONFIGS.items():
        path = target / rel
        if path.exists() and not overwrite:
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(content)
        written.append(path)
    return written
