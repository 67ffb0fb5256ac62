from autorag_research_tpu_torch.utils.concurrency import run_with_concurrency_limit

__all__ = ["run_with_concurrency_limit"]
