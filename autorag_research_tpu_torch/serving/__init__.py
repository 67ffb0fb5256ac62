from autorag_research_tpu_torch.serving.server import ServingHandle, serve_workspace

__all__ = ["ServingHandle", "serve_workspace"]
