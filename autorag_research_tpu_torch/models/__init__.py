from autorag_research_tpu_torch.models.encoder import (
    EncoderConfig,
    RetrievalEncoder,
    from_jax_params,
)

__all__ = ["EncoderConfig", "RetrievalEncoder", "from_jax_params"]
