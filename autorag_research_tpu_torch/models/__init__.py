from autorag_research_tpu_torch.models.decoder import (
    CausalDecoder,
    DecoderConfig,
    decoder_params_from_jax,
    decoder_params_to_jax,
)
from autorag_research_tpu_torch.models.encoder import (
    EncoderConfig,
    RetrievalEncoder,
    contrastive_train_step,
    from_jax_params,
)

__all__ = [
    "CausalDecoder", "DecoderConfig", "decoder_params_from_jax", "decoder_params_to_jax",
    "EncoderConfig", "RetrievalEncoder", "contrastive_train_step", "from_jax_params",
]
