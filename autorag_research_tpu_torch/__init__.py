"""AutoRAG-Research on PyTorch + CUDA: the port of ``autorag_research_tpu``.

The same framework (catalog, indexes, retrieval pipelines, metrics) written
in PyTorch for one NVIDIA Hopper GPU, module for module beside the JAX
package, which stays the reference the port is tested against. Every Pallas
kernel of the JAX package becomes a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use. The package imports neither
``jax`` nor ``autorag_research_tpu``. Entry points take an explicit
``device``, ``"cuda"`` by default.
"""

__version__ = "0.1.0"
