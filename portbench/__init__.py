"""The benchmark of ``autorag_research_tpu_torch``: see ``portbench/README.md``."""
