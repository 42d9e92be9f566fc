"""Shallow-embedding models — the port of ``cogdl_tpu/models/emb``. Only
the base module is ported so far (``graph_to_scipy``, ``EmbeddingModel``);
the models wait in ROADMAP.md §1."""
