"""Shallow-embedding models — the port of ``cogdl_tpu/models/emb``: the base
module (``graph_to_scipy``, ``EmbeddingModel``) and the KG triple
embeddings (``knowledge_base``: TransE, DistMult, RotatE, ComplEx); the
node-embedding models wait in ROADMAP.md §1."""
