"""Shallow-embedding models — the port of ``cogdl_tpu/models/emb``: the base
module (``graph_to_scipy``, ``EmbeddingModel``, ``top_svd``), the KG triple
embeddings (``knowledge_base``: TransE, DistMult, RotatE, ComplEx) and the
homogeneous network embeddings (DeepWalk, node2vec, LINE, NetMF, NetSMF,
ProNE, ProNE++, HOPE, GraRep, Spectral, SDNE, DNGR, with ``walks``); the
heterogeneous and graph-level ones wait in ROADMAP.md §1."""
