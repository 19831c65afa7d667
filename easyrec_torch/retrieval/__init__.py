"""Retrieval after a match model: exact and IVF top-k search over item
embeddings (knn.py) and the batch vector-retrieve API and CLI
(vector_retrieve.py)."""
