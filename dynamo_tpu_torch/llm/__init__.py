"""LLM-layer types the port shares with the JAX package (copied, not imported)."""
