"""Multimodal request handling the port shares with the JAX package (copied,
not imported). Only the content-part split the preprocessor needs is ported;
the vision encoders and their handlers are not (ROADMAP A9)."""
