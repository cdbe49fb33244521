"""Foundation utilities the port shares with the JAX package (copied, not imported)."""
