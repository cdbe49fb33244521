"""The port's version: that of the JAX package it ports
(dynamo_tpu/_version.py), which /openapi.json reports."""

__version__ = "0.2.0"
