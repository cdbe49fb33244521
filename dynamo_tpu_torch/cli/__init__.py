"""Command-line entry points of the port (``python -m dynamo_tpu_torch.cli``)."""
