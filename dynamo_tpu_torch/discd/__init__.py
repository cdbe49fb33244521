"""Control-plane services (discd discovery + the event broker); run with
``python -m dynamo_tpu_torch.discd``."""
