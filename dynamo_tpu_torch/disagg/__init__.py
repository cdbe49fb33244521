"""Disaggregated serving — the port holds the failure taxonomy
(errors.py) and the frontend's PrefillRouter operator (prefill_router.py);
the KV transfer, its handlers and the wire come with ROADMAP A6."""

from dynamo_tpu_torch.disagg.errors import DisaggTransferError, classify_failure
from dynamo_tpu_torch.disagg.prefill_router import PrefillRouter

__all__ = ["DisaggTransferError", "PrefillRouter", "classify_failure"]
