"""OpenAI-compatible HTTP frontend (ref: lib/llm/src/http) — the port of
dynamo_tpu/http/ on the standard-library server of web.py."""

from dynamo_tpu_torch.http.metrics import FrontendMetrics
from dynamo_tpu_torch.http.model_manager import ModelEntry, ModelManager
from dynamo_tpu_torch.http.service import HttpService

__all__ = ["FrontendMetrics", "HttpService", "ModelEntry", "ModelManager"]
