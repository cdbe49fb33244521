"""PrefillRouter: frontend-side disaggregation operator — the port's copy
of dynamo_tpu/disagg/prefill_router.py. Prefill workers are
``python -m dynamo_tpu_torch.worker --is-prefill-worker`` processes
(disagg/handlers.PrefillHandler); with no prefill instance every request
passes through to the decode path.

Reference parity: lib/llm/src/kv_router/prefill_router.rs:102 —
activate (:182) watches discovery for prefill instances; execute_prefill
(:354) sends the request with max_tokens=1 to a prefill worker; the
bootstrap metadata (:267–318) travels to the decode worker as
``disaggregated_params``. Requests below the length threshold (or when no
prefill workers are live) fall through to the decode path's local prefill
(conditional disagg, docs/performance/tuning.md disagg-router section).

Stream shape: the prefill worker's first token is emitted immediately (good
TTFT), then the decode stream continues from token 2.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.llm.protocols.common import (
    BackendOutput,
    DisaggregatedParams,
    FinishReason,
    PreprocessedRequest,
)
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class PrefillRouter:
    def __init__(
        self,
        prefill_client_factory,
        *,
        threshold_tokens: int = 32,
    ) -> None:
        # async () -> Client for the prefill component's generate endpoint
        self._factory = prefill_client_factory
        self._client = None
        self.threshold_tokens = threshold_tokens

    async def _prefill_client(self):
        if self._client is None:
            self._client = await self._factory()
        return self._client

    async def generate(
        self, request: Any, context: Context, next: AsyncEngine
    ) -> AsyncIterator[Any]:
        req = (
            request
            if isinstance(request, PreprocessedRequest)
            else PreprocessedRequest.from_dict(dict(request))
        )
        client = None
        try:
            client = await self._prefill_client()
        except Exception:
            logger.debug("prefill client unavailable; serving aggregated")
        if (
            client is None
            or not client.instance_ids
            or len(req.token_ids) < self.threshold_tokens
        ):
            async for item in next.generate(request, context):
                yield item
            return

        first: Optional[BackendOutput] = None
        try:
            async for item in client.generate(req.to_dict(), context):
                out = (
                    item
                    if isinstance(item, BackendOutput)
                    else BackendOutput.from_dict(item)
                )
                if out.error:
                    raise RuntimeError(out.error)
                if out.token_ids:
                    first = out
                    break
        except Exception as exc:
            logger.warning("remote prefill failed (%r); serving aggregated", exc)
            async for item in next.generate(request, context):
                yield item
            return
        if first is None or first.disaggregated_params is None:
            logger.warning("prefill returned no bootstrap; serving aggregated")
            async for item in next.generate(request, context):
                yield item
            return

        token = first.token_ids[0]
        dp: DisaggregatedParams = first.disaggregated_params
        yield BackendOutput(
            token_ids=[token], cumulative_tokens=1, logprobs=first.logprobs
        )
        # Evaluate stop conditions for the first token with the same gating
        # as the engine's _emit_token (min_tokens gates eos/stop ids).
        max_tokens = req.stop.max_tokens
        min_ok = req.stop.min_tokens is None or 1 >= req.stop.min_tokens
        if not req.stop.ignore_eos and min_ok and token in (req.eos_token_ids or []):
            yield BackendOutput(finish_reason=FinishReason.EOS)
            return
        if min_ok and token in (req.stop.stop_token_ids or []):
            yield BackendOutput(finish_reason=FinishReason.STOP)
            return
        if max_tokens is not None and max_tokens <= 1:
            yield BackendOutput(finish_reason=FinishReason.LENGTH)
            return

        decode_req = PreprocessedRequest.from_dict(req.to_dict())
        decode_req.token_ids = list(req.token_ids) + [token]
        if decode_req.stop.max_tokens is not None:
            decode_req.stop.max_tokens -= 1
        if decode_req.stop.min_tokens:
            decode_req.stop.min_tokens = max(decode_req.stop.min_tokens - 1, 0)
        decode_req.disaggregated_params = dp
        async for item in next.generate(decode_req, context):
            out = (
                item
                if isinstance(item, BackendOutput)
                else BackendOutput.from_dict(item)
            )
            if out.cumulative_tokens is not None:
                out.cumulative_tokens += 1  # account the prefill token
            yield out
