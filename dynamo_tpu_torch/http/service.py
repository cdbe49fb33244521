"""OpenAI-compatible HTTP frontend — the port of dynamo_tpu/http/service.py,
route by route, on the standard-library server of http/web.py (the card's
machine has no aiohttp): the same bodies, status codes, headers and SSE
frames.

Reference parity: lib/llm/src/http/service/{service_v2.rs,openai.rs} — the
axum server with /v1/chat/completions (:865), /v1/completions (:327),
/v1/models (:1530), /v1/embeddings (:641), SSE streaming with disconnect
handling (disconnect.rs), and the system routes /health /live /metrics
(runtime/src/system_status_server.rs).

With an ``overload=`` controller (runtime/overload.py) every generation
route admits through it: bounded EDF admission, typed 429/503/504 sheds
with ``Retry-After``, the brownout ``max_tokens`` clamp; ``/debug/overload``
serves its snapshot and ``/metrics`` its families. Each chat or completion
request opens its root ``http.{endpoint}`` span before admission, with the
queue wait as an ``overload.queue`` child, and ``/debug/trajectory[/{id}]``
serve the trajectory plane's stitched views (runtime/trajectory.py), whose
SLO families ``/metrics`` carries too. ``tls_cert=`` / ``tls_key=`` serve
HTTPS. Embedding and image models come later: their routes answer 404 for
every model.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Any, AsyncIterator, Dict, Optional

from dynamo_tpu_torch._version import __version__
from dynamo_tpu_torch.http import web
from dynamo_tpu_torch.http.audit import AuditBus, AuditRecord
from dynamo_tpu_torch.http.metrics import FrontendMetrics, RequestTimer
from dynamo_tpu_torch.http.model_manager import ModelManager
from dynamo_tpu_torch.http.worker_monitor import BusyThresholds
from dynamo_tpu_torch.llm.protocols.common import FinishReason, PostprocessedOutput
from dynamo_tpu_torch.llm.protocols.openai import (
    OpenAIError,
    chat_chunk,
    chat_logprobs_block,
    completion_chunk,
    completion_envelope,
    completion_logprobs_block,
    gen_id,
    model_list,
    parse_n,
    usage_block,
)
from dynamo_tpu_torch.parsers import (
    ArgsDelta,
    CallEnd,
    CallStart,
    ContentDelta,
    ReasoningParser,
    ToolCallJail,
    ToolCallParseError,
    detect_and_parse_tool_calls,
    split_reasoning,
)
from dynamo_tpu_torch.parsers.observe import parser_plane
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.overload import (
    AdmissionTicket,
    OverloadController,
    OverloadShedError,
)
from dynamo_tpu_torch.runtime.tasks import TaskTracker
from dynamo_tpu_torch.runtime.trajectory import (
    render_trajectory_metrics,
    trajectory_index,
    trajectory_view,
)
from dynamo_tpu_torch.utils.tracing import span

logger = logging.getLogger(__name__)


def _error_kind_of(exc: BaseException) -> Optional[str]:
    """Structured ``error_kind`` for an exception the pipeline raised —
    only for failure classes with a meaningful taxonomy label (tool-call
    parser, transport, deadline); generic programming errors stay
    unlabeled rather than masquerading as ``decode``."""
    from dynamo_tpu_torch.disagg.errors import classify_failure

    if isinstance(exc, ToolCallParseError):
        # Tool-call parser BUG (parsers/jail.py wraps anything escaping
        # the dialect machines): terminal typed frame, never a dropped
        # stream — and never disguised as an upstream failure.
        return "tool_call_parse"
    if isinstance(exc, (ConnectionError, TimeoutError, asyncio.TimeoutError)):
        return classify_failure(exc)
    return None


def _status_of_kind(kind: Optional[str]) -> int:
    """HTTP status for a terminal engine error carrying ``error_kind``:
    an expired budget is the client's 504, an upstream worker/link
    failure a 502 — neither is the frontend's own 500."""
    if kind == "timeout":
        return 504
    if kind in ("connection", "disagg", "no_instances"):
        return 502
    return 500


def _err_type_of_kind(kind: Optional[str]) -> str:
    if kind == "timeout":
        return "deadline_exceeded"
    if kind in ("connection", "disagg", "no_instances"):
        return "upstream_error"
    return "internal_error"


class HttpService:
    """The frontend server. Construct, then ``await start()``."""

    def __init__(
        self,
        model_manager: Optional[ModelManager] = None,
        *,
        host: str = "0.0.0.0",
        port: int = 8000,
        tls_cert: Optional[str] = None,
        tls_key: Optional[str] = None,
        overload: Optional[OverloadController] = None,
    ) -> None:
        # TLS termination (ref: service_v2.rs enable_tls + rustls config).
        self._ssl_context = None
        if tls_cert and tls_key:
            import ssl

            self._ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self._ssl_context.load_cert_chain(tls_cert, tls_key)
        # NOT `or`: an empty ModelManager is falsy (__len__ == 0) and would be
        # silently replaced, detaching the caller's manager from the server.
        self.models = model_manager if model_manager is not None else ModelManager()
        self.host = host
        self.port = port
        self.metrics = FrontendMetrics()
        # Overload armor (runtime/overload.py): bounded EDF admission +
        # brownout. None = unguarded; the frontend main constructs one by
        # default.
        self.overload = overload
        self.tracker = TaskTracker("http")
        # model name → busy thresholds (ref: busy_threshold.rs)
        self.busy_thresholds: Dict[str, BusyThresholds] = {}
        # Request auditing (ref: lib/llm/src/audit): DYN_TPU_AUDIT policy.
        self.audit = AuditBus.from_env()
        self._server: Optional[web.Server] = None
        self.app = self._build_app()

    def _build_app(self) -> web.Application:
        app = web.Application()
        app.router.add_post("/v1/chat/completions", self._chat_completions)
        app.router.add_post("/v1/completions", self._completions)
        app.router.add_post("/v1/embeddings", self._embeddings)
        app.router.add_get("/v1/models", self._models_route)
        app.router.add_get("/health", self._health)
        app.router.add_get("/live", self._live)
        app.router.add_get("/metrics", self._metrics_route)
        app.router.add_get("/busy_threshold", self._busy_threshold_list)
        app.router.add_post("/busy_threshold", self._busy_threshold_route)
        app.router.add_post("/v1/responses", self._responses)
        app.router.add_post("/v1/images/generations", self._images)
        app.router.add_post("/clear_kv_blocks", self._clear_kv_blocks)
        app.router.add_get("/debug/overload", self._debug_overload)
        app.router.add_get("/debug/parser", self._debug_parser)
        app.router.add_get("/debug/trajectory", self._debug_trajectories)
        app.router.add_get(
            "/debug/trajectory/{trace_id}", self._debug_trajectory
        )
        app.router.add_get("/openapi.json", self._openapi)
        return app

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> int:
        """Bind and serve; returns the bound port (useful with port=0)."""
        self._server = web.Server(self.app)
        self.port = await self._server.start(self.host, self.port, ssl=self._ssl_context)
        logger.info("HTTP frontend listening on %s:%d", self.host, self.port)
        return self.port

    async def stop(self, grace_period: float = 30.0) -> None:
        await self.tracker.drain(grace_period)
        if self._server is not None:
            await self._server.stop()
            self._server = None

    # -- system routes -----------------------------------------------------

    async def _health(self, request: web.Request) -> web.Response:
        return web.json_response(
            {"status": "healthy" if len(self.models) else "no_models", "models": self.models.names()}
        )

    async def _live(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "live"})

    async def _metrics_route(self, request: web.Request) -> web.Response:
        openmetrics = "application/openmetrics-text" in request.headers.get(
            "Accept", ""
        )
        if openmetrics:
            # OpenMetrics exposition carries trace-id exemplars on the TTFT
            # and request-duration histograms (see http/metrics.py). The
            # overload, parser and SLO families go in BEFORE the # EOF
            # terminator.
            body = self.metrics.render(openmetrics=True)
            extra = (
                parser_plane().metrics.render(openmetrics=True)
                + "\n" + render_trajectory_metrics(openmetrics=True)
            )
            if self.overload is not None:
                extra = (
                    self.overload.metrics.render(openmetrics=True)
                    + "\n" + extra
                )
            stripped = body.rstrip()
            if stripped.endswith(b"# EOF"):
                stripped = stripped[: -len(b"# EOF")].rstrip()
            body = stripped + b"\n" + extra.encode() + b"\n# EOF\n"
            return web.Response(
                body=body, content_type="application/openmetrics-text",
            )
        body = self.metrics.render()
        if self.overload is not None:
            # The frontend's controller is the one that actually admits
            # and sheds — its families must be on THIS scrape surface.
            body = body + self.overload.metrics.render().encode() + b"\n"
        # Parser plane: the jail runs inside THIS process's SSE handlers —
        # tool-call streaming health scrapes here.
        body = body + parser_plane().metrics.render().encode() + b"\n"
        # SLO plane: goodput/burn-rate/phase gauges are fed by THIS
        # process's finished streams — they belong on this scrape.
        body = body + render_trajectory_metrics().encode() + b"\n"
        return web.Response(body=body, content_type="text/plain")

    async def _models_route(self, request: web.Request) -> web.Response:
        return web.json_response(model_list(self.models.openai_model_list()))

    async def _debug_trajectories(self, request: web.Request) -> web.Response:
        """Fleet trajectory index (recent + slow/error, SLO snapshot)."""
        return web.json_response(trajectory_index())

    async def _debug_trajectory(self, request: web.Request) -> web.Response:
        tid = request.match_info["trace_id"]
        stitched = trajectory_view(tid)
        if stitched is None:
            return web.json_response(
                {"error": f"no trajectory for trace {tid!r}"}, status=404
            )
        return web.json_response(stitched)

    async def _debug_overload(self, request: web.Request) -> web.Response:
        """Overload-plane snapshot + the 'overload' flight ring (the
        frontend has no system server; this is its /debug/flight slice)."""
        if self.overload is None:
            return web.json_response({"enabled": False})
        try:
            limit = int(request.query.get("limit", 256))
        except ValueError:
            limit = 256
        return web.json_response(
            {
                "enabled": True,
                **self.overload.snapshot(),
                "events": self.overload.flight.snapshot(limit=limit),
            }
        )

    async def _debug_parser(self, request: web.Request) -> web.Response:
        """Parser-plane snapshot + the 'parser' flight ring."""
        try:
            limit = int(request.query.get("limit", 256))
        except ValueError:
            limit = 256
        plane = parser_plane()
        return web.json_response(
            {
                **plane.snapshot(),
                "events": plane.flight.snapshot(limit=limit),
            }
        )

    async def _busy_threshold_list(self, request: web.Request) -> web.Response:
        """(ref: busy_threshold.rs GET — list configured thresholds)"""
        return web.json_response(
            {
                "thresholds": [
                    {"model": m, **t.to_dict()}
                    for m, t in sorted(self.busy_thresholds.items())
                ]
            }
        )

    async def _busy_threshold_route(self, request: web.Request) -> web.Response:
        """Get or set one model's thresholds (ref: busy_threshold.rs POST)."""
        body, err = await self._read_json(request)
        if err is not None:
            return err
        model = body.get("model")
        if not model:
            return _error_response(OpenAIError("'model' is required"))
        has_values = (
            "active_decode_blocks_threshold" in body
            or "waiting_requests_threshold" in body
        )
        if has_values:
            self.busy_thresholds[model] = BusyThresholds(
                active_decode_blocks_threshold=body.get(
                    "active_decode_blocks_threshold"
                ),
                waiting_requests_threshold=body.get("waiting_requests_threshold"),
            )
        th = self.busy_thresholds.get(model, BusyThresholds())
        return web.json_response({"model": model, **th.to_dict()})

    async def _clear_kv_blocks(self, request: web.Request) -> web.Response:
        """Flush worker prefix caches (ref: clear_kv_blocks.rs). Body may
        scope to one model: {"model": "..."}; default = every model."""
        body = {}
        if request.can_read_body:
            body, err = await self._read_json(request)
            if err is not None:
                return err
        model = (body or {}).get("model")
        names = [model] if model else self.models.names()
        results: Dict[str, Any] = {}
        for name in names:
            entry = self.models.get(name)
            if entry is None:
                results[name] = {"error": "model not found"}
                continue
            clear = entry.admin.get("clear_kv")
            if clear is None:
                results[name] = {"error": "no clear_kv hook (local pipeline)"}
                continue
            try:
                results[name] = {"cleared_blocks": await clear()}
            except Exception as exc:
                logger.exception("clear_kv_blocks for %s failed", name)
                results[name] = {"error": str(exc)}
        return web.json_response({"results": results})

    async def _responses(self, request: web.Request) -> web.StreamResponse:
        """OpenAI Responses API over the chat pipeline (ref: openai.rs:1179
        — the reference also converts Responses → chat internally;
        text-only input, unsupported fields rejected 501)."""
        body, err = await self._read_json(request)
        if err is not None:
            return err
        for field in ("tools", "previous_response_id", "reasoning"):
            if body.get(field):
                return _error_response(
                    OpenAIError(
                        f"'{field}' is not supported on /v1/responses",
                        status=501, err_type="not_implemented",
                    )
                )
        inp = body.get("input")
        if isinstance(inp, str):
            messages = [{"role": "user", "content": inp}]
        elif isinstance(inp, list) and all(
            isinstance(m, dict) and isinstance(m.get("content"), str) for m in inp
        ):
            messages = [
                {"role": m.get("role", "user"), "content": m["content"]} for m in inp
            ]
        else:
            return _error_response(
                OpenAIError(
                    "'input' must be a string or a list of text messages "
                    "(non-text input is not supported)",
                    status=501, err_type="not_implemented",
                )
            )
        chat_body: Dict[str, Any] = {
            "model": body.get("model", ""),
            "messages": messages,
            "stream": False,
        }
        if body.get("max_output_tokens") is not None:
            chat_body["max_tokens"] = body["max_output_tokens"]
        for k in ("temperature", "top_p"):
            if body.get(k) is not None:
                chat_body[k] = body[k]
        model = chat_body["model"]
        entry = self.models.get(model)
        if entry is None:
            return _error_response(
                OpenAIError(f"model '{model}' not found", status=404,
                            err_type="not_found_error")
            )
        # The Responses API rides the same chat generation pipeline, so it
        # gets the same overload armor: client deadline, EDF admission,
        # and the brownout output clamp (a saturating burst must not
        # tunnel past the plane through this endpoint).
        deadline, derr = self._parse_deadline(request, body)
        if derr is not None:
            return derr
        timer = RequestTimer(
            self.metrics, model, "responses",
            itl_observer=(
                self.overload.observe_itl if self.overload is not None else None
            ),
        )
        ctx = Context(baggage={"model": model}, deadline=deadline)
        stream = bool(body.get("stream", False))
        rid = gen_id("resp")
        ticket: Optional[AdmissionTicket] = None
        if self.overload is not None:
            self.overload.apply_default_deadline(ctx)
            try:
                ticket = await self.overload.admit(ctx)
            except OverloadShedError as exc:
                timer.done(exc.status)
                return _shed_response(exc)

        def envelope(status: str, output=None, usage=None) -> Dict[str, Any]:
            resp: Dict[str, Any] = {
                "id": rid, "object": "response", "status": status,
                "model": model, "output": output or [],
            }
            if usage is not None:
                resp["usage"] = usage
            return resp

        ok = False
        try:
            if self.overload is not None:
                clamped = self.overload.clamp_max_tokens(
                    chat_body.get("max_tokens")
                )
                if clamped is not None and clamped != chat_body.get("max_tokens"):
                    chat_body["max_tokens"] = clamped
            with self.tracker.guard():
                if stream:
                    resp = await self._responses_stream(
                        request, chat_body, entry, ctx, timer, envelope
                    )
                    ok = True
                    return resp
                text_parts: list = []
                prompt_tokens = 0
                completion_tokens = 0
                async for item in entry.engine.generate(chat_body, ctx):
                    if isinstance(item, dict):
                        if item.get("annotation") == "_prompt_tokens":
                            prompt_tokens = item["value"]
                            timer.on_input_tokens(prompt_tokens)
                        continue
                    out: PostprocessedOutput = item
                    if out.error:
                        ekind = getattr(out, "error_kind", None)
                        raise OpenAIError(
                            out.error, status=_status_of_kind(ekind),
                            err_type=_err_type_of_kind(ekind), kind=ekind,
                        )
                    if out.text:
                        text_parts.append(out.text)
                    if out.token_ids:
                        completion_tokens += len(out.token_ids)
                        timer.on_token(len(out.token_ids))
                timer.done(200)
                ok = True
                return web.json_response(
                    envelope(
                        "completed",
                        output=[
                            {
                                "type": "message",
                                "role": "assistant",
                                "content": [
                                    {
                                        "type": "output_text",
                                        "text": "".join(text_parts),
                                    }
                                ],
                            }
                        ],
                        usage={
                            "input_tokens": prompt_tokens,
                            "output_tokens": completion_tokens,
                            "total_tokens": prompt_tokens + completion_tokens,
                        },
                    )
                )
        except OpenAIError as exc:
            timer.done(exc.status)
            return _error_response(exc)
        except asyncio.CancelledError:
            ctx.kill()
            timer.done(499)
            raise
        except Exception as exc:
            error_kind = _error_kind_of(exc)
            logger.exception("responses failed")
            status = _status_of_kind(error_kind)
            timer.done(status)
            return _error_response(
                OpenAIError(
                    str(exc), status=status,
                    err_type=_err_type_of_kind(error_kind), kind=error_kind,
                )
            )
        finally:
            if ticket is not None:
                self.overload.release(ticket, ok=ok)

    async def _responses_stream(
        self, request: web.Request, chat_body, entry, ctx: Context,
        timer: RequestTimer, envelope,
    ) -> web.StreamResponse:
        """Responses API streaming: typed SSE events
        (response.created → response.output_text.delta* →
        response.output_text.done → response.completed), each framed as
        ``event: <type>`` + ``data: <json>`` with sequence numbers."""
        response = web.StreamResponse(
            status=200,
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "X-Request-Id": ctx.id,
            },
        )
        await response.prepare(request)
        seq = 0

        async def send(event_type: str, payload: Dict[str, Any]) -> None:
            nonlocal seq
            payload = {"type": event_type, "sequence_number": seq, **payload}
            seq += 1
            with _suppress_conn_errors():
                await response.write(
                    f"event: {event_type}\ndata: {json.dumps(payload)}\n\n".encode()
                )

        await send("response.created", {"response": envelope("in_progress")})
        text_parts: list = []
        prompt_tokens = 0
        completion_tokens = 0
        status = 200
        try:
            async for item in entry.engine.generate(chat_body, ctx):
                if isinstance(item, dict):
                    if item.get("annotation") == "_prompt_tokens":
                        prompt_tokens = item["value"]
                        timer.on_input_tokens(prompt_tokens)
                    continue
                out: PostprocessedOutput = item
                if out.error:
                    await send(
                        "error",
                        {
                            "message": out.error,
                            "code": _err_type_of_kind(
                                getattr(out, "error_kind", None)
                            ),
                            "error_kind": getattr(out, "error_kind", None),
                        },
                    )
                    # Terminal event so SDK consumers waiting on a final
                    # response.* event resolve instead of hanging.
                    await send(
                        "response.failed", {"response": envelope("failed")}
                    )
                    status = 500
                    break
                if out.token_ids:
                    completion_tokens += len(out.token_ids)
                    timer.on_token(len(out.token_ids))
                if out.text:
                    text_parts.append(out.text)
                    await send(
                        "response.output_text.delta",
                        {"item_id": "msg_0", "output_index": 0,
                         "content_index": 0, "delta": out.text},
                    )
            if status == 200:
                full = "".join(text_parts)
                await send(
                    "response.output_text.done",
                    {"item_id": "msg_0", "output_index": 0,
                     "content_index": 0, "text": full},
                )
                await send(
                    "response.completed",
                    {
                        "response": envelope(
                            "completed",
                            output=[
                                {
                                    "type": "message",
                                    "role": "assistant",
                                    "content": [
                                        {"type": "output_text", "text": full}
                                    ],
                                }
                            ],
                            usage={
                                "input_tokens": prompt_tokens,
                                "output_tokens": completion_tokens,
                                "total_tokens": prompt_tokens + completion_tokens,
                            },
                        )
                    },
                )
        except asyncio.CancelledError:
            ctx.kill()
            timer.done(499)
            raise
        except Exception as exc:
            # The SSE response is already prepared and partially written —
            # returning a fresh JSON response here would corrupt the stream.
            # Emit a terminal error + response.failed pair and end the stream
            # cleanly instead (mirrors _stream_response's contract).
            logger.exception("responses stream failed")
            await send("error", {"message": str(exc), "code": "internal_error"})
            await send("response.failed", {"response": envelope("failed")})
            status = 500
        finally:
            if not ctx.stopped:
                ctx.stop_generating(reason="response-stream-finished")
        timer.done(status)
        with _suppress_conn_errors():
            await response.write_eof()
        return response

    async def _openapi(self, request: web.Request) -> web.Response:
        """Minimal OpenAPI description of the served routes (ref: the
        reference's RouteDoc/OpenAPI surface)."""

        def op(summary, *, body=False):
            doc: Dict[str, Any] = {"summary": summary, "responses": {"200": {"description": "OK"}}}
            if body:
                doc["requestBody"] = {
                    "content": {"application/json": {"schema": {"type": "object"}}}
                }
            return doc

        paths = {
            "/v1/chat/completions": {"post": op("OpenAI chat completions (SSE streaming via stream=true)", body=True)},
            "/v1/completions": {"post": op("OpenAI text completions", body=True)},
            "/v1/responses": {"post": op("OpenAI Responses API (text-only)", body=True)},
            "/v1/embeddings": {"post": op("Embeddings", body=True)},
            "/v1/models": {"get": op("List served models")},
            "/health": {"get": op("Readiness: healthy when ≥1 model is served")},
            "/live": {"get": op("Liveness")},
            "/metrics": {"get": op("Prometheus metrics")},
            "/busy_threshold": {
                "get": op("List busy thresholds"),
                "post": op("Get/set one model's busy thresholds", body=True),
            },
            "/clear_kv_blocks": {"post": op("Flush worker KV prefix caches", body=True)},
            "/debug/parser": {"get": op("Tool-call parser plane: stream outcomes, degrades, parser flight ring")},
            "/debug/trajectory": {"get": op("Fleet trajectory index (recent + slow/error, SLO snapshot)")},
            "/debug/trajectory/{trace_id}": {"get": op("One stitched cross-worker request trajectory")},
        }
        return web.json_response(
            {
                "openapi": "3.0.0",
                "info": {"title": "dynamo_tpu frontend", "version": __version__},
                "paths": paths,
            }
        )

    def _model_busy(self, model: str, entry) -> bool:
        th = self.busy_thresholds.get(model)
        if th is None or entry.monitor is None:
            return False
        return entry.monitor.all_busy(th)

    # -- OpenAI routes -----------------------------------------------------

    async def _chat_completions(self, request: web.Request) -> web.StreamResponse:
        return await self._serve_generation(request, kind="chat")

    async def _completions(self, request: web.Request) -> web.StreamResponse:
        return await self._serve_generation(request, kind="completion")

    async def _embeddings(self, request: web.Request) -> web.Response:
        """The port serves no embedding model yet (engines/embed.py comes
        later): every model gets the answer JAX gives a model of another
        type."""
        body, err = await self._read_json(request)
        if err is not None:
            return err
        model = body.get("model", "")
        return _error_response(
            OpenAIError(f"model '{model}' does not support embeddings", status=404, err_type="not_found_error")
        )

    async def _images(self, request: web.Request) -> web.Response:
        """OpenAI images API (ref: openai.rs:1552 images route). The port
        serves no image model yet: after the prompt check, every model gets
        the answer JAX gives a model of another type."""
        body, err = await self._read_json(request)
        if err is not None:
            return err
        model = body.get("model", "")
        prompt = body.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            return _error_response(OpenAIError("'prompt' is required"))
        return _error_response(
            OpenAIError(
                f"model '{model}' does not support image generation",
                status=404, err_type="not_found_error",
            )
        )

    async def _read_json(self, request: web.Request):
        try:
            return await request.json(), None
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None, _error_response(OpenAIError("invalid JSON body"))

    async def _serve_generation(self, request: web.Request, kind: str) -> web.StreamResponse:
        body, err = await self._read_json(request)
        if err is not None:
            return err
        if not isinstance(body, dict):
            return _error_response(OpenAIError("request body must be a JSON object"))
        model = body.get("model", "")
        entry = self.models.get(model)
        if entry is None:
            return _error_response(
                OpenAIError(f"model '{model}' not found", status=404, err_type="not_found_error")
            )
        stream = bool(body.get("stream", False))
        try:
            n = parse_n(body)
        except OpenAIError as exc:
            return _error_response(exc)
        if stream and n > 1:
            return _error_response(
                OpenAIError(
                    "streaming with n > 1 is not supported; request unary "
                    "or n=1", status=400,
                )
            )
        endpoint = "chat_completions" if kind == "chat" else "completions"
        # W3C trace propagation (ref: logging.rs:72): an incoming
        # traceparent joins the caller's trace; spans flow via baggage.
        traceparent = request.headers.get("traceparent")
        # Gateway pin (EPP header hint, gateway/epp.py): the inference
        # gateway already ran KV-aware selection — carry the pin to the
        # request-plane picker. The body key is trusted-infra-only: strip
        # anything a client smuggled into the JSON before honoring the
        # header (otherwise any client could steer load to one worker).
        body.pop("_pinned_worker", None)
        pin = request.headers.get("x-dynamo-worker")
        if pin:
            try:
                body["_pinned_worker"] = int(pin.split(":", 1)[0])
            except ValueError:
                pass
        if self._model_busy(model, entry):
            # All workers over threshold: shed before any work is queued
            # (ref: busy_threshold.rs middleware → 503).
            resp = _error_response(
                OpenAIError(
                    f"all workers for model '{model}' are busy; retry later",
                    status=503,
                    err_type="service_unavailable",
                )
            )
            resp.headers["Retry-After"] = "1"
            return resp
        # Client deadline (overload armor): header wins over the body key;
        # the budget lands in Context.deadline and rides the request plane
        # end to end — engine admission sheds it expired.
        deadline, err = self._parse_deadline(request, body)
        if err is not None:
            return err
        timer = RequestTimer(
            self.metrics, model, endpoint,
            itl_observer=(
                self.overload.observe_itl if self.overload is not None else None
            ),
        )
        baggage: Dict[str, Any] = {"model": model}
        if traceparent:
            baggage["traceparent"] = traceparent
        ctx = Context(baggage=baggage, deadline=deadline)
        ticket: Optional[AdmissionTicket] = None
        ok = False
        try:
            # Root span opens BEFORE admission so the overload queue wait
            # is a child span inside the trace (the trajectory plane's
            # "queue" phase) instead of invisible pre-trace time.
            with self.tracker.guard(), span(
                f"http.{endpoint}", ctx, model=model, stream=stream
            ):
                # The root span just wrote its traceparent into the context
                # baggage: binding here gives the timer (exemplars) the
                # request's trace id.
                timer.bind_context(ctx)
                if self.overload is not None:
                    self.overload.apply_default_deadline(ctx)
                    with span("overload.queue", ctx) as qsp:
                        ticket = await self.overload.admit(ctx)
                        qsp.attributes["queued_s"] = round(
                            ticket.queue_delay_s, 4
                        )
                    # Brownout output clamp: under pressure nobody gets an
                    # unbounded completion (no-op while healthy). Inside
                    # the try so NOTHING between admit and release can
                    # leak the admission slot.
                    clamped = self.overload.clamp_max_tokens(
                        body.get("max_tokens")
                    )
                    if clamped is not None and clamped != body.get("max_tokens"):
                        body["max_tokens"] = clamped
                if stream:
                    resp = await self._stream_response(
                        request, body, entry, ctx, kind, timer
                    )
                else:
                    resp = await self._unary_response(
                        body, entry, ctx, kind, timer, n
                    )
                ok = True
                return resp
        except OverloadShedError as exc:
            timer.done(exc.status)
            return _shed_response(exc)
        except OpenAIError as exc:
            timer.done(exc.status)
            return _error_response(exc)
        except asyncio.CancelledError:
            ctx.kill()
            timer.done(499)
            raise
        except Exception as exc:
            # Typed upstream failures (a worker link dropping, a deadline
            # blown inside the stack) carry their taxonomy label instead of
            # a bare 500.
            error_kind = _error_kind_of(exc)
            logger.exception("generation failed")
            status = _status_of_kind(error_kind)
            timer.done(status)
            return _error_response(
                OpenAIError(
                    str(exc), status=status,
                    err_type=_err_type_of_kind(error_kind), kind=error_kind,
                )
            )
        finally:
            if ticket is not None:
                self.overload.release(ticket, ok=ok)

    def _parse_deadline(self, request: web.Request, body: Dict[str, Any]):
        """(absolute monotonic deadline | None, error response | None).
        ``x-dynamo-deadline-ms`` header wins; the ``deadline_ms`` body key
        is accepted for clients that can't set headers and is stripped
        either way so it never reaches preprocessing."""
        raw = request.headers.get("x-dynamo-deadline-ms")
        body_raw = body.pop("deadline_ms", None)
        if raw is None:
            raw = body_raw
        if raw is None:
            return None, None
        try:
            ms = float(raw)
        except (TypeError, ValueError):
            ms = -1.0
        if ms <= 0 or not ms == ms:  # rejects NaN too
            return None, _error_response(
                OpenAIError(
                    "'deadline_ms' must be a positive number of "
                    "milliseconds (header x-dynamo-deadline-ms or body "
                    "key deadline_ms)"
                )
            )
        return time.monotonic() + ms / 1000.0, None

    # -- unary -------------------------------------------------------------

    async def _collect_one(
        self, body: Dict[str, Any], entry, ctx: Context, timer: RequestTimer,
        *, primary: bool = True,
    ):
        """Fold one engine stream → (text, finish, prompt_tokens,
        completion_tokens, logprob_entries). Only the primary stream feeds
        latency histograms (secondary n>1 streams would corrupt TTFT/ITL)."""
        text_parts = []
        finish: Optional[FinishReason] = None
        prompt_tokens = 0
        completion_tokens = 0
        logprob_entries: list = []
        async for item in entry.engine.generate(body, ctx):
            if isinstance(item, dict) and item.get("annotation") == "_prompt_tokens":
                prompt_tokens = item["value"]
                continue
            if isinstance(item, dict):
                continue  # other annotations are streaming-only
            out: PostprocessedOutput = item
            if out.error:
                kind = getattr(out, "error_kind", None)
                raise OpenAIError(
                    out.error, status=_status_of_kind(kind),
                    err_type=_err_type_of_kind(kind), kind=kind,
                )
            if out.text:
                text_parts.append(out.text)
            if out.token_ids:
                if primary:
                    timer.on_token(len(out.token_ids))
                else:
                    timer.count_tokens(len(out.token_ids))
            if out.logprobs:
                logprob_entries.extend(out.logprobs)
            completion_tokens = out.cumulative_tokens or completion_tokens
            if out.finish_reason is not None:
                finish = out.finish_reason
        return (
            "".join(text_parts), finish, prompt_tokens, completion_tokens,
            logprob_entries,
        )

    def _chat_choice(
        self, entry, body: Dict[str, Any], text: str, finish_str: str, index: int,
        logprob_entries=None,
    ) -> Dict[str, Any]:
        """Parse one completed chat message into an OpenAI choice entry
        (reasoning tags + tool-call dialects; ref: lib/parsers)."""
        reasoning, content = split_reasoning(
            text, style=entry.card.reasoning_style
        )
        message: Dict[str, Any] = {"role": "assistant", "content": content}
        if body.get("tools"):
            # Same dialect pin as the streaming jail (unary/stream parity).
            calls, content = detect_and_parse_tool_calls(
                content, dialect=getattr(entry.card, "tool_call_dialect", None)
            )
            message["content"] = content
            if calls:
                message["tool_calls"] = [c.to_openai() for c in calls]
                finish_str = "tool_calls"
        if reasoning:
            message["reasoning_content"] = reasoning
        return {
            "index": index,
            "message": message,
            "logprobs": (
                chat_logprobs_block(logprob_entries) if logprob_entries else None
            ),
            "finish_reason": finish_str,
        }

    async def _unary_response(
        self,
        body: Dict[str, Any],
        entry,
        ctx: Context,
        kind: str,
        timer: RequestTimer,
        n: int,
    ) -> web.Response:
        rid = gen_id("chatcmpl" if kind == "chat" else "cmpl")
        if n <= 1:
            results = [await self._collect_one(body, entry, ctx, timer)]
        else:
            # n > 1: n independent engine requests (shared-prefix prefill is
            # served from the cache; sampling diverges per slot). OpenAI
            # usage counts the prompt once and sums completions. Child
            # contexts inherit the request's deadline and hard-kill.
            contexts = [ctx.child() for _ in range(n)]
            tasks = [
                asyncio.ensure_future(
                    self._collect_one(
                        dict(body), entry, c, timer, primary=(i == 0)
                    )
                )
                for i, c in enumerate(contexts)
            ]
            try:
                results = await asyncio.gather(*tasks)
            except BaseException:
                # One choice failed/cancelled: tear the siblings down and
                # WAIT for them — they must not outlive the tracker guard.
                for c in contexts:
                    c.stop_generating(reason="sibling-choice-failed")
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                raise
        prompt_tokens = results[0][2]
        timer.on_input_tokens(prompt_tokens)
        completion_tokens = sum(r[3] for r in results)
        usage = usage_block(prompt_tokens, completion_tokens)
        text = results[0][0]  # primary choice (audit record)
        choices = []
        for i, (choice_text, finish, _pt, _ct, lp_entries) in enumerate(results):
            finish_str = (finish or FinishReason.EOS).to_openai()
            if kind == "chat":
                choices.append(
                    self._chat_choice(
                        entry, body, choice_text, finish_str, i, lp_entries
                    )
                )
            else:
                choices.append(
                    {
                        "index": i, "text": choice_text,
                        "logprobs": (
                            completion_logprobs_block(lp_entries)
                            if lp_entries else None
                        ),
                        "finish_reason": finish_str,
                    }
                )
        finish_str = choices[0]["finish_reason"]
        payload = completion_envelope(
            rid, entry.name,
            object_="chat.completion" if kind == "chat" else "text_completion",
            choices=choices, usage=usage,
        )
        timer.done(200)
        if self.audit.enabled:
            self.audit.publish(
                AuditRecord(
                    request_id=ctx.id, model=entry.name, endpoint=kind,
                    requested_streaming=False, request=body,
                    response_text=text, finish_reason=finish_str, status=200,
                )
            )
        return web.json_response(payload)

    # -- streaming ---------------------------------------------------------

    async def _stream_response(
        self,
        request: web.Request,
        body: Dict[str, Any],
        entry,
        ctx: Context,
        kind: str,
        timer: RequestTimer,
    ) -> web.StreamResponse:
        rid = gen_id("chatcmpl" if kind == "chat" else "cmpl")
        include_usage = bool((body.get("stream_options") or {}).get("include_usage"))

        # Pull the first stream item BEFORE sending headers: preprocessing
        # (validation, templating, tokenization) raises on the first item, and
        # those failures must surface as a proper HTTP 4xx, not an in-band
        # frame after a 200 (the unary path already behaves this way).
        stream = entry.engine.generate(body, ctx).__aiter__()
        try:
            first_item = await stream.__anext__()
        except StopAsyncIteration:
            first_item = None
        except OpenAIError as exc:
            timer.done(exc.status)
            return _error_response(exc)

        response = web.StreamResponse(
            status=200,
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "Connection": "keep-alive",
                "X-Request-Id": ctx.id,
            },
        )
        await response.prepare(request)

        prompt_tokens = 0
        completion_tokens = 0
        sent_role = False
        status = 200
        lp_offset = 0  # running char offset for completions text_offset
        finish_seen: Optional[str] = None
        audit_parts: Optional[list] = [] if self.audit.enabled else None
        reasoning_parser = ReasoningParser(style=entry.card.reasoning_style)
        # Incremental tool-call jail (parsers/jail.py): when the request
        # declared tools, dialect text surfaces as tool_calls ARGUMENT
        # DELTAS while the model is still generating the call; malformed
        # calls degrade via the typed ladder, never a dropped stream.
        jail = None
        parse_error = False
        if kind == "chat" and body.get("tools"):
            jail = ToolCallJail(
                dialect=getattr(entry.card, "tool_call_dialect", None)
            )
        try:
            async for item in _prepend(first_item, stream):
                if isinstance(item, dict) and "annotation" in item:
                    if item["annotation"] == "_prompt_tokens":
                        prompt_tokens = item["value"]
                        timer.on_input_tokens(prompt_tokens)
                    else:
                        # Public annotations ride as SSE comments (ref:
                        # preprocessor.rs annotations → SSE comment frames).
                        await _sse_comment(response, item)
                    continue
                out: PostprocessedOutput = item
                if out.error:
                    # Terminal typed SSE error event (headers are long
                    # sent): error_kind lets an SDK distinguish a
                    # migration-exhausted link failure from a real bug.
                    kind = getattr(out, "error_kind", None)
                    frame: Dict[str, Any] = {
                        "message": out.error,
                        "type": _err_type_of_kind(kind),
                    }
                    if kind:
                        frame["error_kind"] = kind
                    await _sse_send(response, {"error": frame})
                    status = _status_of_kind(kind)
                    break
                completion_tokens = out.cumulative_tokens or completion_tokens
                if out.token_ids:
                    timer.on_token(len(out.token_ids))
                if audit_parts is not None and out.text:
                    audit_parts.append(out.text)
                finish_str = out.finish_reason.to_openai() if out.finish_reason else None
                if finish_str:
                    finish_seen = finish_str
                if kind == "chat":
                    base: Dict[str, Any] = {}
                    if not sent_role:
                        base["role"] = "assistant"
                        sent_role = True
                    text = out.text
                    if out.finish_reason is not None:
                        reasoning, content = reasoning_parser.feed(text or "")
                        r_tail, c_tail = reasoning_parser.flush()
                        reasoning += r_tail
                        content += c_tail
                    elif text:
                        reasoning, content = reasoning_parser.feed(text)
                    else:
                        reasoning = content = ""
                    if reasoning:
                        # Streamed reasoning rides the nonstandard-but-common
                        # reasoning_content delta field (ref: jail.rs stream
                        # rewriting for <think> sections).
                        base["reasoning_content"] = reasoning
                    if jail is not None:
                        events = jail.feed(content) if content else []
                        if out.finish_reason is not None:
                            events = events + jail.finish()
                            if jail.calls_started:
                                # ANY emitted call — including one the
                                # ladder sealed — finishes as tool_calls
                                # (the seal's structured error field says
                                # which calls are suspect).
                                finish_str = "tool_calls"
                                finish_seen = finish_str
                        deltas = _fold_jail_events(base, events)
                    else:
                        if content:
                            base["content"] = content
                        deltas = [base]
                    # OpenAI semantics: content logprobs correspond to emitted
                    # content. When the reasoning parser withheld this chunk's
                    # text (or routed it into reasoning_content), attaching the
                    # token logprobs would describe tokens absent from the
                    # delta — suppress them for those chunks.
                    last = len(deltas) - 1
                    for di, delta in enumerate(deltas):
                        await _sse_send(response, chat_chunk(
                            rid, entry.name, delta=delta,
                            finish_reason=(
                                finish_str if di == last else None
                            ),
                            logprobs=(
                                chat_logprobs_block(out.logprobs)
                                if out.logprobs and di == 0
                                and (delta.get("content")
                                     or delta.get("tool_calls"))
                                else None
                            ),
                        ))
                    continue
                else:
                    lp_block = None
                    if out.logprobs:
                        lp_block = completion_logprobs_block(
                            out.logprobs, text_offset=lp_offset
                        )
                        lp_offset = (
                            lp_block["text_offset"][-1]
                            + len(lp_block["tokens"][-1])
                        )
                    chunk = completion_chunk(
                        rid, entry.name, text=out.text, finish_reason=finish_str,
                        logprobs=lp_block,
                    )
                await _sse_send(response, chunk)
            if kind == "chat" and status == 200 and finish_seen is None:
                # Stream ended without a finish chunk (the unary path
                # defaults to EOS here): release anything the reasoning
                # parser or the jail still holds — buffered text must not
                # vanish, and a call mid-generation is sealed by the
                # jail's finish (truncated, typed).
                base = {}
                r_tail, c_tail = reasoning_parser.flush()
                if r_tail:
                    base["reasoning_content"] = r_tail
                if jail is not None:
                    events = jail.feed(c_tail) if c_tail else []
                    events = events + jail.finish()
                    deltas = _fold_jail_events(base, events)
                    if jail.calls_started:
                        finish_seen = "tool_calls"
                else:
                    if c_tail:
                        base["content"] = c_tail
                    deltas = [base]
                finish_seen = finish_seen or FinishReason.EOS.to_openai()
                last = len(deltas) - 1
                for di, delta in enumerate(deltas):
                    await _sse_send(
                        response,
                        chat_chunk(
                            rid, entry.name, delta=delta,
                            finish_reason=(
                                finish_seen if di == last else None
                            ),
                        ),
                    )
            if include_usage and status == 200:
                usage = usage_block(prompt_tokens, completion_tokens)
                if kind == "chat":
                    final = chat_chunk(rid, entry.name, delta={}, usage=usage)
                    final["choices"] = []
                else:
                    final = completion_chunk(rid, entry.name, text="", usage=usage)
                    final["choices"] = []
                await _sse_send(response, final)
            await _sse_done(response)
        except (ConnectionResetError, asyncio.CancelledError):
            # Client went away: kill the context so the engine frees the slot
            # (ref: http/service/disconnect.rs).
            ctx.kill()
            status = 499
        except Exception as exc:
            # Headers already sent: report in-band on the SSE stream; a second
            # HTTP response is impossible at this point.
            error_kind = _error_kind_of(exc)
            parse_error = error_kind == "tool_call_parse"
            logger.exception("engine failed mid-stream")
            status = _status_of_kind(error_kind)
            frame = {
                "message": str(exc), "type": _err_type_of_kind(error_kind),
            }
            if error_kind:
                frame["error_kind"] = error_kind
            with _suppress_conn_errors():
                await _sse_send(response, {"error": frame})
        finally:
            timer.done(status)
            if jail is not None:
                # Per-stream outcome for the parser plane: clean | degraded
                # | error (a wrapped parser exception = error — the client
                # saw the typed frame above, not a dropped stream).
                parser_plane().note_stream(
                    "error" if parse_error else jail.outcome()
                )
            if audit_parts is not None:
                self.audit.publish(
                    AuditRecord(
                        request_id=ctx.id, model=entry.name, endpoint=kind,
                        requested_streaming=True, request=body,
                        response_text="".join(audit_parts),
                        finish_reason=finish_seen, status=status,
                    )
                )
        with _suppress_conn_errors():
            await response.write_eof()
        return response


def _fold_jail_events(base: Dict[str, Any], events) -> list:
    """Fold incremental-jail events (parsers/incremental.py) into an
    ordered list of chat ``delta`` dicts for one engine item.

    ``base`` seeds the first delta (role / reasoning_content). Content
    may share a delta with tool_calls entries that FOLLOW it, but content
    arriving AFTER a tool_calls entry opens a new delta — OpenAI clients
    replay deltas in order, and reordering content around a call would
    corrupt the transcript (two back-to-back calls with content between
    them is a supported shape). Consecutive argument deltas for the same
    call index merge into one wire entry."""
    deltas: list = [dict(base)]
    for ev in events:
        cur = deltas[-1]
        if isinstance(ev, ContentDelta):
            if not ev.text:
                continue
            if "tool_calls" in cur:
                deltas.append({"content": ev.text})
            else:
                cur["content"] = cur.get("content", "") + ev.text
        elif isinstance(ev, CallStart):
            cur.setdefault("tool_calls", []).append(
                {
                    "index": ev.index,
                    "id": ev.call_id,
                    "type": "function",
                    "function": {"name": ev.name, "arguments": ""},
                }
            )
        elif isinstance(ev, ArgsDelta):
            tcs = cur.setdefault("tool_calls", [])
            if tcs and tcs[-1]["index"] == ev.index and "function" in tcs[-1]:
                tcs[-1]["function"]["arguments"] += ev.text
            else:
                tcs.append(
                    {"index": ev.index, "function": {"arguments": ev.text}}
                )
        elif isinstance(ev, CallEnd):
            if ev.error is None and not ev.degraded:
                continue
            # Sealed / lossy call: the structured error field rides the
            # call's last tool_calls entry (clients that ignore unknown
            # fields see a normal, possibly truncated-args call).
            entry: Dict[str, Any] = {"index": ev.index}
            if ev.error is not None:
                entry["error"] = {"reason": ev.error}
            if ev.degraded:
                entry["degraded"] = True
            cur.setdefault("tool_calls", []).append(entry)
    return deltas


def _error_response(exc: OpenAIError) -> web.Response:
    return web.json_response(exc.to_body(), status=exc.status)


def _shed_response(exc: OverloadShedError) -> web.Response:
    """Typed overload shed: 429 (load) / 503 (brownout) / 504 (dead
    deadline), with Retry-After carrying the predicted drain time."""
    dead = exc.reason == "deadline_expired"
    resp = _error_response(
        OpenAIError(
            str(exc), status=exc.status,
            err_type="deadline_exceeded" if dead else "overloaded",
            kind="timeout" if dead else exc.reason,
        )
    )
    if exc.retry_after is not None:
        resp.headers["Retry-After"] = str(
            max(1, int(exc.retry_after + 0.999))
        )
    return resp


async def _prepend(first, rest: AsyncIterator[Any]):
    if first is not None:
        yield first
    async for item in rest:
        yield item


async def _sse_send(response: web.StreamResponse, payload: Dict[str, Any]) -> None:
    await response.write(b"data: " + json.dumps(payload, separators=(",", ":")).encode() + b"\n\n")


async def _sse_comment(response: web.StreamResponse, payload: Dict[str, Any]) -> None:
    await response.write(b": " + json.dumps(payload, separators=(",", ":")).encode() + b"\n\n")


async def _sse_done(response: web.StreamResponse) -> None:
    await response.write(b"data: [DONE]\n\n")


class _suppress_conn_errors:
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return exc_type is not None and issubclass(
            exc_type, (ConnectionResetError, ConnectionAbortedError, RuntimeError)
        )
