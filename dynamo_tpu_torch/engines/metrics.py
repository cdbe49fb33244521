"""Engine step-loop metrics — the port's copy of
dynamo_tpu/engines/metrics.py (the ``ALL_ENGINE`` step families).

Reference parity: the reference's backend ForwardPassMetrics / engine-side
Prometheus gauges — but for the step loop itself: how long each device
dispatch takes, how full the batch is, and how many tokens each step moved,
split prefill vs decode. These are the signals the planner's SLA math and
autoscaling need (step time × occupancy = achieved throughput;
prefill-vs-decode token mix = P/D balance).

One instance per engine object on a private registry (runtime/metrics_core.py);
``render`` plugs into ``SystemStatusServer.register_metrics``, wired by
``attach_engine``. The registry writes bucket bounds as JAX's kit writes
them, so the exposition is byte-equal to JAX's for the same observations.
"""

from __future__ import annotations

from typing import Any


class EngineStepMetrics:
    def __init__(self) -> None:
        from dynamo_tpu_torch.runtime import metric_names as mn
        from dynamo_tpu_torch.runtime.metrics_core import COUNT_BUCKETS, MetricsRegistry

        self.registry = MetricsRegistry(kit_le=True)
        self.step_duration = self.registry.histogram(
            mn.ENGINE_STEP_DURATION,
            "Device step wall time (one dispatch), by phase (prefill|decode)",
            ["phase"],
        )
        self.batch_occupancy = self.registry.histogram(
            mn.ENGINE_BATCH_OCCUPANCY,
            "Sequences packed into one device step, by phase",
            ["phase"],
            buckets=COUNT_BUCKETS,
        )
        self.prefill_tokens = self.registry.histogram(
            mn.ENGINE_STEP_PREFILL_TOKENS,
            "Prompt tokens processed per prefill step",
            buckets=COUNT_BUCKETS,
        )
        self.decode_tokens = self.registry.histogram(
            mn.ENGINE_STEP_DECODE_TOKENS,
            "Tokens emitted per decode step (fused multi-iteration burst)",
            buckets=COUNT_BUCKETS,
        )
        # Decode-tick pipelining (dispatch/reap split): host_gap is the
        # device wait the host injected between the previous burst's
        # readback completing and the next dispatch being enqueued — 0
        # whenever another burst was already queued on the device. The
        # depth-1 vs depth-2 comparison of this family IS the overlap win.
        self.host_gap = self.registry.histogram(
            mn.ENGINE_HOST_GAP,
            "Host-injected device wait between decode bursts "
            "(0 = the next burst was already in flight)",
        )
        self.inflight_depth = self.registry.histogram(
            mn.ENGINE_INFLIGHT_DEPTH,
            "Decode bursts in flight on the device at each dispatch "
            "(including the one being dispatched)",
            buckets=COUNT_BUCKETS,
        )

    def observe_prefill(self, duration_s: float, occupancy: int, tokens: int) -> None:
        self.step_duration.observe(duration_s, phase="prefill")
        self.batch_occupancy.observe(occupancy, phase="prefill")
        self.prefill_tokens.observe(tokens)

    def observe_decode(self, duration_s: float, occupancy: int, tokens: int) -> None:
        self.step_duration.observe(duration_s, phase="decode")
        self.batch_occupancy.observe(occupancy, phase="decode")
        self.decode_tokens.observe(tokens)

    def observe_host_gap(self, gap_s: float) -> None:
        self.host_gap.observe(gap_s)

    def observe_inflight(self, depth: int) -> None:
        self.inflight_depth.observe(depth)

    def host_gap_stats(self) -> tuple:
        """(count, total_seconds) observed on the host-gap family."""
        return self.host_gap.snapshot_total()

    def render(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics=openmetrics)

    def register_metrics(self, server: Any) -> None:
        """Expose this engine's step families on a SystemStatusServer."""
        server.register_metrics(self.render)
