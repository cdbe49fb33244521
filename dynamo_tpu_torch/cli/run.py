"""``python -m dynamo_tpu_torch.cli run``: drive the port's engine without a
cluster — the counterpart of ``dynamo_tpu.cli run`` (dynamo_tpu/cli/run.py);
and ``observe``, which pretty-prints a running worker's system server.

Reference parity: lib/llm/src/entrypoint/input.rs (Input::Text :31 —
interactive REPL; Input::Stdin — one prompt per line; Input::Batch — JSONL
file in, JSONL out with latency stats; Input::Http — OpenAI server over the
local pipeline). The engine is an in-process ``TorchEngine`` over a builtin
random-init config, served through the local OpenAI pipeline (preprocess →
detokenize → engine). It runs on the card; ``--device cpu`` runs the plain
versions on the CPU (the tests use it).

Refused, each naming the ROADMAP item that brings it: ``--model mock`` (the
mock engine, A4d), a model directory (weight loading, A9) and a preset
whose layers the port does not have (MoE, A7).

``observe trajectory [TRACE_ID]``, ``observe kvcache``, ``observe perf``
and ``observe`` with no view (``/debug/memory``, ``/debug/compiles`` and
``/debug/flight``) print what JAX's print (dynamo_tpu/cli/run.py:311-660),
read over the standard library's HTTP client (JAX's reads over aiohttp,
which the card's machine lacks).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
import urllib.error
import urllib.request
from typing import Any, Tuple

from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

logger = get_logger(__name__)


def builtin_configs():
    """Model names ``--model`` takes (dynamo_tpu/worker/__main__.py:34-44),
    mapped to the port's presets."""
    from dynamo_tpu_torch.models import config as m

    return {
        "tiny": m.tiny_config,
        "qwen2.5-0.5b": m.qwen2_500m_config,
        "llama-3-8b": m.llama3_8b_config,
        "llama-3.2-3b": m.llama3_3b_config,
        "qwen3-8b": m.qwen3_8b_config,
        "llama-3-70b": m.llama3_70b_config,
        "gemma-2-2b": m.gemma2_2b_config,
        "gemma-3-1b": m.gemma3_1b_config,
        "mixtral-8x7b": m.mixtral_8x7b_config,
    }


def add_run_args(parser: argparse.ArgumentParser) -> None:
    from dynamo_tpu_torch import config

    parser.add_argument(
        "--input", default="text",
        help="text (REPL) | stdin | batch:FILE.jsonl | http",
    )
    parser.add_argument(
        "--model", default="mock",
        help="a builtin config name (tiny, qwen2.5-0.5b, ...); 'mock' and local HF "
        "model directories are not ported yet",
    )
    parser.add_argument("--served-model-name", default=None)
    parser.add_argument("--max-tokens", type=int, default=64)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--http-port", type=int, default=8080)
    parser.add_argument(
        "--block-size", type=int, default=config.KV_BLOCK_SIZE.get()
    )
    parser.add_argument("--num-kv-blocks", type=int, default=512)
    parser.add_argument("--max-model-len", type=int, default=2048)
    parser.add_argument("--out", default=None,
                        help="batch mode: output JSONL path (default stdout)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")


def build_engine_and_card(args) -> Tuple[Any, ModelDeploymentCard, Any]:
    """Returns (engine, card, tokenizer), as dynamo_tpu/cli/run.py:51-94
    builds them for a builtin config."""
    from dynamo_tpu_torch.llm.tokenizer import tiny_tokenizer

    name = args.served_model_name or args.model
    if args.model == "mock":
        raise SystemExit(
            "--model mock: the mock engine is not ported yet (ROADMAP A4d); "
            "pass a builtin config name, e.g. --model tiny"
        )
    presets = builtin_configs()
    if args.model not in presets:
        if os.path.isdir(args.model):
            raise SystemExit(
                f"--model {args.model}: serving a local HF model directory needs the "
                "checkpoint loader, which is not ported yet (ROADMAP A9, weight loading)"
            )
        raise SystemExit(
            f"--model {args.model!r}: unknown model (builtin configs: {', '.join(presets)})"
        )
    config = presets[args.model]()
    if config.is_moe:
        raise SystemExit(
            f"--model {args.model}: MoE layers are not ported yet (ROADMAP A7)"
        )
    from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs

    engine = TorchEngine(
        TorchEngineArgs(
            config=config,
            block_size=args.block_size,
            num_kv_blocks=args.num_kv_blocks,
            max_model_len=args.max_model_len,
            device=args.device,
            # a decode burst as a CUDA graph needs the card
            cuda_graphs=args.device != "cpu",
        )
    )
    card = ModelDeploymentCard(
        name=name, model_path=None, context_length=args.max_model_len,
        kv_block_size=args.block_size,
        eos_token_ids=list(config.eos_token_ids),
    )
    return engine, card, tiny_tokenizer()


async def _generate_text(pipeline, model: str, prompt: str, args) -> Tuple[str, int, float]:
    """One completion through the pipeline; returns (text, tokens, seconds)."""
    body = {
        "model": model,
        "prompt": prompt,
        "max_tokens": args.max_tokens,
        "temperature": args.temperature,
        "stream": True,
    }
    start = time.monotonic()
    parts = []
    n = 0
    async for item in pipeline.generate(body, Context()):
        if isinstance(item, dict):
            continue  # annotations
        if item.error:
            raise RuntimeError(item.error)
        parts.append(item.text)
        n += len(item.token_ids)
    return "".join(parts), n, time.monotonic() - start


async def run_text(pipeline, model: str, args) -> None:
    """Interactive REPL (ref: Input::Text)."""
    print(f"dynamo-tpu-torch REPL — model {model}; Ctrl-D to exit", flush=True)
    loop = asyncio.get_running_loop()
    while True:
        try:
            line = await loop.run_in_executor(None, input, "> ")
        except EOFError:
            break
        if not line.strip():
            continue
        try:
            text, n, dt = await _generate_text(pipeline, model, line, args)
        except RuntimeError as exc:
            print(f"error: {exc}", file=sys.stderr, flush=True)
            continue
        print(text, flush=True)
        print(f"  [{n} tokens in {dt:.2f}s]", file=sys.stderr, flush=True)


async def run_stdin(pipeline, model: str, args) -> None:
    """One prompt per stdin line, completion per line out (ref: Input::Stdin)."""
    for line in sys.stdin:
        line = line.rstrip("\n")
        if not line:
            continue
        text, _, _ = await _generate_text(pipeline, model, line, args)
        print(text, flush=True)


async def run_batch(pipeline, model: str, args, batch_path: str) -> None:
    """JSONL in ({'text': ...} or {'prompt': ...}), JSONL out with stats
    (ref: Input::Batch)."""
    out_f = open(args.out, "w") if args.out else sys.stdout
    total_tokens = 0
    start = time.monotonic()
    n_requests = 0
    try:
        with open(batch_path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                doc = json.loads(line)
                prompt = doc.get("text") or doc.get("prompt") or ""
                text, n, dt = await _generate_text(pipeline, model, prompt, args)
                total_tokens += n
                n_requests += 1
                out_f.write(
                    json.dumps(
                        {"prompt": prompt, "text": text, "tokens": n,
                         "latency_s": round(dt, 4)}
                    )
                    + "\n"
                )
                out_f.flush()
    finally:
        if args.out:
            out_f.close()
    wall = time.monotonic() - start
    print(
        f"batch done: {n_requests} requests, {total_tokens} tokens in "
        f"{wall:.2f}s ({total_tokens / max(wall, 1e-9):.1f} tok/s)",
        file=sys.stderr, flush=True,
    )


async def run_http(pipeline, card: ModelDeploymentCard, args) -> None:
    """Single-process OpenAI server over the local pipeline (in=http)."""
    from dynamo_tpu_torch.http import HttpService, ModelManager
    from dynamo_tpu_torch.runtime.trajectory import global_store
    from dynamo_tpu_torch.utils.tracing import set_service

    # Trajectory plane, dev-mode wiring: attach the store to the tracer
    # BEFORE the first request so /debug/trajectory sees every span.
    set_service("dev-http")
    global_store()
    manager = ModelManager()
    manager.register(card.name, pipeline, card)
    service = HttpService(manager, host="0.0.0.0", port=args.http_port)
    port = await service.start()
    print(f"http server on :{port} serving {card.name}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await service.stop(grace_period=5)


async def main_run(args) -> None:
    configure_logging()
    from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline

    mode = args.input
    if not (mode in ("text", "stdin", "http") or mode.startswith("batch:")):
        raise SystemExit(f"unknown --input {mode!r} (text | stdin | batch:FILE | http)")
    engine, card, tokenizer = build_engine_and_card(args)
    pipeline = build_local_pipeline(card, engine, tokenizer=tokenizer)
    try:
        if mode == "text":
            await run_text(pipeline, card.name, args)
        elif mode == "stdin":
            await run_stdin(pipeline, card.name, args)
        elif mode == "http":
            await run_http(pipeline, card, args)
        else:
            await run_batch(pipeline, card.name, args, mode.split(":", 1)[1])
    finally:
        await engine.stop()


# -- observe: views of a running worker's system server ----------------------


def add_observe_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "what", nargs="?", default=None,
        choices=[None, "trajectory", "kvcache", "perf"],
        help="optional view: 'trajectory' pretty-prints one stitched request "
        "trajectory (GET /debug/trajectory/{trace_id}); 'kvcache' the KV-reuse "
        "plane (GET /debug/kvcache); 'perf' the perf ledger — per-shape decode "
        "attribution, roofline fractions and the sentinel's verdicts (GET "
        "/debug/perf); no view the device plane (memory, compiles, flight)",
    )
    parser.add_argument(
        "trace_id", nargs="?", default=None,
        help="trace id for the trajectory view (omit to list recent + slow "
        "trajectories)",
    )
    parser.add_argument("--top-k", type=int, default=15,
                        help="ranked prefixes to show in the kvcache view")
    parser.add_argument("--host", default="127.0.0.1",
                        help="system-server host of the running worker")
    parser.add_argument("--port", type=int, default=None,
                        help="system-server port (default: DYN_TPU_SYSTEM_PORT)")
    parser.add_argument("--flight-limit", type=int, default=24,
                        help="newest flight-recorder events to show")
    parser.add_argument("--json", action="store_true",
                        help="dump the raw endpoint JSON instead of tables")


def _fmt_bytes(n) -> str:
    if not isinstance(n, (int, float)):
        return "?"
    # Negative values are meaningful (unaccounted_bytes < 0 = the ledger
    # overcounts the allocator) — keep the sign visible.
    sign, n = ("-", -n) if n < 0 else ("", n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return f"{sign}{int(n)} B" if unit == "B" else f"{sign}{n:.1f} {unit}"
        n /= 1024
    return f"{sign}{n:.1f} TiB"


def _system_base(args) -> str:
    from dynamo_tpu_torch import config

    port = args.port if args.port is not None else config.SYSTEM_PORT.get()
    return f"http://{args.host}:{port}"


def _get_json(base: str, path: str) -> Any:
    """GET ``base + path`` as JSON; exits naming the status or the error."""
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as exc:
        raise SystemExit(f"GET {base}{path} -> {exc.code}: {exc.read().decode()}")
    except (urllib.error.URLError, OSError) as exc:
        raise SystemExit(f"cannot reach system server at {base}: {exc}")


def main_observe_trajectory(args) -> None:
    """Pretty-print one stitched request trajectory (or the recent/slow
    index): phases, per-hop spans across processes, retries, skew flags,
    and the dominant phase."""
    base = _system_base(args)
    path = f"/debug/trajectory/{args.trace_id}" if args.trace_id else "/debug/trajectory"
    doc = _get_json(base, path)
    if args.json:
        print(json.dumps(doc, indent=2))
        return
    if not args.trace_id:
        print(f"== trajectories ({base}{path})")
        for row in doc.get("traces") or []:
            print(
                f"  {row['trace_id']}  {row['total_ms']:>9.1f} ms  "
                f"dominant={row['dominant_phase']:<13} "
                f"procs={len(row['processes'])} spans={row['span_count']}"
                f"{'  SKEW' if row.get('skew_flagged') else ''}"
            )
        slow = doc.get("slow") or []
        if slow:
            print("  -- slow/error ring --")
            for row in slow:
                print(
                    f"  {row['trace_id']}  {row['total_ms']:>9.1f} ms  "
                    f"dominant={row['dominant_phase']} "
                    f"[{row.get('retained', 'slow')}]"
                )
        return
    print(f"== trajectory {doc.get('trace_id')} ({base}{path})")
    print(
        f"  total {doc.get('total_ms', 0):.1f} ms across "
        f"{len(doc.get('processes') or [])} processes "
        f"({', '.join(doc.get('processes') or [])})"
        f"{'  [residual clock skew flagged]' if doc.get('skew_flagged') else ''}"
    )
    phases = doc.get("phases") or {}
    print("  phases:")
    for phase, ms in phases.items():
        marker = "  <- dominant" if phase == doc.get("dominant_phase") else ""
        print(f"    {phase:<14} {ms:>9.1f} ms{marker}")
    if doc.get("summary"):
        # Slow-ring hit: the full span set aged out of the recent ring;
        # the retained summary still names the bottleneck.
        print(
            f"  (summary only — {doc.get('span_count', 0)} spans aged out "
            "of the recent ring)"
        )
        return
    print("  spans:")
    for s in doc.get("spans") or []:
        attrs = s.get("attributes") or {}
        detail = " ".join(
            f"{k}={v}" for k, v in attrs.items()
            if k in ("worker", "src", "peer", "attempts", "retries",
                     "overlap_blocks", "candidates_scored", "queued_s",
                     "outcome", "adopted", "model")
        )
        flags = []
        if s.get("skew_flagged"):
            flags.append(f"skew={s.get('skew_ms')}ms")
        if str(s.get("status", "ok")) != "ok":
            flags.append(str(s["status"]))
        print(
            f"    {s.get('offset_ms', 0):>9.1f} +{s.get('duration_ms', 0):>8.1f} ms"
            f"  [{s.get('proc', '?'):<16}] {s.get('name', '?'):<22} "
            f"{detail}{('  ' + ' '.join(flags)) if flags else ''}"
        )
    events = doc.get("events") or []
    if events:
        print("  events:")
        for ev in events:
            detail = " ".join(
                f"{k}={v}" for k, v in ev.items()
                if k not in ("trace_id", "ring", "kind", "t_wall", "offset_ms")
            )
            print(
                f"    {ev.get('offset_ms', 0):>9.1f} ms  "
                f"{ev.get('ring', '?')}/{ev.get('kind', '?')} {detail}"
            )


def main_observe_kvcache(args) -> None:
    """Pretty-print the KV-reuse plane of a running worker: hit rate by
    tier, cache ROI (reused vs recomputed prefill tokens, prefill seconds
    saved), sketch health, and the ranked hot-prefix table."""
    base = _system_base(args)
    top_k = max(int(getattr(args, "top_k", 15) or 15), 1)
    doc = _get_json(base, f"/debug/kvcache?top_k={top_k}")
    prefixes = _get_json(base, f"/debug/kvcache/prefixes?k={top_k}")
    if args.json:
        print(json.dumps({"kvcache": doc, "prefixes": prefixes}, indent=2))
        return

    print(f"== kv reuse ({base}/debug/kvcache)")
    hits = doc.get("hits") or {}
    misses = doc.get("misses", 0)
    total = sum(hits.values()) + misses
    overall = (sum(hits.values()) / total) if total else 0.0
    per_tier = " ".join(
        f"{t}={r:.3f}" for t, r in (doc.get("hit_rate") or {}).items()
    )
    print(
        f"  hit rate {overall:.3f}  "
        f"(hits={sum(hits.values())} misses={misses}"
        f"{'; by tier: ' + per_tier if per_tier else ''})"
    )
    print(
        f"  prefill tokens  reused={doc.get('reused_prefill_tokens', 0)}  "
        f"recomputed={doc.get('recomputed_prefill_tokens', 0)}"
    )
    print(
        f"  prefill saved   {doc.get('prefill_seconds_saved', 0.0):.3f} s  "
        f"(cost/token {doc.get('prefill_cost_per_token_s', 0.0):.2e} s)"
    )
    sketch = doc.get("sketch") or {}
    print(
        f"  sketch          {sketch.get('tracked', 0)}/"
        f"{sketch.get('capacity', 0)} tracked  "
        f"replacements={sketch.get('replacements', 0)}  "
        f"half_life={sketch.get('half_life_s', 0.0):.0f}s"
    )
    tiers = doc.get("tiers") or {}
    for label, view in tiers.items():
        print(f"  [{label}]")
        for tier, stats in (view or {}).items():
            if not isinstance(stats, dict):
                continue
            detail = " ".join(
                f"{k}={stats[k]}" for k in
                ("blocks", "stored", "hits", "misses", "evicted")
                if k in stats
            )
            print(f"    {tier:<8} {detail}")
    rows = prefixes.get("prefixes") or []
    print(f"\n== hot prefixes (top {top_k}; {base}/debug/kvcache/prefixes)")
    if not rows:
        print("  (no tracked prefixes)")
    for row in rows:
        tier_mix = ",".join(
            f"{t}:{n}" for t, n in (row.get("tiers") or {}).items()
        )
        print(
            f"  {row.get('anchor', '?')}  score={row.get('score', 0.0):>10.2f} "
            f"(+/-{row.get('score_error', 0.0):.2f})  hits={row.get('hits', 0):>6} "
            f"tokens={row.get('tokens_from_cache', 0):>9} "
            f"age={row.get('age_s', 0.0):>7.1f}s  {tier_mix}"
        )


def main_observe_perf(args) -> None:
    """Pretty-print the perf ledger of a running worker: per-shape decode
    attribution (step p50/p99, host gap, dispatch/reap split, tok/s,
    roofline fraction), prefill tokens/s per chunk bucket, and the live
    sentinel's fingerprint verdicts — 'did this engine get slower than it
    used to be on this exact shape' in one command."""
    base = _system_base(args)
    doc = _get_json(base, "/debug/perf")
    if args.json:
        print(json.dumps(doc, indent=2))
        return

    ident = doc.get("identity") or {}
    print(
        f"== perf ledger ({base}/debug/perf)  "
        f"preset={ident.get('preset', '?')} "
        f"backend={ident.get('backend', '?')} host={ident.get('host', '?')}"
    )
    rows = doc.get("decode") or []
    if not rows:
        print("  (no decode samples yet)")
    else:
        print(
            f"  {'shape':<28} {'n':>5} {'step p50':>10} {'p99':>10} "
            f"{'gap p50':>9} {'disp':>8} {'reap':>8} {'tok/s':>9} "
            f"{'roofline':>8}"
        )
        for row in rows:
            shape = f"w{row.get('width')}/{row.get('variant')}/{row.get('path')}"
            frac = row.get("roofline_fraction")
            print(
                f"  {shape:<28} {row.get('samples', 0):>5} "
                f"{row.get('step_p50_s', 0.0) * 1e3:>8.2f}ms "
                f"{row.get('step_p99_s', 0.0) * 1e3:>8.2f}ms "
                f"{row.get('host_gap_p50_s', 0.0) * 1e3:>7.2f}ms "
                f"{row.get('dispatch_p50_s', 0.0) * 1e3:>6.2f}ms "
                f"{row.get('reap_p50_s', 0.0) * 1e3:>6.2f}ms "
                f"{row.get('toks_per_sec', 0.0):>9.1f} "
                f"{'' if frac is None else f'{frac:>7.1%}':>8}"
            )
    prefill = doc.get("prefill") or {}
    if prefill:
        print("  prefill tok/s by chunk bucket: " + "  ".join(
            f"{b}={v.get('toks_per_sec_p50', 0.0):.0f}" for b, v in prefill.items()))
    print(
        f"\n== sentinel  fingerprints_loaded={doc.get('fingerprints_loaded', 0)}  "
        f"anomalies_total={doc.get('anomalies_total', 0)}"
    )
    verdicts = doc.get("verdicts") or {}
    if not verdicts:
        print("  (no verdicts yet — sentinel has not evaluated)")
    for key, v in sorted(verdicts.items()):
        print(
            f"  {key:<40} {v.get('verdict', '?'):<12} "
            f"n={v.get('samples', 0)} "
            f"step_p50={v.get('step_p50_s', 0.0) * 1e3:.2f}ms "
            f"tok/s={v.get('toks_per_sec', 0.0):.1f}"
        )
        for anom in v.get("anomalies") or []:
            print(
                f"    ! {anom.get('kind')}  x{anom.get('ratio', 0.0):.3f} "
                f"(live {anom.get('live'):.6g} vs baseline "
                f"{anom.get('baseline'):.6g}, streak {anom.get('streak')})"
            )


def main_observe_device(args) -> None:
    """One-shot pretty snapshot of /debug/memory, /debug/compiles and
    /debug/flight from a running worker's system server — the operator's
    'what is the device plane doing right now' view without curl + jq."""
    base = _system_base(args)
    memory = _get_json(base, "/debug/memory")
    compiles = _get_json(base, "/debug/compiles")
    flight = _get_json(base, f"/debug/flight?limit={args.flight_limit}")
    if args.json:
        print(json.dumps({"memory": memory, "compiles": compiles, "flight": flight}, indent=2))
        return

    print(f"== device memory ({base}/debug/memory)")
    for source, cats in (memory.get("sources") or {}).items():
        print(f"  [{source}]")
        for category, nbytes in sorted(cats.items()):
            print(f"    {category:<16} {_fmt_bytes(nbytes):>12}")
    print(f"  ledger total       {_fmt_bytes(memory.get('ledger_total_bytes')):>12}")
    if "device_bytes_in_use" in memory:
        print(f"  device in use      {_fmt_bytes(memory['device_bytes_in_use']):>12}")
        print(f"  unaccounted        {_fmt_bytes(memory['unaccounted_bytes']):>12}")
    hwc = memory.get("host_weight_cache") or {}
    for tier, usage in hwc.items():
        print(
            f"  weight cache {tier:<5} {_fmt_bytes(usage.get('bytes')):>12}"
            f"  ({usage.get('entries', 0)} entries)"
        )

    print(f"\n== compiled programs ({base}/debug/compiles)")
    print(f"  {'program':<32} {'compiles':>8} {'sigs':>6} {'storms':>6} {'seconds':>9}")
    for name, st in (compiles.get("programs") or {}).items():
        print(
            f"  {name:<32} {st['compiles']:>8} {st['signatures']:>6} "
            f"{st['storms']:>6} {st['compile_seconds']:>9.2f}"
        )
    totals = compiles.get("totals") or {}
    print(
        f"  {'TOTAL':<32} {totals.get('compiles', 0):>8} "
        f"{totals.get('signatures', 0):>6} {totals.get('storms', 0):>6} "
        f"{totals.get('compile_seconds', 0.0):>9.2f}"
    )

    print(f"\n== flight recorder (newest {args.flight_limit}; {base}/debug/flight)")
    events = flight.get("events") or []
    if not events:
        print("  (no events)")
    for ev in events:
        extras = {k: v for k, v in ev.items() if k not in ("seq", "t_mono", "ring", "kind")}
        detail = " ".join(f"{k}={v}" for k, v in extras.items())
        print(
            f"  {ev.get('t_mono', 0):>14.3f} {ev.get('ring', '?'):<7} "
            f"{ev.get('kind', '?'):<12} {detail}"
        )


def main_observe(args) -> None:
    """The observe views (dynamo_tpu/cli/run.py main_observe)."""
    if args.what == "trajectory":
        main_observe_trajectory(args)
    elif args.what == "kvcache":
        main_observe_kvcache(args)
    elif args.what == "perf":
        main_observe_perf(args)
    else:
        main_observe_device(args)
