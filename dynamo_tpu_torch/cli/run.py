"""``python -m dynamo_tpu_torch.cli run``: drive the port's engine without a
cluster — the counterpart of ``dynamo_tpu.cli run`` (dynamo_tpu/cli/run.py).

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
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
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
