"""Time to first token and inter-token latency of TorchEngine on chip_smoke.py's
engine request set, for side-by-side runs of two checkouts of the port.

    python3 dynamo_tpu_torch/tools/serve_ttft.py --root DIR [--reps 3]
        [--engine-args '{"pipeline_depth": 1, "cuda_graphs": false}']

Serves Qwen2.5-0.5B at full width (random bf16 weights, seed 0) with the
``dynamo_tpu_torch`` package found under ``--root``, so an older checkout
unpacked beside this one runs the same load through its own engine. The
load is the engine phase's: two prompts sharing a 256-token prefix (the
second sent once the first streams), five of 100-300 tokens and one of
1,200, each for 64 greedy tokens. One warm-up round, then ``--reps``
rounds, each with fresh prompts of the same lengths (no prefix hit but the
shared one). ``--engine-args`` are TorchEngineArgs fields the checkout's
engine takes. Prints one JSON line a round and a summary line (medians).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

LENGTHS = [100, 140, 180, 230, 300, 1200]
MAX_TOKENS = 64


async def _serve(engine, prompts, shared):
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.runtime.context import Context

    async def one(p, streaming=None):
        t0, stamps, n = time.monotonic(), [], 0
        req = PreprocessedRequest(token_ids=p, sampling=SamplingOptions(temperature=0.0),
                                  stop=StopConditions(max_tokens=MAX_TOKENS))
        async for out in engine.generate(req, Context()):
            if out.error:
                raise RuntimeError(out.error)
            if out.token_ids:
                stamps.append(time.monotonic())
                n += len(out.token_ids)
                if streaming is not None:
                    streaming.set()
        return t0, stamps, n

    async def after(event, p):
        await event.wait()
        return await one(p)

    ev = asyncio.Event()
    t_start = time.monotonic()
    results = await asyncio.gather(one(shared[0], ev), after(ev, shared[1]),
                                   *[one(p) for p in prompts])
    return results, time.monotonic() - t_start


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout whose dynamo_tpu_torch serves")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--engine-args", default="{}", help="JSON of TorchEngineArgs fields")
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("serve_ttft: no CUDA device", file=sys.stderr)
        return 2
    import dynamo_tpu_torch
    from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
    from dynamo_tpu_torch.models.config import qwen2_500m_config

    if not os.path.abspath(dynamo_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"dynamo_tpu_torch came from {dynamo_tpu_torch.__file__}, not {root}")
    extra = json.loads(a.engine_args)
    cfg = qwen2_500m_config()
    engine = TorchEngine(TorchEngineArgs(
        config=cfg, block_size=16, num_kv_blocks=2048, max_num_seqs=16, max_model_len=2048,
        prefill_chunk=512, seed=0, device="cuda", **extra))
    g = torch.Generator().manual_seed(11)

    def rand(n):
        return torch.randint(10, cfg.vocab_size, (n,), generator=g).tolist()

    rounds = []

    async def run():
        try:
            for rep in range(a.reps + 1):  # round 0 warms up
                prefix = rand(256)
                shared = [prefix + rand(40), prefix + rand(70)]
                results, wall = await _serve(engine, [rand(n) for n in LENGTHS], shared)
                ttft = [stamps[0] - t0 for t0, stamps, _ in results]
                itl = [(stamps[-1] - stamps[0]) / max(n - 1, 1) for _, stamps, n in results]
                line = {"what": "serve_ttft", "label": a.label, "round": rep,
                        "warm_up": rep == 0, "engine_args": extra,
                        "ttft_ms_mean": 1e3 * sum(ttft) / len(ttft),
                        "ttft_ms_max": 1e3 * max(ttft),
                        "ttft_ms": [1e3 * t for t in ttft],
                        "itl_ms_mean": 1e3 * sum(itl) / len(itl), "wall_s": wall,
                        "output_tok_per_s": sum(n for _, _, n in results) / wall}
                print(json.dumps(line), flush=True)
                if rep:
                    rounds.append(line)
        finally:
            await engine.stop()

    asyncio.run(run())

    def median(k):
        v = sorted(r[k] for r in rounds)
        return v[len(v) // 2]

    print(json.dumps({"what": "serve_ttft_summary", "label": a.label, "root": root,
                      "engine_args": extra, "rounds": len(rounds),
                      **{k: median(k) for k in ("ttft_ms_mean", "ttft_ms_max", "itl_ms_mean",
                                                "wall_s", "output_tok_per_s")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
