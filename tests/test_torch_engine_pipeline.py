"""The pipelined decode of TorchEngine (device="cpu", cuda_graphs=False)
against the JAX engine's (tests/test_decode_pipeline.py): greedy streams at
pipeline depth 2 are token-exact against JaxEngine at depth 2 and against
the port at depth 1, on a bf16-style miniature and on the int8 fused-layer
miniature (its plain version), through stops that fire inside a burst
while the next one is in flight, mid-stream admission, cancellation and
preemption by recompute. Then the pieces: steady-state ticks sync no slot
state, ``table_width_bucket`` is the JAX function, ``cache_write_index``
keeps its shapes whatever the data and its pools stay bit-equal to JAX's,
``decode_burst`` is ``decode_multi`` plus the carry, and cuda_graphs=True
on the CPU raises."""

import asyncio
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.engines.tpu.engine import table_width_bucket as jax_bucket
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.quantize import quantize_params
from dynamo_tpu.ops import attention as jattn
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs, table_width_bucket
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.runtime import context as tcontext

JAX = types.SimpleNamespace(proto=jproto, Context=jcontext.Context)
TORCH = types.SimpleNamespace(proto=tproto, Context=tcontext.Context)
ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=96,
            prefill_chunk=32, decode_steps=4)
# The int8 miniature the fused layer takes (tests/test_torch_engine_int8.py).
INT8_CFG = dict(name="int8-mini", d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
                vocab_size=512, head_dim=128, rope_theta=10000.0)


@pytest.fixture(scope="module")
def bf16_weights():
    jc = jconfig.tiny_config()
    params = jllama.init_params(jc, jax.random.PRNGKey(7))
    return jc, tconfig.tiny_config(), params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def int8_weights():
    jc = jconfig.ModelConfig(**INT8_CFG, dtype=jnp.bfloat16)
    q, _ = quantize_params(jllama.init_params(jc, jax.random.PRNGKey(3)))
    return jc, tconfig.ModelConfig(**INT8_CFG), q, jax.tree.map(np.asarray, q)


def _torch_engine(weights, depth, int8=False, **over):
    _, tc, _, tree = weights
    quant = dict(quantization="int8", use_megakernel=True) if int8 else {}
    return TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                       pipeline_depth=depth, **quant, **{**ARGS, **over}),
                       params=params_from_jax(tree, tc, "cpu"))


def _jax_engine(weights, depth, int8=False, **over):
    jc, _, params, _ = weights
    quant = dict(quantization="int8", use_megakernel=False) if int8 else {}
    return JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=depth, **quant,
                                   **{**ARGS, **over}), params=params)


def _req(api, prompt, max_tokens=8, eos=(), temperature=0.0):
    p = api.proto
    return p.PreprocessedRequest(
        token_ids=[int(t) for t in prompt], request_id="r",
        sampling=p.SamplingOptions(temperature=temperature),
        stop=p.StopConditions(max_tokens=max_tokens), eos_token_ids=list(eos),
    )


async def _one(engine, api, prompt, cancel_after=None, on_token=None, **kw):
    ctx = api.Context()
    toks, reason = [], None
    async for out in engine.generate(_req(api, prompt, **kw), ctx):
        assert out.error is None, out.error
        toks += out.token_ids
        reason = out.finish_reason
        if on_token is not None and out.token_ids:
            on_token(len(toks))
        if cancel_after is not None and len(toks) >= cancel_after:
            ctx.stop_generating()
    return toks, reason.value


async def _settle(engine):
    """Wait (at most 5 s) for the bursts still in flight after the last
    stream ended to be reaped: every dispatched burst (eager here) read."""
    for _ in range(500):
        if not engine.stats()["inflight_bursts"] and engine.steps == engine.runner.eager_bursts:
            return
        await asyncio.sleep(0.01)
    raise AssertionError("bursts stayed in flight")


PROMPTS = [list(np.random.default_rng(20 + i).integers(3, 500, n)) for i, n in
           enumerate((10, 37, 9, 14))]


async def _scenarios(engine, api):
    """Staggered max_tokens (rows finish inside bursts while the next burst
    is in flight), an EOS inside a burst, and max_tokens=1."""
    try:
        out = {"batch": await asyncio.gather(*(
            _one(engine, api, p, max_tokens=n) for p, n in zip(PROMPTS, (11, 9, 15, 6))))}
        probe = out["batch"][2][0]
        out["eos"] = await _one(engine, api, PROMPTS[2], max_tokens=40, eos=[probe[5]])
        out["one"] = await _one(engine, api, PROMPTS[3], max_tokens=1)
        if api is TORCH:
            await _settle(engine)
        out["steps"] = engine.steps
        return out
    finally:
        await engine.stop()


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8-fused"])
async def test_depth2_streams_match_jax_depth2_and_port_depth1(bf16_weights, int8_weights, int8):
    weights = int8_weights if int8 else bf16_weights
    want = await _scenarios(_jax_engine(weights, 2, int8), JAX)
    deep = _torch_engine(weights, 2, int8)
    got2 = await _scenarios(deep, TORCH)
    got1 = await _scenarios(_torch_engine(weights, 1, int8), TORCH)
    for key in ("batch", "eos", "one"):
        assert got2[key] == want[key] == got1[key], key
    assert got2["eos"][1] == "eos" and got2["eos"][0][-1] == got2["batch"][2][0][5]
    assert [len(t) for t, _ in got2["batch"]] == [11, 9, 15, 6]
    # At depth 2 a burst was still in flight when each stream ended: those
    # bursts were reaped with their rows dropped.
    assert got2["steps"] > got1["steps"]
    stats = deep.stats()
    assert stats["pipeline_depth"] == 2 and stats["inflight_bursts"] == 0
    assert stats["decode_graphs"] == 0 and stats["eager_bursts"] == got2["steps"]
    assert stats["nonfinite_logit_rows"] == 0
    assert (stats["mk_fused_bursts"] > 0) == int8


async def test_stop_inside_a_burst_drops_the_rows_of_the_burst_in_flight(bf16_weights):
    """EOS on the second token of the second burst: at depth 2 the third
    burst is already in flight when the stop is reaped; its row is dropped
    and the stream ends exactly where depth 1 (and JAX) end it."""
    full, _ = await _one(_torch_engine(bf16_weights, 1), TORCH, PROMPTS[0], max_tokens=30)
    eos = full[6]  # prefill gives token 0, bursts of 4 give 1-4, 5-8
    streams = []
    for depth in (1, 2):
        engine = _torch_engine(bf16_weights, depth)
        try:
            streams.append(await _one(engine, TORCH, PROMPTS[0], max_tokens=30, eos=[eos]))
            await _settle(engine)
            streams.append(engine.steps)
        finally:
            await engine.stop()
    jax_engine = _jax_engine(bf16_weights, 2)
    try:
        want = await _one(jax_engine, JAX, PROMPTS[0], max_tokens=30, eos=[eos])
    finally:
        await jax_engine.stop()
    first = full.index(eos)
    assert first >= 1
    assert streams[0] == streams[2] == want == (full[: first + 1], "eos")
    assert streams[3] == streams[1] + 1  # the dropped burst


async def test_midstream_admission_while_a_burst_is_in_flight(bf16_weights):
    """Request b arrives while a decodes (a burst in flight at depth 2):
    the pipeline drains, b is admitted, and both streams equal depth 1's."""

    async def run(depth):
        engine = _torch_engine(bf16_weights, depth, max_num_seqs=2)
        seen = {"inflight": None}
        started = asyncio.Event()

        def on_token(n):
            if n >= 3 and not started.is_set():
                seen["inflight"] = len(engine._inflight)
                started.set()

        async def b():
            await started.wait()
            return await _one(engine, TORCH, PROMPTS[1], max_tokens=10)

        try:
            a_out, b_out = await asyncio.gather(
                _one(engine, TORCH, PROMPTS[0], max_tokens=24, on_token=on_token), b())
        finally:
            await engine.stop()
        return (a_out, b_out), seen["inflight"]

    (streams1, _), (streams2, inflight2) = await run(1), await run(2)
    assert inflight2 >= 1, "no burst was in flight when b arrived"
    assert streams1 == streams2
    assert [len(t) for t, _ in streams2] == [24, 10]


async def test_cancellation_at_depth2(bf16_weights):
    engine = _torch_engine(bf16_weights, 2)
    try:
        full = await _one(engine, TORCH, PROMPTS[1], max_tokens=30)
        toks, reason = await _one(engine, TORCH, PROMPTS[1], max_tokens=30, cancel_after=6)
        assert reason == "cancelled" and 6 <= len(toks) < 30 and toks == full[0][: len(toks)]
        # the engine goes on serving, and the cancelled stream's blocks came back
        again = await _one(engine, TORCH, PROMPTS[1], max_tokens=30)
        assert again == full
        await _settle(engine)
        assert engine.pool.free_blocks == engine.args.num_kv_blocks
        assert not any(engine._slots) and not engine._inflight
    finally:
        await engine.stop()


async def test_preemption_by_recompute_at_depth2(bf16_weights):
    """A pool of 8 blocks of 4: decode growth preempts a sequence at the
    same reap boundary at both depths (two-burst lookahead, drain before
    preempting), and it recomputes to the same stream, as JAX's."""
    over = dict(max_num_seqs=2, num_kv_blocks=8, max_model_len=64)
    prompts = [list(range(10, 18)), list(range(20, 28))]

    async def run(engine, api, temps=(0.0, 0.0)):
        try:
            outs = await asyncio.gather(*(
                _one(engine, api, p, max_tokens=n, temperature=t)
                for p, n, t in zip(prompts, (14, 18), temps)))
            return outs, engine.preemptions
        finally:
            await engine.stop()

    want, _ = await run(_jax_engine(bf16_weights, 2, **over), JAX)
    got1, pre1 = await run(_torch_engine(bf16_weights, 1, **over), TORCH)
    got2, pre2 = await run(_torch_engine(bf16_weights, 2, **over), TORCH)
    assert pre1 > 0 and pre1 == pre2, "scenario no longer preempts"
    assert got2 == got1 == want
    # a sampled row recomputes the same noise (keyed by position)
    s1, _ = await run(_torch_engine(bf16_weights, 1, **over), TORCH, (0.0, 0.8))
    s2, _ = await run(_torch_engine(bf16_weights, 2, **over), TORCH, (0.0, 0.8))
    assert s1 == s2


async def test_steady_state_ticks_move_zero_host_state(bf16_weights):
    """The first dispatch syncs the installed slot and its table; after
    that, bursts run from the device carry with no sync between them."""
    engine = _torch_engine(bf16_weights, 2, block_size=32, num_kv_blocks=8, max_model_len=64)
    try:
        toks, _ = await _one(engine, TORCH, PROMPTS[3][:4], max_tokens=14)
        assert len(toks) == 14
    finally:
        await engine.stop()
    kinds = [k for k, _ in engine.runner.transfer_log]
    first = kinds.index("decode")
    assert "slot_sync" in kinds[:first] and "table_sync" in kinds[:first]
    best = run = 0
    for k in kinds:
        run = run + 1 if k == "decode" else 0
        best = max(best, run)
    assert best >= 2, f"no pure-dispatch steady state: {kinds}"
    assert engine.runner.transfer_log[first] == ("decode", 1)  # a bucket of one 32-slot page


def test_table_width_bucket_is_the_jax_function():
    for cap in (1, 3, 8, 24, 128, 512):
        for max_blocks in (0, 1, 2, 3, 5, 8, 9, 23, 24, 25, 100, 600):
            assert table_width_bucket(max_blocks, cap) == jax_bucket(max_blocks, cap)


def _pool(NB, BS, KH, D, rng, int8):
    if int8:
        return {"q8": rng.integers(-127, 128, (NB, BS, KH, D)).astype(np.int8),
                "s": rng.random((NB, KH, BS)).astype(np.float32)}
    return rng.standard_normal((NB, BS, KH, D)).astype(np.float32)


def _to(pool, f):
    return {k: f(v) for k, v in pool.items()} if isinstance(pool, dict) else f(pool)


WRITE_CASES = [
    # tables, start, lens (C 6, capacity 8): dropped rows on kept rows'
    # slots (row 2's padding runs onto block 0, which row 0 writes; row 1's
    # positions past capacity clamp onto its own block 10); padding and
    # capacity apart; nothing kept at all
    ([[0, 7], [1, 10], [5, 0]], [0, 5, 1], [3, 6, 2]),
    ([[3, 7], [1, 10], [5, 0]], [0, 5, 6], [4, 6, 1]),
    ([[3, 7], [1, 10], [5, 0]], [8, 9, 0], [2, 3, 0]),
]


@pytest.mark.parametrize("sink", [False, True], ids=["no-sink", "sink"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", range(len(WRITE_CASES)))
def test_cache_write_index_fixed_shapes_and_pools_equal_jax(case, int8, sink):
    """The index's shape follows from B and C alone, and every dropped
    position points at the sink slot NB·BS. Into a pool with its sink
    block (ops/attention.copy_to_sink_pool, as init_kv_cache lays pools),
    the write is bit-equal to JAX's ``mode="drop"`` scatter on the NB
    blocks, so no dropped row changed a byte there; a pool without one is
    refused and left as it was."""
    rng = np.random.default_rng(9 + case)
    NB, BS, KH, D, C = 12, 4, 2, 8, 6
    tables, start, lens = (np.asarray(a, np.int32) for a in WRITE_CASES[case])
    chunk = (rng.standard_normal((3, C, KH, D)) * 3).astype(np.float32)
    pool = _pool(NB, BS, KH, D, rng, int8)
    index = tattn.cache_write_index(torch.from_numpy(tables), torch.from_numpy(start),
                                    torch.from_numpy(lens), C, BS, NB)
    assert tuple(index.shape) == (3 * C,) and index.dtype == torch.int64
    pos = start[:, None] + np.arange(C)[None]
    kept = ((np.arange(C)[None] < lens[:, None]) & (pos < tables.shape[1] * BS)).reshape(-1)
    assert ((index.numpy() == NB * BS) == ~kept).all() and kept.any() == (case != 2)
    args = (torch.from_numpy(chunk), torch.from_numpy(tables), torch.from_numpy(start),
            torch.from_numpy(lens), index)
    if not sink:
        target = _to(pool, lambda a: torch.from_numpy(a.copy()))
        with pytest.raises(ValueError, match="no sink block"):
            tattn.write_chunk_to_cache(target, *args)
        for k in (("q8", "s") if int8 else (None,)):
            np.testing.assert_array_equal((target[k] if k else target).numpy(),
                                          pool[k] if k else pool)
        return
    want = jax.block_until_ready(jattn.write_chunk_to_cache(
        _to(pool, jnp.asarray), jnp.asarray(chunk), jnp.asarray(tables), jnp.asarray(start),
        jnp.asarray(lens)))
    got = tattn.write_chunk_to_cache(tattn.copy_to_sink_pool(_to(pool, torch.from_numpy)), *args)
    if int8:
        for k in ("q8", "s"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == 2:  # every row dropped: not a byte changed
        for k in (("q8", "s") if int8 else (None,)):
            np.testing.assert_array_equal((got[k] if k else got).numpy(), pool[k] if k else pool)


def test_decode_burst_is_decode_multi_plus_the_carry(bf16_weights):
    """decode_burst over a slot state: the same tokens and finite flags as
    decode_multi on the same inputs, the carry written back (last token,
    pos + steps on active rows, inactive rows untouched), the same pools."""
    _, tc, _, tree = bf16_weights
    params = params_from_jax(tree, tc, "cpu")
    S, K, BS, P = 3, 4, 4, 6
    rng = np.random.default_rng(3)
    pos = np.array([9, 0, 14], np.int32)
    active = np.array([1, 0, 1], np.int32)
    tables = rng.permutation(S * P).reshape(S, P).astype(np.int32)
    state = {
        "tokens": torch.tensor([5, 0, 77]), "pos": torch.from_numpy(pos.copy()),
        "active": torch.from_numpy(active), "temp": torch.tensor([0.0, 1.0, 0.7]),
        "topk": torch.tensor([0, 0, 20], dtype=torch.int32), "topp": torch.tensor([1.0, 1.0, 0.9]),
        "salts": torch.tensor([3, 4, 5]), "tables": torch.from_numpy(tables),
    }
    for name, dtype in tllama.SLOT_STATE.items():
        state[name] = state[name].to(dtype)

    def pools():
        g = torch.Generator().manual_seed(1)
        k, v = tllama.init_kv_cache(tc, S * P, BS, "cpu")
        for p in k + v:
            p.copy_(torch.randn(p.shape, generator=g))
        return k, v

    k1, v1 = pools()
    ref = tllama.decode_multi(params, tc, state["tokens"].clone(), state["pos"].clone(),
                              state["active"], state["tables"][:, :5].contiguous(), k1, v1, 11,
                              state["temp"], state["topk"], state["topp"], num_steps=K,
                              salts=state["salts"])
    k2, v2 = pools()
    out_t, out_f = torch.zeros(S, K, dtype=torch.int64), torch.zeros(S, dtype=torch.bool)
    tllama.decode_burst(params, tc, state, k2, v2, 11, out_t, out_f, num_steps=K, width=5)
    assert torch.equal(out_t, ref.tokens) and torch.equal(out_f, ref.finite)
    assert torch.equal(state["tokens"], ref.tokens[:, -1])
    assert state["pos"].tolist() == [9 + K, 0, 14 + K] and state["tokens"][1] == 0
    assert all(torch.equal(a, b) for a, b in zip(k1 + v1, k2 + v2))


def test_cuda_graphs_on_the_cpu_raises(bf16_weights):
    _, tc, _, _ = bf16_weights
    with pytest.raises(ValueError, match="cuda_graphs=True needs a CUDA device"):
        TorchEngine(TorchEngineArgs(config=tc, device="cpu", **ARGS))
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        engine = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, **ARGS))
        engine.runner.args.cuda_graphs = True
        engine.runner.decode_dispatch(1)


def test_captured_call_counts_launches_per_replay_and_raises_on_a_failed_capture(monkeypatch):
    """ops/cuda/graphs.CapturedCall with the capture stubbed (there is no
    card here): the capture counts no launch, each replay adds the
    capture's; a capture that raises raises, with the counts as they were."""
    import contextlib

    from dynamo_tpu_torch.ops.cuda import graphs, paged_attention

    class Graph:
        def replay(self):
            pass

    @contextlib.contextmanager
    def capture(graph, pool=None, stream=None):
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    paged_attention.reset_launch_counts()
    counts = paged_attention.launch_counts

    def three_launches():
        counts["paged_attention_decode"] += 3

    call = graphs.CapturedCall(three_launches, pool=None, stream=None)
    assert counts["paged_attention_decode"] == 0 and call.launches == 3
    call.replay()
    call.replay()
    assert counts["paged_attention_decode"] == 6 and call.replays == 2

    def refused():
        counts["paged_attention_decode"] += 1
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        graphs.CapturedCall(refused, pool=None, stream=None)
    assert counts["paged_attention_decode"] == 6
    paged_attention.reset_launch_counts()


async def test_a_failed_capture_fails_the_streams_instead_of_running_eagerly(bf16_weights):
    """With graphs on, a burst whose capture fails ends every stream with
    the error; the burst is never run eagerly instead."""
    engine = _torch_engine(bf16_weights, 2)
    engine.args.cuda_graphs = True  # the CPU check is past: stand in for the card

    def refused(nb):
        raise RuntimeError("CUDA graph capture failed: operation not permitted")

    engine.runner._replay_or_capture = refused
    try:
        outs = [o async for o in engine.generate(_req(TORCH, PROMPTS[0]), TORCH.Context())]
        assert outs[-1].finish_reason.value == "error" and "capture failed" in outs[-1].error
        assert engine.runner.eager_bursts == 0 and engine.steps == 0
    finally:
        await engine.stop()
