"""TorchEngine served across the runtime's planes, as a worker serves it:
``TorchEngine(device="cpu", cuda_graphs=False)`` on the tiny preset behind
the port's TCP request plane and the port's discd, against the same engine
in-process and against JaxEngine served over JAX's planes on the same
weights (params_from_jax); a JAX client reading the port-served engine; a
cancel that frees the worker's slot; the worker runtime shut down
mid-stream; ``python -m dynamo_tpu_torch.discd`` with msgpack, zmq,
aiohttp, jax and dynamo_tpu blocked."""

import asyncio
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu.runtime.discovery.discd import DiscdDiscovery as JDiscdDiscovery
from dynamo_tpu.runtime.discovery.discd import DiscdServer as JDiscdServer
from dynamo_tpu.runtime.distributed import DistributedRuntime as JRuntime
from dynamo_tpu.runtime.network.tcp import TcpRequestPlane as JTcpRequestPlane
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.runtime import context as tcontext
from dynamo_tpu_torch.runtime.discovery.discd import DiscdDiscovery, DiscdServer
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.network.tcp import StreamDisconnectedError, TcpRequestPlane

ROOT = Path(__file__).resolve().parents[1]
ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            prefill_chunk=32, decode_steps=4)
PROMPTS = [[int(t) for t in np.random.default_rng(i).integers(3, 500, n)]
           for i, n in enumerate((12, 70, 9, 33, 20))]  # 70 > prefill_chunk
WAIT = 30.0
# BackendOutput fields that carry no timing: the items compared across packages
FIELDS = ("token_ids", "finish_reason", "cumulative_tokens", "logprobs",
          "disaggregated_params", "error", "error_kind", "extra")


@pytest.fixture(scope="module")
def weights():
    jc = jconfig.tiny_config()
    params = jllama.init_params(jc, jax.random.PRNGKey(5))
    return jc, params, jax.tree.map(np.asarray, params)


def _torch_engine(weights):
    _, _, tree = weights
    tc = tconfig.tiny_config()
    return TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, **ARGS),
                       params=params_from_jax(tree, tc, "cpu"))


def _jax_engine(weights):
    jc, params, _ = weights
    return JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=1, **ARGS), params=params)


def _request(proto, prompt, max_tokens=12):
    return proto.PreprocessedRequest(
        token_ids=list(prompt), request_id="r",
        sampling=proto.SamplingOptions(temperature=0.0),
        stop=proto.StopConditions(max_tokens=max_tokens),
    ).to_dict()


async def _in_process(engine, proto, context):
    async def one(prompt):
        out = []
        async for item in engine.generate(_request(proto, prompt), context.Context()):
            out.append(item.to_dict())
        return out

    return await asyncio.gather(*(one(p) for p in PROMPTS))


async def _over_client(client, proto, context):
    async def one(prompt):
        return [item async for item in client.generate(_request(proto, prompt),
                                                       context.Context())]

    return await asyncio.wait_for(asyncio.gather(*(one(p) for p in PROMPTS)), WAIT)


class _Cluster:
    """A discd server and a worker runtime serving ``engine`` on
    dynamo/backend/generate over TCP, from one package."""

    def __init__(self, server_cls, runtime_cls, discd_cls, tcp_cls):
        self.server_cls, self.runtime_cls = server_cls, runtime_cls
        self.discd_cls, self.tcp_cls = discd_cls, tcp_cls

    async def start(self, engine):
        self.server = self.server_cls()
        self.port = await self.server.start()
        self.worker = self.runtime(self)
        self.served = await (self.worker.namespace("dynamo").component("backend")
                             .endpoint("generate").serve_endpoint(engine.generate))
        return self

    def runtime(self, pkg):
        return pkg.runtime_cls(discovery=pkg.discd_cls(f"127.0.0.1:{self.port}"),
                               request_plane=pkg.tcp_cls())

    async def client(self, pkg):
        rt = self.runtime(pkg)
        client = await rt.namespace("dynamo").component("backend").endpoint("generate").client()
        await client.wait_for_instances(timeout=WAIT)
        return rt, client

    async def stop(self):
        await self.worker.shutdown(grace_period=1)
        await self.server.stop()


PORT = _Cluster(DiscdServer, DistributedRuntime, DiscdDiscovery, TcpRequestPlane)
JAX = _Cluster(JDiscdServer, JRuntime, JDiscdDiscovery, JTcpRequestPlane)


def _ids(streams):
    return [([t for item in s for t in item["token_ids"]], s[-1]["finish_reason"])
            for s in streams]


def _untimed(streams):
    return [[{k: item[k] for k in FIELDS} for item in s] for s in streams]


async def test_served_streams_equal_in_process_and_jax_served(weights):
    local = _torch_engine(weights)
    try:
        want = await _in_process(local, tproto, tcontext)
    finally:
        await local.stop()

    served = _torch_engine(weights)
    port = await PORT.start(served)
    try:
        rt, client = await port.client(PORT)
        jrt, jclient = await port.client(JAX)  # a JAX frontend on the port's cluster
        try:
            got = await _over_client(client, tproto, tcontext)
            got_by_jax = await _over_client(jclient, jproto, jcontext)
        finally:
            await client.close()
            await jclient.close()
            await rt.shutdown(grace_period=1)
            await jrt.shutdown(grace_period=1)
    finally:
        await port.stop()
        await served.stop()

    jengine = _jax_engine(weights)
    jax_cluster = await JAX.start(jengine)
    try:
        jrt, jclient = await jax_cluster.client(JAX)
        try:
            jax_served = await _over_client(jclient, jproto, jcontext)
        finally:
            await jclient.close()
            await jrt.shutdown(grace_period=1)
    finally:
        await jax_cluster.stop()
        await jengine.stop()

    assert _ids(got) == _ids(want)
    assert all(len(ids) == 12 and reason == "length" for ids, reason in _ids(got))
    assert _untimed(got) == _untimed(want)  # item for item, as in-process
    assert _ids(got) == _ids(jax_served)
    assert _untimed(got_by_jax) == _untimed(jax_served)


async def _stream_until(client, proto, context, n_items, *, max_tokens=100):
    """Start a long greedy stream; return (task, ctx, items) once ``n_items``
    items arrived."""
    ctx = context.Context()
    items = []
    arrived = asyncio.Event()

    async def consume():
        async for item in client.generate(_request(proto, PROMPTS[0], max_tokens), ctx):
            items.append(item)
            if len(items) >= n_items:
                arrived.set()

    task = asyncio.ensure_future(consume())
    done, _ = await asyncio.wait({task, asyncio.ensure_future(arrived.wait())},
                                 timeout=WAIT, return_when=asyncio.FIRST_COMPLETED)
    assert arrived.is_set(), "the stream never started"
    return task, ctx, items


async def _slots_free(engine):
    async def idle():
        while engine.stats()["active_seqs"] or engine.stats()["waiting"]:
            await asyncio.sleep(0.01)

    await asyncio.wait_for(idle(), WAIT)


async def test_cancel_frees_the_workers_slot(weights):
    served = _torch_engine(weights)
    port = await PORT.start(served)
    try:
        rt, client = await port.client(PORT)
        try:
            task, ctx, items = await _stream_until(client, tproto, tcontext, 2)
            ctx.stop_generating()
            await asyncio.wait_for(task, WAIT)
            await _slots_free(served)
            ids = [t for item in items for t in item["token_ids"]]
            assert 2 <= len(ids) < 100
            assert served.stats()["active_seqs"] == 0
        finally:
            await client.close()
            await rt.shutdown(grace_period=1)
    finally:
        await port.stop()
        await served.stop()


async def test_worker_shutdown_mid_stream_raises_stream_disconnected(weights):
    served = _torch_engine(weights)
    port = await PORT.start(served)
    try:
        rt, client = await port.client(PORT)
        try:
            task, _, items = await _stream_until(client, tproto, tcontext, 1)
            await port.worker.shutdown(grace_period=0)
            with pytest.raises(StreamDisconnectedError):
                await asyncio.wait_for(task, WAIT)
            assert 1 <= len(items) and not items[-1]["finish_reason"]
            await _slots_free(served)  # the server side stopped the sequence
        finally:
            await client.close()
            await rt.shutdown(grace_period=1)
    finally:
        await port.server.stop()
        await served.stop()


_DISCD_BLOCKED = r"""
import importlib.abc, runpy, sys
sys.path.insert(0, {root!r})
BLOCKED = ("msgpack", "zmq", "aiohttp", "jax", "jaxlib", "dynamo_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.argv = ["discd", "--port", "0", "--xsub", "0", "--xpub", "0",
            "--events-log", {log!r}, "--replay-port", "0"]
runpy.run_module("dynamo_tpu_torch.discd", run_name="__main__")
"""


def test_discd_main_runs_without_msgpack_zmq_aiohttp_jax(tmp_path):
    code = _DISCD_BLOCKED.format(root=str(ROOT), log=str(tmp_path / "events.log"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
    try:
        line = proc.stdout.readline()  # blocks until the ready line or exit
        assert line.startswith("discd ready: discovery 127.0.0.1:"), (
            line, proc.poll(), proc.stderr.read() if proc.poll() is not None else "")
        assert ", events 127.0.0.1:" in line and ", replay :" in line
        assert proc.poll() is None
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
