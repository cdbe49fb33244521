"""The KV wire v2 (dynamo_tpu_torch/disagg/wire.py) and the KV block
movement under it (engines/gpu/runner.py's gather and scatter,
TorchEngine's export and import) against the JAX package on the CPU:

- ``pack_array`` / ``pack_kv``: the same bytes, shapes and dtype tags as
  JAX's for bf16, f16, f32 and int8 payloads, and a chunk packed (and put
  through msgpack) by either package unpacks in the other;
- ``wire_block_bytes`` = JAX's for every preset and wire dtype;
- the interop matrix at the ops level: pools filled by the cache write,
  gathered, packed, unpacked and scattered into a pool of each form give
  pools equal to JAX's for the same cell (REQUANT_*), and attention over them
  within 0.06 of attention over the never-exported source (JAX's limit);
- engines: ``TorchEngine(device="cpu", cuda_graphs=False)`` export ->
  import across the four pool cells: same-dtype pools bit-exact and the
  greedy continuation the exporter's; cross cells equal to what
  ``JaxEngine`` installs from the same wire (bit-equal, but a
  requantization within an ulp and a code step, REQUANT_*) and the same
  greedy stream as JAX's importer;
- a scatter writes into the pools in place: each pool tensor, its storage
  and its ``.sink_full`` are the ones the engine was built with.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.disagg import wire as jwire
from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu.runtime.engine import collect as jcollect
from dynamo_tpu.tokens.blocks import compute_block_hashes as jhashes
from dynamo_tpu_torch.disagg import wire as twire
from dynamo_tpu_torch.engines.gpu import runner as trunner
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.ops import attention as tattn
from dynamo_tpu_torch.runtime.context import Context as TContext
from dynamo_tpu_torch.runtime.engine import collect as tcollect
from dynamo_tpu_torch.runtime.network import msgpack_lite
from dynamo_tpu_torch.tokens.blocks import compute_block_hashes

DTYPES = {"bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
          "float16": (np.float16, torch.float16),
          "float32": (np.float32, torch.float32),
          "int8": (np.int8, torch.int8)}


def _values(shape, tag, seed=0):
    """The same values in both packages: (numpy array, torch tensor)."""
    rng = np.random.default_rng(seed)
    if tag == "int8":
        a = rng.integers(-127, 128, shape).astype(np.int8)
        return a, torch.from_numpy(a.copy())
    f = (rng.standard_normal(shape) * 3).astype(np.float32)
    np_dtype, t_dtype = DTYPES[tag]
    return f.astype(np_dtype), torch.from_numpy(f).to(t_dtype)


def _same_array(jd, td):
    assert bytes(jd["b"]) == bytes(td["b"])
    assert jd["shape"] == td["shape"] and jd["dtype"] == td["dtype"]


@pytest.mark.parametrize("tag", sorted(DTYPES))
def test_pack_array_bytes_shapes_tags_equal_jax(tag):
    a, t = _values((3, 2, 4, 2, 8), tag)
    _same_array(jwire.pack_array(a), twire.pack_array(t))
    assert twire.packed_nbytes(twire.pack_array(t)) == jwire.packed_nbytes(jwire.pack_array(a))


def _wires(quantized, dense_tag="bfloat16", n=3, L=2, BS=4, KH=2, D=8, seed=1):
    """One chunk in each package's KvWireBlocks, from the same values."""
    shape = (n, L, BS, KH, D)
    if not quantized:
        (jk, tk), (jv, tv) = _values(shape, dense_tag, seed), _values(shape, dense_tag, seed + 1)
        return jwire.KvWireBlocks.dense(jk, jv), twire.KvWireBlocks.dense(tk, tv)
    (jk, tk), (jv, tv) = _values(shape, "int8", seed), _values(shape, "int8", seed + 1)
    sk = np.random.default_rng(seed + 2).random((n, L, KH, BS)).astype(np.float32)
    sv = np.random.default_rng(seed + 3).random((n, L, KH, BS)).astype(np.float32)
    return (jwire.KvWireBlocks(dtype="int8", k=jk, v=jv, k_scale=sk, v_scale=sv),
            twire.KvWireBlocks(dtype="int8", k=tk, v=tv, k_scale=torch.from_numpy(sk.copy()),
                               v_scale=torch.from_numpy(sv.copy())))


WIRE_CASES = [pytest.param(False, "bfloat16", id="bf16"),
              pytest.param(False, "float32", id="f32"),
              pytest.param(True, None, id="int8")]


@pytest.mark.parametrize("quantized,dense_tag", WIRE_CASES)
def test_pack_kv_equal_jax(quantized, dense_tag):
    jw, tw = _wires(quantized, dense_tag or "bfloat16")
    jd, td = jwire.pack_kv(jw), twire.pack_kv(tw)
    assert sorted(jd) == sorted(td)
    assert (jd["version"], jd["dtype"]) == (td["version"], td["dtype"]) == (2, tw.dtype)
    for f in ("k", "v", "k_scale", "v_scale"):
        if f in jd:
            _same_array(jd[f], td[f])
    reply = {"found": [1, 2, 3], "kv": td, "done": True}
    assert twire.reply_wire_nbytes(reply) == jwire.reply_wire_nbytes(
        {"found": [1, 2, 3], "kv": jd, "done": True}) == tw.nbytes == jw.nbytes


def _port_dense(w):
    k, v = w.to_dense(torch.float32)
    return k.numpy(), v.numpy()


def _jax_dense(w):
    k, v = w.to_dense(np.float32)
    return np.asarray(k, np.float32), np.asarray(v, np.float32)


@pytest.mark.parametrize("quantized,dense_tag", WIRE_CASES)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_chunk_packed_by_either_package_unpacks_in_the_other(quantized, dense_tag, direction):
    """Each package packs the chunk and its request plane's msgpack carries
    it; the other package's codec and unpack_kv read it back: the same
    tensors, and the same host dequantization."""
    jw, tw = _wires(quantized, dense_tag or "bfloat16")
    if direction == "jax_to_port":
        raw = msgpack.packb({"kv": jwire.pack_kv(jw), "found": [7]}, use_bin_type=True)
        got = twire.unpack_reply(msgpack_lite.unpackb(raw))
        want = tw
    else:
        raw = msgpack_lite.packb({"kv": twire.pack_kv(tw), "found": [7]})
        got = jwire.unpack_reply(msgpack.unpackb(raw, raw=False))
        want = jw
    assert got.dtype == want.dtype and len(got) == len(want) == 3
    dense = _port_dense if isinstance(got, twire.KvWireBlocks) else _jax_dense
    for a, b in zip(dense(got), _jax_dense(jw)):
        np.testing.assert_array_equal(a, b)
    if quantized:
        ks = got.k_scale.numpy() if isinstance(got, twire.KvWireBlocks) else got.k_scale
        np.testing.assert_array_equal(ks, jw.k_scale)


def test_a_v1_reply_unpacks_in_the_other_package():
    jw, tw = _wires(False, "float32")
    j_reply = {"found": [1], "k": jwire.pack_array(jw.k), "v": jwire.pack_array(jw.v)}
    got = twire.unpack_reply(msgpack_lite.unpackb(msgpack.packb(j_reply, use_bin_type=True)))
    assert got.dtype == "float32" and not got.quantized
    np.testing.assert_array_equal(got.k.numpy(), jw.k)
    assert twire.reply_wire_nbytes(j_reply) == jwire.reply_wire_nbytes(j_reply)
    assert twire.unpack_reply({"found": [], "kv": None, "k": None, "v": None}) is None


@pytest.mark.parametrize("preset", sorted(tconfig.all_presets()))
@pytest.mark.parametrize("tag", ["int8", "bfloat16", "float32", "float16"])
def test_wire_block_bytes_equal_jax(preset, tag):
    tc, jc = tconfig.all_presets()[preset], jconfig.all_presets()[preset]
    for bs in (16, 128):
        assert twire.wire_block_bytes(tc.n_layers, bs, tc.n_kv_heads, tc.head_dim_, tag) == \
            jwire.wire_block_bytes(jc.n_layers, bs, jc.n_kv_heads, jc.head_dim_, tag)


def test_qwen_block_bytes():
    """Qwen2.5-0.5B's block of 16: 196,608 B bf16, 104,448 B int8 (0.531)."""
    c = tconfig.qwen2_500m_config()
    bf = twire.wire_block_bytes(c.n_layers, 16, c.n_kv_heads, c.head_dim_, "bfloat16")
    q8 = twire.wire_block_bytes(c.n_layers, 16, c.n_kv_heads, c.head_dim_, "int8")
    assert (bf, q8) == (196_608, 104_448) and round(q8 / bf, 3) == 0.531


def test_pack_array_is_zero_copy_and_copies_only_when_strided():
    for tag in ("bfloat16", "float32", "int8"):
        _, t = _values((4, 16), tag)
        d = twire.pack_array(t)
        assert isinstance(d["b"], memoryview) and len(d["b"]) == t.numel() * t.element_size()
        back = twire.unpack_array(d)
        assert back.data_ptr() == t.data_ptr() and back.dtype == t.dtype
        assert torch.equal(back, t)
    t = torch.arange(64, dtype=torch.float32).reshape(4, 16)
    back = twire.unpack_array(twire.pack_array(t[:, ::2]))
    assert back.data_ptr() != t.data_ptr() and torch.equal(back, t[:, ::2])
    empty = twire.unpack_array(twire.pack_array(torch.zeros(0, 3, dtype=torch.bfloat16)))
    assert empty.shape == (0, 3) and empty.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown wire dtype"):
        twire.unpack_array({"b": b"", "shape": [0], "dtype": "complex64"})


@pytest.mark.parametrize("quantized,dense_tag", WIRE_CASES)
def test_to_dense_and_take_equal_jax(quantized, dense_tag):
    jw, tw = _wires(quantized, dense_tag or "bfloat16", n=5)
    for out in (None, "float32", "bfloat16"):
        for a, b in zip(tw.to_dense(out), jw.to_dense(out)):
            assert twire.dtype_tag(a.dtype) == str(np.asarray(b).dtype)
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    sel = [4, 1, 2]
    for a, b in zip(_port_dense(tw.take(sel)), _jax_dense(jw.take(sel))):
        np.testing.assert_array_equal(a, b)
    assert tw.take(range(5)) is tw and len(tw.take(sel)) == 3
    assert tw.take(sel).nbytes == jw.take(sel).nbytes


# -- the interop matrix at the ops level -------------------------------------


def _jax_pool(q, NB, BS, KH, D):
    if q:
        return {"q8": jnp.zeros((NB, BS, KH, D), jnp.int8), "s": jnp.zeros((NB, KH, BS), jnp.float32)}
    return jnp.zeros((NB, BS, KH, D), jnp.bfloat16)


def _port_pool(q, NB, BS, KH, D):
    cpu = torch.device("cpu")
    if q:
        return {"q8": tattn.sink_pool_tensor((NB, BS, KH, D), torch.int8, cpu),
                "s": tattn.sink_pool_tensor((NB, KH, BS), torch.float32, cpu)}
    return tattn.sink_pool_tensor((NB, BS, KH, D), torch.bfloat16, cpu)


def _pool_np(pool):
    def arr(t):
        return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)

    return {k: arr(v) for k, v in pool.items()} if isinstance(pool, dict) else {"v": arr(pool)}


# A dense payload requantized into an int8 pool: JAX's scatter quantizes
# inside a jitted program, where XLA divides by 127 and by the scale as
# multiplications by reciprocals, so a scale may sit one float32 ulp off
# the port's (which divides, as JAX's quantize_kv_chunk does run op by
# op) and a code on a rounding edge one step off (4 of 8,192 codes in the
# ops cell). Tolerance for those cells: scales within REQUANT_SCALE_RTOL,
# codes within REQUANT_CODE_STEPS on at most REQUANT_CODE_SHARE of them.
# Every other cell is held bit-equal.
REQUANT_SCALE_RTOL = 2.0**-22
REQUANT_CODE_STEPS = 1
REQUANT_CODE_SHARE = 0.01


def _assert_like_jax(mine, theirs, requant):
    assert sorted(mine) == sorted(theirs)
    for key in mine:
        a, b = mine[key], theirs[key]
        if requant and key == "q8":
            off = np.abs(a - b)
            assert off.max() <= REQUANT_CODE_STEPS and (off > 0).mean() <= REQUANT_CODE_SHARE
        elif requant and key == "s":
            np.testing.assert_allclose(a, b, rtol=REQUANT_SCALE_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("src_q", [False, True], ids=["src-bf16", "src-int8"])
@pytest.mark.parametrize("dst_q", [False, True], ids=["dst-bf16", "dst-int8"])
def test_interop_matrix_pools_equal_jax_and_attention_parity(src_q, dst_q):
    """Each cell: a source pool filled through the cache write, gathered in
    wire form, packed, unpacked and scattered into a destination pool of
    each form. The destination pools equal JAX's for the same cell
    (bit-equal but for REQUANT_*), and attention over them is within 0.06
    of attention over the never-exported source (JAX's limit, tests/test_kv_wire.py)."""
    from dynamo_tpu.engines.tpu import runner as jrunner
    from dynamo_tpu.ops.attention import write_chunk_to_cache as jwrite

    B, KH, G, D, BS, P = 2, 2, 2, 64, 8, 3
    H, NB = KH * G, B * P + 2
    rng = np.random.default_rng(11)
    hist32 = rng.standard_normal((B, BS * P, KH, D)).astype(np.float32)
    tables = rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32)
    q32 = rng.standard_normal((B, 4, H, D)).astype(np.float32)
    start, lens = np.array([5, 17], np.int32), np.array([4, 3], np.int32)
    full = np.full((B,), BS * P, np.int32)

    # JAX's cell
    jhist = jnp.asarray(hist32).astype(jnp.bfloat16)

    def jfill(f):
        return jwrite(_jax_pool(src_q, NB, BS, KH, D), jhist * f, jnp.asarray(tables),
                      jnp.zeros((B,), jnp.int32), jnp.asarray(full))

    jsk, jsv = jfill(1.0), jfill(0.5)
    idx = jnp.arange(NB, dtype=jnp.int32)
    if src_q:
        kq, ks = jrunner._gather_blocks_q8((jsk,), idx)
        vq, vs = jrunner._gather_blocks_q8((jsv,), idx)
        jw = jwire.KvWireBlocks(dtype="int8", k=np.asarray(kq.swapaxes(0, 1)),
                                v=np.asarray(vq.swapaxes(0, 1)),
                                k_scale=np.asarray(ks.swapaxes(0, 1)),
                                v_scale=np.asarray(vs.swapaxes(0, 1)))
    else:
        jw = jwire.KvWireBlocks.dense(
            np.asarray(jrunner._gather_blocks((jsk,), idx).swapaxes(0, 1)),
            np.asarray(jrunner._gather_blocks((jsv,), idx).swapaxes(0, 1)))
    jdk, jdv = (_jax_pool(dst_q, NB, BS, KH, D),), (_jax_pool(dst_q, NB, BS, KH, D),)
    if jw.quantized:
        jdk = jrunner._scatter_blocks_q8(jdk, idx, jnp.asarray(jw.k).swapaxes(0, 1),
                                         jnp.asarray(jw.k_scale).swapaxes(0, 1))
        jdv = jrunner._scatter_blocks_q8(jdv, idx, jnp.asarray(jw.v).swapaxes(0, 1),
                                         jnp.asarray(jw.v_scale).swapaxes(0, 1))
    else:
        jdk = jrunner._scatter_blocks(jdk, idx, jnp.asarray(jw.k).swapaxes(0, 1))
        jdv = jrunner._scatter_blocks(jdv, idx, jnp.asarray(jw.v).swapaxes(0, 1))
    jax.block_until_ready((jdk, jdv))

    # the port's cell on the same values
    thist = torch.from_numpy(hist32).to(torch.bfloat16)
    tt = torch.from_numpy(tables)

    def tfill(f):
        return tattn.write_chunk_to_cache(_port_pool(src_q, NB, BS, KH, D), thist * f, tt,
                                          torch.zeros(B, dtype=torch.int32),
                                          torch.from_numpy(full))

    tsk, tsv = tfill(1.0), tfill(0.5)
    tidx = torch.arange(NB)
    if src_q:
        kq, ks = trunner._gather_blocks_q8([tsk], tidx)
        vq, vs = trunner._gather_blocks_q8([tsv], tidx)
        tw = twire.KvWireBlocks(dtype="int8", k=kq, v=vq, k_scale=ks, v_scale=vs)
    else:
        tw = twire.KvWireBlocks.dense(trunner._gather_blocks([tsk], tidx),
                                      trunner._gather_blocks([tsv], tidx))
    tw = twire.unpack_kv(twire.pack_kv(tw))  # the serialization round trip
    assert tw.quantized == src_q
    tdk, tdv = [_port_pool(dst_q, NB, BS, KH, D)], [_port_pool(dst_q, NB, BS, KH, D)]
    if tw.quantized:
        trunner._scatter_blocks_q8(tdk, tidx, tw.k, tw.k_scale)
        trunner._scatter_blocks_q8(tdv, tidx, tw.v, tw.v_scale)
    else:
        trunner._scatter_blocks(tdk, tidx, tw.k.to(torch.bfloat16))
        trunner._scatter_blocks(tdv, tidx, tw.v.to(torch.bfloat16))

    for mine, theirs in ((tdk[0], jdk[0]), (tdv[0], jdv[0])):
        _assert_like_jax(_pool_np(mine), _pool_np(theirs), requant=dst_q and not src_q)

    q = torch.from_numpy(q32).to(torch.bfloat16)
    args = (tt, torch.from_numpy(start), torch.from_numpy(lens))
    oracle = tattn.paged_attention_ref(q, tsk, tsv, *args).float()
    out = tattn.paged_attention_ref(q, tdk[0], tdv[0], *args).float()
    err = float((out - oracle).abs().max())
    assert err < 0.06, (src_q, dst_q, err)
    if src_q and dst_q:  # int8 -> int8 is bit-exact
        assert torch.equal(tdk[0]["q8"], tsk["q8"]) and torch.equal(tdk[0]["s"], tsk["s"])
    if not src_q and not dst_q:
        assert torch.equal(tdk[0], tsk) and torch.equal(tdv[0], tsv)


# -- engines -----------------------------------------------------------------

ARGS = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
            prefill_chunk=32, decode_steps=4)


def _cfgs(**over):
    # head_dim 64 (2 heads x 64 = d_model 128): f32 scales are 4/64 of the
    # int8 payload, so the int8 wire is (1 + 4/64) / 2 of the bf16 one
    return (jconfig.tiny_config(n_heads=2, n_kv_heads=2, **over),
            tconfig.tiny_config(n_heads=2, n_kv_heads=2, **over))


@pytest.fixture(scope="module")
def weights():
    jc, tc = _cfgs()
    params = jllama.init_params(jc, jax.random.PRNGKey(7))
    return jc, tc, params, jax.tree.map(np.asarray, params)


def _port_engine(weights, kv=None):
    _, tc, _, tree = weights
    return TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                       kv_cache_dtype=kv, **ARGS),
                       params=params_from_jax(tree, tc, "cpu"))


def _jax_engine(weights, kv=None):
    jc, _, params, _ = weights
    return JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=1, kv_cache_dtype=kv, **ARGS),
                     params=params)


def _req(proto, prompt, max_tokens):
    return proto.PreprocessedRequest(token_ids=list(prompt),
                                     sampling=proto.SamplingOptions(temperature=0.0),
                                     stop=proto.StopConditions(max_tokens=max_tokens))


async def _stream(engine, prompt, max_tokens=6):
    if isinstance(engine, JaxEngine):
        out = await jcollect(engine.generate(_req(jproto, prompt, max_tokens), JContext()))
    else:
        out = await tcollect(engine.generate(_req(tproto, prompt, max_tokens), TContext()))
    return [t for o in out for t in o.token_ids]


def _to_jax(tw):
    return jwire.unpack_kv(msgpack.unpackb(msgpack_lite.packb(twire.pack_kv(tw)), raw=False))


CELLS = [pytest.param(None, None, id="bf16-bf16"), pytest.param("int8", "int8", id="int8-int8"),
         pytest.param(None, "int8", id="dense-int8"), pytest.param("int8", None, id="int8-dense")]


@pytest.mark.parametrize("src_kv,dst_kv", CELLS)
async def test_engine_export_import_cells(weights, src_kv, dst_kv):
    """The exporter serves a prompt, exports its blocks in wire form, and a
    port importer and a JAX importer install the same wire. Same-dtype
    cells: the importer's pool blocks bit-equal to the exporter's and the
    continuation the exporter's. Cross cells: the port importer's blocks
    equal JAX's importer's (tolerance 0: both requantize or dequantize
    the same way) and the continuation JAX's importer's. Every importer
    prefilled only the prompt's last token."""
    src, dst, jdst = _port_engine(weights, src_kv), _port_engine(weights, dst_kv), \
        _jax_engine(weights, dst_kv)
    try:
        prompt = list(range(40, 56))  # 4 full blocks of 4
        want = await _stream(src, prompt)
        hashes = compute_block_hashes(prompt, 4)
        assert hashes == jhashes(prompt, 4)
        found, wire = await src.export_blocks_wire_async(hashes)
        assert found == hashes and wire.dtype == ("int8" if src_kv else "float32")
        assert wire.k.shape == (4, 2, 4, 2, 64)

        assert await dst.import_blocks_wire_async(found, wire) == 4
        assert await jdst.import_blocks_wire_async(found, _to_jax(wire)) == 4
        assert dst.pool.match_prefix(hashes) == 4 and dst.pool.cached_blocks == 4
        assert dst.pool.active_blocks == 0  # imported blocks are cached, unreferenced
        back = dst.runner.gather_blocks_wire(dst.pool.pin_prefix(hashes)[1])
        jback_found, jback = await jdst.export_blocks_wire_async(hashes)
        assert jback_found == hashes and jback.dtype == back.dtype
        requant = dst_kv == "int8" and src_kv is None
        for name in ("k", "v"):
            mine = {"q8": getattr(back, name).float().numpy()}
            theirs = {"q8": np.asarray(getattr(jback, name), np.float32)}
            if back.quantized:
                mine["s"] = getattr(back, name + "_scale").numpy()
                theirs["s"] = np.asarray(getattr(jback, name + "_scale"))
            _assert_like_jax(mine, theirs, requant)
        if src_kv == dst_kv:
            for mine, theirs in ((back.k, wire.k), (back.v, wire.v),
                                 (back.k_scale, wire.k_scale), (back.v_scale, wire.v_scale)):
                assert (mine is None and theirs is None) or torch.equal(mine, theirs)

        p0, j0 = dst.prefill_tokens, jdst.prefill_tokens
        got, jgot = await _stream(dst, prompt), await _stream(jdst, prompt)
        assert dst.prefill_tokens - p0 == 1 == jdst.prefill_tokens - j0
        assert got == jgot
        if src_kv == dst_kv:
            assert got == want
    finally:
        for e in (src, dst, jdst):
            await e.stop()


async def test_dense_export_and_import(weights):
    """The v1 surface: export_blocks_async gives dense tensors (an int8
    pool's dequantized to bfloat16 on the host, as JAX's), and
    import_blocks_async installs them."""
    src8, dst = _port_engine(weights, "int8"), _port_engine(weights)
    jsrc8 = _jax_engine(weights, "int8")
    try:
        prompt = list(range(60, 76))
        await _stream(src8, prompt, 2)
        await _stream(jsrc8, prompt, 2)
        hashes = compute_block_hashes(prompt, 4)
        found, k, v = await src8.export_blocks_async(hashes)
        jfound, jk, jv = await jsrc8.export_blocks_async(hashes)
        assert found == jfound == hashes and k.dtype == torch.bfloat16
        assert str(jk.dtype) == "bfloat16" and k.shape == jk.shape
        assert float((k.float() - torch.from_numpy(np.asarray(jk, np.float32))).abs().max()) \
            < 0.05  # two engines' prefill: near, not bit-equal
        assert await dst.import_blocks_async(found, k, v) == 4
        assert await dst.import_blocks_async(found, k, v) == 0  # resident: skipped
        assert (await src8.export_blocks_async([12345]))[1:] == (None, None)
    finally:
        for e in (src8, dst, jsrc8):
            await e.stop()


@pytest.mark.parametrize("kv", [None, "int8"])
async def test_dense_gather_is_the_wire_gather_densified(weights, kv):
    """The runner's dense gather (int8 pools dequantized to bfloat16 where
    they lie, as JAX's ``_gather_blocks``) equals the pool-native gather
    dequantized on the host, bit for bit."""
    engine = _port_engine(weights, kv)
    try:
        prompt = list(range(140, 156))
        await _stream(engine, prompt, 2)
        _, ids = engine.pool.pin_prefix(compute_block_hashes(prompt, 4))
        k, v = engine.runner.gather_blocks(ids)
        wk, wv = engine.runner.gather_blocks_wire(ids).to_dense(
            "bfloat16" if kv else None)
        assert torch.equal(k, wk) and torch.equal(v, wv)
        assert k.dtype == (torch.bfloat16 if kv else torch.float32) and k.shape[:2] == (4, 2)
    finally:
        await engine.stop()


async def test_int8_wire_bytes_at_most_055x_of_bf16():
    tc = tconfig.tiny_config(n_heads=2, n_kv_heads=2, dtype=torch.bfloat16)
    e8 = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                     kv_cache_dtype="int8", seed=7, **ARGS))
    eb = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, seed=7, **ARGS))
    try:
        prompt = list(range(40, 56))
        for e in (e8, eb):
            await _stream(e, prompt, 2)
        hashes = compute_block_hashes(prompt, 4)
        (f8, w8), (fb, wb) = (await e8.export_blocks_wire_async(hashes),
                              await eb.export_blocks_wire_async(hashes))
        assert f8 == fb == hashes
        assert (w8.dtype, w8.k.dtype, wb.dtype) == ("int8", torch.int8, "bfloat16")
        assert w8.nbytes / wb.nbytes <= 0.55
        ser8 = twire.reply_wire_nbytes({"kv": twire.pack_kv(w8)})
        serb = twire.reply_wire_nbytes({"kv": twire.pack_kv(wb)})
        assert (ser8, serb) == (w8.nbytes, wb.nbytes)
        assert w8.nbytes == 4 * twire.wire_block_bytes(tc.n_layers, 4, tc.n_kv_heads,
                                                       tc.head_dim_, "int8")
    finally:
        await e8.stop()
        await eb.stop()


@pytest.mark.parametrize("src_kv,dst_kv", CELLS)
async def test_scatter_writes_into_the_existing_pools(weights, src_kv, dst_kv):
    """An import keeps every pool tensor, its storage and its sink: the
    tensors the runner was built with (which the captured decode graphs
    hold on the card) take the blocks in place, and the cache write (which
    refuses a pool without ``.sink_full``) still runs over them."""
    src, dst = _port_engine(weights, src_kv), _port_engine(weights, dst_kv)
    try:
        def tensors(runner):
            out = []
            for pool in runner.k_cache + runner.v_cache:
                out += list(pool.values()) if isinstance(pool, dict) else [pool]
            return out

        before = [(t, t.data_ptr(), t.sink_full, t.sink_full.data_ptr())
                  for t in tensors(dst.runner)]
        k_list, v_list = dst.runner.k_cache, dst.runner.v_cache
        prompt = list(range(80, 96))
        want = await _stream(src, prompt)
        found, wire = await src.export_blocks_wire_async(compute_block_hashes(prompt, 4))
        assert await dst.import_blocks_wire_async(found, wire) == 4
        assert dst.runner.k_cache is k_list and dst.runner.v_cache is v_list
        after = tensors(dst.runner)
        assert len(after) == len(before)
        for (t, ptr, full, full_ptr), now in zip(before, after):
            assert now is t and now.data_ptr() == ptr
            assert now.sink_full is full and full.data_ptr() == full_ptr
        ids = dst.pool.pin_prefix(found)[1]
        assert len(dst.runner.gather_blocks_wire(ids)) == 4
        got = await _stream(dst, prompt)  # the cache write over the same pools
        if src_kv == dst_kv:
            assert got == want
    finally:
        await src.stop()
        await dst.stop()


async def test_an_import_emits_the_kv_events_jaxs_does(weights):
    """An import commits its blocks through the pool, whose ``stored``
    events (each block with its parent, the anchor's child first) reach
    ``on_kv_event``, so the KV router indexes the decode worker as holding
    them: the same events as a JaxEngine importing the same wire."""
    src = _port_engine(weights)
    _, tc, _, tree = weights
    jc, _, params, _ = weights
    seen = {"port": [], "jax": []}
    dst = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, **ARGS),
                      params=params_from_jax(tree, tc, "cpu"),
                      on_kv_event=lambda e: seen["port"].append(e))
    jdst = JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=1, **ARGS), params=params,
                     on_kv_event=lambda e: seen["jax"].append(e))
    try:
        prompt = list(range(160, 180))
        await _stream(src, prompt, 2)
        hashes = compute_block_hashes(prompt, 4)
        found, wire = await src.export_blocks_wire_async(hashes)
        for engine, w in ((dst, wire), (jdst, _to_jax(wire))):
            assert await engine.import_blocks_wire_async(found[2:], w.take([2, 3, 4]),
                                                         anchor_parent=found[1]) == 3
        events = {k: [(e.kind, list(e.block_hashes), e.parent_hash) for e in v]
                  for k, v in seen.items()}
        assert events["port"] == events["jax"] == [
            ("stored", [h], p) for h, p in zip(found[2:], found[1:4])]
    finally:
        for e in (src, dst, jdst):
            await e.stop()


async def test_a_failed_scatter_frees_its_blocks(weights, monkeypatch):
    src, dst = _port_engine(weights), _port_engine(weights)
    try:
        prompt = list(range(100, 116))
        await _stream(src, prompt, 2)
        found, wire = await src.export_blocks_wire_async(compute_block_hashes(prompt, 4))
        free = dst.pool.free_blocks

        def boom(ids, w):
            raise RuntimeError("scatter failed")

        monkeypatch.setattr(dst.runner, "scatter_blocks_wire", boom)
        with pytest.raises(RuntimeError, match="scatter failed"):
            await dst.import_blocks_wire_async(found, wire)
        assert dst.pool.free_blocks == free and dst.pool.match_prefix(found) == 0
    finally:
        await src.stop()
        await dst.stop()


async def test_an_export_stops_at_the_first_miss_and_pins_across_the_gather(weights):
    engine = _port_engine(weights)
    try:
        prompt = list(range(120, 136))
        await _stream(engine, prompt, 2)
        hashes = compute_block_hashes(prompt, 4)
        seen = []
        real = engine.runner.gather_blocks_wire_dispatch

        def spy(ids):
            seen.append(engine.pool.active_blocks)  # pinned while gathering
            return real(ids)

        engine.runner.gather_blocks_wire_dispatch = spy
        found, wire = await engine.export_blocks_wire_async(hashes[:2] + [999] + hashes[3:])
        assert found == hashes[:2] and len(wire) == 2 and seen == [2]
        assert engine.pool.active_blocks == 0
        assert await engine.export_blocks_wire_async([999] + hashes) == ([], None)
    finally:
        await engine.stop()
